"""Synthetic data pipelines: a copy of the JAX package's
``repro.data.synthetic`` (same numpy draws, same arrays).

* ``TokenPipeline`` — deterministic language-model token streams.  Each
  *agent* gets a distinct, non-IID partition (its own Zipf temperature and a
  vocabulary shift), matching the federated setting of the paper where every
  agent holds a private objective f_i.
* ``make_classification`` — the Exp-2 stand-in for MNIST.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    batch_per_agent: int
    n_agents: int
    seed: int = 0
    zipf_base: float = 1.1

    def __post_init__(self):
        self._step = 0

    def _agent_probs(self, agent: int) -> np.ndarray:
        # non-IID: per-agent Zipf exponent + cyclic vocab shift
        a = self.zipf_base + 0.15 * agent / max(self.n_agents - 1, 1)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = ranks ** (-a)
        p /= p.sum()
        return np.roll(p, (agent * self.vocab) // max(self.n_agents, 1))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self._step]))
        self._step += 1
        toks = np.empty((self.n_agents, self.batch_per_agent,
                         self.seq_len + 1), np.int32)
        for a in range(self.n_agents):
            toks[a] = rng.choice(self.vocab, p=self._agent_probs(a),
                                 size=(self.batch_per_agent, self.seq_len + 1))
        return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def augment_modalities(stream: Iterator[Dict[str, np.ndarray]], cfg,
                       seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Wrap a token stream with the stubbed modality frontends: precomputed
    frame embeddings (audio) or patch embeddings + positions (vlm)."""
    step = 0
    for batch in stream:
        A, B, S = batch["tokens"].shape
        rng = np.random.default_rng(np.random.SeedSequence([seed + 1, step]))
        step += 1
        if cfg.family == "audio":
            batch["frames"] = rng.normal(
                size=(A, B, cfg.n_frames, cfg.d_model)).astype(np.float32)
        elif cfg.family == "vlm":
            n = min(cfg.n_img_tokens, S)
            batch["img_embeds"] = rng.normal(
                size=(A, B, n, cfg.d_model)).astype(np.float32)
            batch["img_pos"] = np.tile(np.arange(n, dtype=np.int32),
                                       (A, B, 1))
        yield batch


def make_classification(n_per_class: int, n_agents: int, seed: int = 0,
                        dim: int = 784, n_classes: int = 10,
                        noise: float = 0.9):
    """MNIST-like: fixed prototypes (one per class) + Gaussian noise, split
    into balanced per-agent shards.  Returns (X (A,N,dim), y (A,N))."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_classes, dim)).astype(np.float32)
    N = n_per_class * n_classes
    X = np.empty((n_agents, N, dim), np.float32)
    y = np.empty((n_agents, N), np.int32)
    for a in range(n_agents):
        xs, ys = [], []
        for c in range(n_classes):
            pts = protos[c] + noise * rng.normal(
                size=(n_per_class, dim)).astype(np.float32)
            xs.append(pts)
            ys.append(np.full(n_per_class, c, np.int32))
        perm = rng.permutation(N)
        X[a] = np.concatenate(xs)[perm]
        y[a] = np.concatenate(ys)[perm]
    return X, y


def minibatches(X: np.ndarray, y: np.ndarray, batch: int, seed: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite minibatch stream over per-agent shards (A, N, ...)."""
    A, N = y.shape
    step = 0
    while True:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        idx = rng.integers(0, N, size=(A, batch))
        yield {"x": np.take_along_axis(X, idx[..., None], 1),
               "y": np.take_along_axis(y, idx, 1)}
        step += 1
