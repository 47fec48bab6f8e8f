"""Synthetic classification data (the Exp-2 stand-in for MNIST).

A copy of the classification half of the JAX package's
``repro.data.synthetic``: same numpy draws, same arrays.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


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
