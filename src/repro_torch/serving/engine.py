"""Serving engine: a front-end over the batching scheduler, the port of the
JAX package's ``repro.serving.engine``.

``make_serve_step`` (one token, whole batch) and ``make_prefill`` (a
full-sequence forward to the last token's logits) are the units of a
decode and a prefill shape; ``Engine`` is the runnable host-side API.
``Engine`` owns a persistent :class:`~repro_torch.serving.scheduler.Scheduler`
and ``generate()`` is a blocking wrapper over its ``submit``/``poll``
lifecycle.

Under ``use_rules(serve_rules(...), mesh)`` with a "model" axis wider
than 1, the two units run tensor-parallel (every family) on each rank's
local shards (parameters under ``param_specs``, the cache under
``cache_specs``, the batch's rows under ``batch_specs_serve``); under
``serve_rules(..., weights_fsdp=True)`` each layer's fsdp leaves are split
over the data axes too, and prefill and decode gather them at use
(``transformer.layer_gather``):
``make_prefill`` returns this rank's vocab columns of the last logits,
``make_serve_step`` the greedy tokens over every rank's columns.
``Engine`` and its scheduler are one-process, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as D
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig


def make_serve_step(cfg: ModelConfig, window_override: Optional[int] = None):
    """serve_step(params, cache, tokens (B,1), pos) -> (next_tokens (B,1),
    cache)."""

    def serve_step(params, cache, tokens, pos):
        logits, cache = D.decode_step(params, cache, tokens, pos, cfg,
                                      window_override)
        next_tok = L.vocab_argmax(logits[:, -1], cfg.vocab)
        return next_tok[:, None], cache

    return serve_step


def make_prefill(cfg: ModelConfig):
    """Full-sequence prefill producing last-token logits.  The serving path
    instead uses ``models.decode.prefill_cache``, which also writes the
    cache."""

    def prefill(params, batch):
        logits, _ = T.forward(params, batch, cfg, remat=False)
        return logits[:, -1]

    return prefill


@dataclasses.dataclass
class Engine:
    """Batched greedy generation over the continuous-batching scheduler.

    ``generate(prompts, n_new)`` submits one request per row and drives the
    scheduler until all of them finish; because each slot's decode row is
    independent, the result is bit-equal to running the scheduler request
    by request.  For streaming/interleaved workloads use :attr:`scheduler`
    directly (``submit``/``step``/``poll``).

    Per-``generate`` timing counters land in ``last_stats`` (prefill /
    decode wall, tokens/s) and, when a ``sink`` is attached, are written as
    one ``serve.generate`` record per call; the scheduler shares the sink,
    so its per-round ``serve.step`` and per-completion ``serve.request``
    records interleave in the same stream.
    """
    cfg: ModelConfig
    params: Any
    max_len: int = 256
    window_override: Optional[int] = None
    sink: Optional[obs.MetricsSink] = None
    max_slots: int = 8
    prefill_chunk: int = 16
    token_budget: int = 64

    def __post_init__(self):
        self.scheduler = Scheduler(
            self.cfg, self.params,
            SchedulerConfig(max_slots=self.max_slots, max_len=self.max_len,
                            prefill_chunk=self.prefill_chunk,
                            token_budget=self.token_budget,
                            window_override=self.window_override),
            sink=self.sink)
        self.last_stats: Dict[str, float] = {}
        self._n_calls = 0

    def generate(self, prompts: np.ndarray, n_new: int,
                 frames: Optional[np.ndarray] = None) -> np.ndarray:
        """prompts: (B, P) int32 (unpadded); frames: an audio model's (B,
        n_frames, d_model) frame embeddings.  Returns (B, n_new) greedy
        continuations.  Blocks until the whole batch is done."""
        B, P = prompts.shape
        sch = self.scheduler
        p0, d0 = sch.prefill_s, sch.decode_s
        t0 = time.perf_counter()
        rids = [sch.submit(prompts[b], n_new,
                           frames=None if frames is None else frames[b])
                for b in range(B)]
        pending = set(rids)
        while pending:
            sch.step()
            pending = {r for r in pending if sch.poll(r) is None}
        out = np.stack([sch.poll(r) for r in rids], axis=0)
        wall_s = time.perf_counter() - t0
        prefill_s = sch.prefill_s - p0
        # attribute non-decode scheduler overhead to the prefill bucket so
        # the two buckets partition the call's wall time
        decode_s = max(wall_s - prefill_s, sch.decode_s - d0)
        self.last_stats = {
            "batch": B, "prompt_len": P, "new_tokens": n_new,
            "prefill_ms": round(prefill_s * 1e3, 3),
            "decode_ms": round(decode_s * 1e3, 3),
            "decode_ms_per_token": round(decode_s * 1e3 / max(n_new, 1), 3),
            "decode_tokens_per_s": round(B * n_new / max(decode_s, 1e-9), 1),
        }
        if self.sink is not None:
            self.sink.write({"name": "serve.generate", "step": self._n_calls,
                             **self.last_stats})
        self._n_calls += 1
        return out
