"""Continuous-batching serving scheduler: the port of the JAX package's
``repro.serving.scheduler``.

The unit of work is one :meth:`Scheduler.step`: a host-side scheduling
round that (1) admits queued requests into free KV-cache slots under a
token budget, (2) advances **chunked prefill** for admitted requests, and
(3) runs **one batched decode** over every running sequence, each at its
own position, via ``models.decode.decode_step_ragged``.  A request can
therefore join mid-flight: admission never waits for the running batch to
drain.

Request lifecycle::

    QUEUED --admit (free slot + budget)--> PREFILL
    PREFILL --prompt fully consumed------> DECODE   (first token == TTFT)
    DECODE --max_new tokens--------------> DONE     (slot evicted)

Scheduling policy (deterministic, FIFO):

* every step has ``token_budget`` tokens to spend; running decodes are
  reserved first (one token each: latency of in-flight requests beats new
  admissions), the remainder goes to prefill chunks of at most
  ``prefill_chunk`` tokens, oldest request first;
* a queued request is admitted when a slot is free **and** budget remains
  for at least one of its prefill tokens this step.

Decode runs over the *whole* arena, ``max_slots`` rows whatever the
occupancy, and only the active rows of its new cache are written back
(free and mid-prefill slots keep their bytes, the SSM state included).
The products' shapes, and so the kernels the libraries pick and their
rounding, never depend on occupancy, and each row reads only its own cache
row: a request's tokens are bit-equal whether it ran alone or packed.

Telemetry (through any ``obs.MetricsSink``): one ``serve.step`` record per
scheduling round and one ``serve.request`` record per completion, with the
JAX package's key sets.  The ``phase_*_ms`` columns tile ``step_time_ms``;
each phase ends in ``obs.device_sync()``, so on the card they time the
device's work, not its launch.  With an ``obs.SpanRecorder`` installed the
same phases are recorded as nested host spans (``serve.step/serve.decode``
...).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch import tree as TR
from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as D
from repro_torch.serving.kvpool import KVSlotPool

# lifecycle states
QUEUED, PREFILL, DECODE, DONE = "QUEUED", "PREFILL", "DECODE", "DONE"

#: pinned key set of the per-round telemetry record.  The ``phase_*_ms``
#: columns tile the round: admission (incl. batch-list builds) -> prefill
#: -> decode, plus the *previous* round's record-build/sink-flush wall as
#: ``phase_telemetry_ms``, so ``step_time_ms == sum(phase_*_ms)`` up to
#: rounding.
STEP_RECORD_KEYS = ("name", "step", "queue_depth", "occupancy", "free_slots",
                    "n_prefill", "n_decode", "prefill_tokens",
                    "decode_tokens", "admitted", "completed", "step_time_ms",
                    "phase_admission_ms", "phase_prefill_ms",
                    "phase_decode_ms", "phase_telemetry_ms")

#: pinned key set of the per-completion telemetry record
REQUEST_RECORD_KEYS = ("name", "step", "prompt_len", "new_tokens",
                       "queue_steps", "ttft_steps", "ttft_ms", "e2e_ms",
                       "decode_tokens_per_s", "token_sum", "token_last")


@dataclasses.dataclass
class Request:
    """One generation request and its scheduling bookkeeping."""
    rid: int
    prompt: np.ndarray                    # (P,) int32
    max_new: int
    frames: Optional[np.ndarray] = None   # audio: (n_frames, d_model)
    state: str = QUEUED
    slot: int = -1
    n_prefilled: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    last_token: int = -1
    submit_step: int = -1
    admit_step: int = -1
    first_token_step: int = -1
    done_step: int = -1
    submit_t: float = 0.0
    first_token_t: float = 0.0
    done_t: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def output(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Knobs of the admission/batching policy."""
    max_slots: int = 4
    max_len: int = 256
    prefill_chunk: int = 16
    token_budget: int = 64
    window_override: Optional[int] = None

    def __post_init__(self):
        if self.max_slots <= 0:
            raise ValueError("max_slots must be positive")
        if self.prefill_chunk <= 0:
            raise ValueError("prefill_chunk must be positive")
        if self.token_budget <= 0:
            raise ValueError("token_budget must be positive")


def masked_decode(params, pool: KVSlotPool, tokens: torch.Tensor,
                  pos: torch.Tensor, active: torch.Tensor, cfg: ModelConfig,
                  window_override: Optional[int]) -> torch.Tensor:
    """Batched decode over the whole arena; only the ``active`` slots (an
    index tensor) are written back, so free and mid-prefill slots keep
    their bytes: their rows still compute, but neither the garbage KV write
    nor, for SSM, the recurrent-state update lands.  Returns the greedy
    next token of every row, (max_slots,)."""
    logits, new_arena = D.decode_step_ragged(params, pool.arena, tokens, pos,
                                             cfg, window_override)
    pool.write_slots(active, new_arena)
    return torch.argmax(logits[:, -1], dim=-1)


def prefill_chunk(params, slot_cache, tokens: torch.Tensor, pos0: int,
                  cfg: ModelConfig, window_override: Optional[int]):
    """Chunked prefill on one slot's batch-1 cache; returns the argmax of
    the last chunk token's logits (the request's first generated token when
    the chunk closes the prompt) and the new slot cache."""
    last, slot_cache = D.prefill_cache(params, slot_cache, tokens, pos0, cfg,
                                       window_override)
    return torch.argmax(last, dim=-1), slot_cache


class Scheduler:
    """Continuous-batching scheduler over a :class:`KVSlotPool`.

    Host-side driver: ``submit`` enqueues, ``step`` runs one scheduling
    round, ``poll``/``result`` retrieve finished token sequences.  All
    ordering (admission, prefill, decode commit) is FIFO by request id, so
    a fixed submission trace yields a byte-stable telemetry stream.  The
    arena lives on the parameters' device.
    """

    def __init__(self, cfg: ModelConfig, params: Any,
                 sched: Optional[SchedulerConfig] = None,
                 sink: Optional[obs.MetricsSink] = None):
        self.cfg = cfg
        self.params = params
        self.sched = sched or SchedulerConfig()
        self.sink = sink
        self.device = TR.leaves(params)[0].device
        self.pool = KVSlotPool.create(cfg, self.sched.max_slots,
                                      self.sched.max_len,
                                      self.sched.window_override,
                                      device=self.device)
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}
        self.done: Dict[int, Request] = {}
        self.step_idx = 0
        self._next_rid = 0
        # cumulative wall split, for Engine.last_stats
        self.prefill_s = 0.0
        self.decode_s = 0.0
        # previous round's record-build + sink-flush wall (ms); reported
        # as this round's phase_telemetry_ms so phases tile step_time_ms
        self._flush_ms = 0.0

    # ----------------------------------------------------------- lifecycle

    def submit(self, prompt: np.ndarray, max_new: int,
               frames: Optional[np.ndarray] = None) -> int:
        """Enqueue one request; returns its id.  ``prompt``: (P,) int32;
        ``frames``: an audio model's (n_frames, d_model) frame embeddings,
        which it must have."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new <= 0:
            raise ValueError("max_new must be positive")
        if prompt.size + max_new > self.sched.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new ({max_new}) exceeds "
                f"max_len ({self.sched.max_len})")
        if (frames is None) == (self.cfg.family == "audio"):
            raise ValueError(
                f"{self.cfg.arch_id}: an audio model's request takes frames, "
                "any other model's none")
        req = Request(rid=self._next_rid, prompt=prompt, max_new=max_new,
                      frames=frames, submit_step=self.step_idx,
                      submit_t=time.perf_counter())
        self._next_rid += 1
        self.queue.append(req)
        return req.rid

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.active)

    def poll(self, rid: int) -> Optional[np.ndarray]:
        """Finished token sequence, or None while in flight."""
        req = self.done.get(rid)
        return req.output() if req is not None else None

    def result(self, rid: int, max_steps: int = 100_000) -> np.ndarray:
        """Drive the scheduler until ``rid`` completes, then return its
        tokens."""
        for _ in range(max_steps):
            out = self.poll(rid)
            if out is not None:
                return out
            if not self.has_work:
                raise KeyError(f"unknown request id {rid}")
            self.step()
        raise RuntimeError(f"request {rid} did not finish in {max_steps} "
                           "steps")

    def run(self, max_steps: int = 100_000) -> None:
        """Drain everything currently queued or running."""
        for _ in range(max_steps):
            if not self.has_work:
                return
            self.step()
        raise RuntimeError(f"work remains after {max_steps} steps")

    # ---------------------------------------------------------------- step

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.int64, device=self.device)

    def step(self) -> Dict[str, Any]:
        """One scheduling round; returns (and sinks) the serve.step record.

        The ``phase_*_ms`` columns tile the measured window end to end (see
        STEP_RECORD_KEYS): admission covers everything from round start to
        the first prefill launch (FIFO admission, slot zeroing, the audio
        encoder, batch-list builds), then prefill, then decode; each ends
        in a device sync.
        The record-build + sink-flush tail of round *t* is carried into
        round *t+1* as its ``phase_telemetry_ms`` and folded into that
        round's ``step_time_ms``, keeping phases summing to the total.
        """
        t_start = time.perf_counter()
        with obs.span("serve.step", step=self.step_idx):
            budget = self.sched.token_budget
            with obs.span("serve.admission"):
                decoding = sorted((r for r in self.active.values()
                                   if r.state == DECODE),
                                  key=lambda r: r.rid)
                budget -= len(decoding)    # running decodes are pre-booked

                # ---- admission: FIFO while a slot is free and budget left
                admitted = 0
                while self.queue and self.pool.n_free > 0 and budget > 0:
                    req = self.queue.popleft()
                    req.slot = self.pool.alloc()
                    req.state = PREFILL
                    req.admit_step = self.step_idx
                    self.active[req.rid] = req
                    admitted += 1
                    if req.frames is not None:
                        # the encoder writes the slot's cross K/V once
                        self.pool.write_slot(req.slot, D.encode_for_decode(
                            self.params, self.pool.read_slot(req.slot),
                            torch.as_tensor(req.frames,
                                            device=self.device)[None],
                            self.cfg))

                completed = 0
                prefill_tokens = 0
                prefilling = sorted((r for r in self.active.values()
                                     if r.state == PREFILL),
                                    key=lambda r: r.rid)
                obs.device_sync()
            t0 = time.perf_counter()

            # ---- chunked prefill, oldest request first
            with obs.span("serve.prefill"):
                for req in prefilling:
                    if budget <= 0:
                        break
                    chunk = min(self.sched.prefill_chunk,
                                req.prompt_len - req.n_prefilled, budget)
                    if chunk <= 0:
                        continue
                    toks = self._tensor(
                        req.prompt[req.n_prefilled:
                                   req.n_prefilled + chunk][None])
                    first_tok, slot_cache = prefill_chunk(
                        self.params, self.pool.read_slot(req.slot), toks,
                        req.n_prefilled, self.cfg,
                        self.sched.window_override)
                    self.pool.write_slot(req.slot, slot_cache)
                    req.n_prefilled += chunk
                    self.pool.positions[req.slot] += chunk
                    budget -= chunk
                    prefill_tokens += chunk
                    if req.n_prefilled == req.prompt_len:
                        tok = int(first_tok[0])
                        req.tokens.append(tok)
                        req.last_token = tok
                        req.first_token_step = self.step_idx
                        req.first_token_t = time.perf_counter()
                        req.state = DECODE
                        if len(req.tokens) >= req.max_new:
                            self._finish(req)
                            completed += 1
                obs.device_sync()
            t1 = time.perf_counter()
            self.prefill_s += t1 - t0

            # ---- one batched decode over every running sequence
            with obs.span("serve.decode"):
                if decoding:
                    n = self.pool.max_slots
                    tokens = np.zeros((n, 1), np.int64)
                    pos = np.zeros(n, np.int64)
                    for r in decoding:
                        tokens[r.slot, 0] = r.last_token
                        pos[r.slot] = self.pool.positions[r.slot]
                    active = [r.slot for r in decoding]
                    next_tok = masked_decode(
                        self.params, self.pool, self._tensor(tokens),
                        self._tensor(pos), self._tensor(np.asarray(active)),
                        self.cfg, self.sched.window_override).cpu().numpy()
                    for r in decoding:
                        tok = int(next_tok[r.slot])
                        r.tokens.append(tok)
                        r.last_token = tok
                        self.pool.positions[r.slot] += 1
                        if len(r.tokens) >= r.max_new:
                            self._finish(r)
                            completed += 1
                obs.device_sync()
            t_d = time.perf_counter()
            self.decode_s += t_d - t1

            with obs.span("serve.telemetry"):
                rec = {
                    "name": "serve.step", "step": self.step_idx,
                    "queue_depth": len(self.queue),
                    "occupancy": self.pool.n_used,
                    "free_slots": self.pool.n_free,
                    "n_prefill": sum(r.state == PREFILL
                                     for r in self.active.values()),
                    "n_decode": len(decoding),
                    "prefill_tokens": prefill_tokens,
                    "decode_tokens": len(decoding),
                    "admitted": admitted,
                    "completed": completed,
                    "step_time_ms": round(
                        (t_d - t_start) * 1e3 + self._flush_ms, 3),
                    "phase_admission_ms": round((t0 - t_start) * 1e3, 3),
                    "phase_prefill_ms": round((t1 - t0) * 1e3, 3),
                    "phase_decode_ms": round((t_d - t1) * 1e3, 3),
                    "phase_telemetry_ms": self._flush_ms,
                }
                if self.sink is not None:
                    self.sink.write(rec)
            self._flush_ms = round((time.perf_counter() - t_d) * 1e3, 3)
        self.step_idx += 1
        return rec

    # ------------------------------------------------------------ internal

    def _finish(self, req: Request) -> None:
        req.state = DONE
        req.done_step = self.step_idx
        req.done_t = time.perf_counter()
        self.pool.free(req.slot)
        self.active.pop(req.rid)
        self.done[req.rid] = req
        if self.sink is not None:
            decode_wall = max(req.done_t - req.first_token_t, 1e-9)
            tps = ((len(req.tokens) - 1) / decode_wall
                   if len(req.tokens) > 1 else 0.0)
            self.sink.write({
                "name": "serve.request", "step": req.rid,
                "prompt_len": req.prompt_len,
                "new_tokens": len(req.tokens),
                "queue_steps": req.admit_step - req.submit_step,
                "ttft_steps": req.first_token_step - req.submit_step + 1,
                "ttft_ms": round((req.first_token_t - req.submit_t) * 1e3,
                                 3),
                "e2e_ms": round((req.done_t - req.submit_t) * 1e3, 3),
                "decode_tokens_per_s": round(tps, 1),
                "token_sum": int(np.sum(req.tokens, dtype=np.int64)),
                "token_last": int(req.last_token),
            })
