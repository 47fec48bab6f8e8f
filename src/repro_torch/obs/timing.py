"""Step timing, throughput counters, and profiler trace annotation.

The port's counterpart of the JAX package's ``repro.obs.timing``.

``StepTimer`` is the host-side clock the trainer and the experiment
scripts share: call ``tick()`` once per completed step (AFTER waiting for
the step's outputs — PyTorch returns before the device finishes, so
without a sync the clock times the enqueue, not the work) and read
``step_time_ms`` / throughput.

``annotate`` and ``step_annotation`` wrap host-side regions in
``torch.profiler.record_function`` (plus an NVTX range once CUDA is
initialised) so they show up as named ranges in a captured trace.
``trace_scope`` is the same around the kernel path and the consensus
calls, but it sits on every parameter leaf of every step, so it does
nothing at all unless a ``torch.profiler`` capture is running.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


class _NullScope:
    """Shared do-nothing context: the disabled ``trace_scope``."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullScope()


@contextlib.contextmanager
def _range(name: str) -> Iterator[None]:
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def annotate(name: str, **kwargs):
    """Host-side trace range (visible in torch.profiler / Perfetto and NVTX
    captures).  ``kwargs`` are appended to the name, as ``k=v``."""
    if kwargs:
        name = name + "[" + ",".join(f"{k}={v}" for k, v in
                                     sorted(kwargs.items())) + "]"
    return _range(name)


def step_annotation(name: str, step: int):
    """One range per step (``name#step``), so a trace groups a whole step."""
    return _range(f"{name}#{step}")


def trace_scope(name: str):
    """Named range around a kernel launch or a consensus call.  Free when no
    ``torch.profiler`` capture is running: the check is one C call and the
    result a shared no-op context."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _range(name)


class StepTimer:
    """Wall-clock per step + exponential moving average + items/s.

    ``items_per_step`` is whatever unit throughput should be quoted in
    (tokens, samples, decoded tokens); pass 0 to skip throughput.
    """

    def __init__(self, items_per_step: float = 0.0, ema: float = 0.9) -> None:
        self.items_per_step = items_per_step
        self._ema_coef = ema
        self.reset()

    def reset(self) -> None:
        self._last: Optional[float] = None
        self._t0 = time.perf_counter()
        self.steps = 0
        self.step_time_ms = 0.0
        self.ema_step_time_ms = 0.0

    def tick(self) -> float:
        """Mark one completed step; returns this step's wall ms."""
        now = time.perf_counter()
        prev = self._last if self._last is not None else self._t0
        self._last = now
        self.step_time_ms = (now - prev) * 1e3
        self.ema_step_time_ms = (
            self.step_time_ms if self.steps == 0 else
            self._ema_coef * self.ema_step_time_ms
            + (1 - self._ema_coef) * self.step_time_ms)
        self.steps += 1
        return self.step_time_ms

    @property
    def wall_s(self) -> float:
        return (self._last or time.perf_counter()) - self._t0

    @property
    def items_per_s(self) -> float:
        """Throughput off the EMA step time — the quotable number.  The
        instantaneous value jitters with scheduler noise and GC pauses;
        see ``items_per_s_instant`` for the raw per-step figure."""
        if not self.items_per_step or self.ema_step_time_ms <= 0:
            return 0.0
        return self.items_per_step / (self.ema_step_time_ms * 1e-3)

    @property
    def items_per_s_instant(self) -> float:
        """Throughput off this step's wall time alone (noisy)."""
        if not self.items_per_step or self.step_time_ms <= 0:
            return 0.0
        return self.items_per_step / (self.step_time_ms * 1e-3)

    def counters(self) -> Dict[str, float]:
        """The standard keys trainers merge into each metrics record."""
        out = {"step_time_ms": round(self.step_time_ms, 3),
               "wall_s": round(self.wall_s, 3)}
        if self.items_per_step:
            out["throughput_items_per_s"] = round(self.items_per_s, 1)
            out["throughput_items_per_s_instant"] = round(
                self.items_per_s_instant, 1)
        return out


class ProfileWindow:
    """Programmatic ``torch.profiler`` capture over a step window.

    Loops call ``maybe_start(step)`` / ``maybe_stop(step)`` around each
    step; the capture starts at ``start`` and stops after ``stop``
    (inclusive) and writes a Chrome trace (Perfetto-loadable) to
    ``profile_dir/trace.json``.  It records CPU activity, and CUDA activity
    when CUDA is available.  Inert when ``profile_dir`` is None.
    ``close()`` stops a still-open capture (loops shorter than the window);
    the finished capture stays in ``profiler`` for ``key_averages()``.
    """

    def __init__(self, profile_dir: Optional[str], start: int = 0,
                 stop: int = 4) -> None:
        self.profile_dir = profile_dir
        self.start = start
        self.stop = stop
        self.profiler: Optional[torch.profiler.profile] = None
        self._active = False

    @property
    def trace_path(self) -> Optional[str]:
        if self.profile_dir is None:
            return None
        return os.path.join(self.profile_dir, "trace.json")

    def maybe_start(self, step: int) -> None:
        if (self.profile_dir is None or self._active
                or step != self.start):
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.profiler = torch.profiler.profile(activities=acts)
        self.profiler.__enter__()
        self._active = True

    def maybe_stop(self, step: int) -> None:
        if not self._active or step < self.stop:
            return
        self.close()

    def close(self) -> None:
        if not self._active:
            return
        self._active = False
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.profiler.__exit__(None, None, None)
        os.makedirs(self.profile_dir, exist_ok=True)
        self.profiler.export_chrome_trace(self.trace_path)
