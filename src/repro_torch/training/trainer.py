"""Trainer loop: wires data pipeline, train step, metrics, checkpoints.

The port of the JAX package's ``repro.training.trainer``.  There is no
``jit``: the step runs eagerly.  Telemetry: every step's scalar metrics are
merged with the host-side step-timing counters and drained into ``sink``
(any ``obs.MetricsSink``); ``metrics_file`` keeps the end-of-run JSON
history.  With a sink or a span recorder present, each step ends in a
device sync, so the timer and the spans measure the step, not its launch.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch import tree as TR
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.device import Device, resolve_device
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.train_step import (TrainConfig, TrainState,
                                             init_train_state,
                                             make_train_step,
                                             train_state_from_params)


def _scalars(metrics: Dict[str, Any]) -> Dict[str, float]:
    """The 0-d entries as Python floats (one device-to-host copy)."""
    keys = [k for k, v in metrics.items() if np.ndim(v) == 0]
    dev = [k for k in keys if isinstance(metrics[k], torch.Tensor)]
    out = {k: float(np.asarray(metrics[k])) for k in keys if k not in dev}
    if dev:
        vals = torch.stack([metrics[k].float() for k in dev]).tolist()
        out.update(zip(dev, vals))
    return {k: out[k] for k in keys}


@dataclasses.dataclass
class Trainer:
    cfg: ModelConfig
    tc: TrainConfig
    n_agents: int
    n_pods: int = 1
    log_every: int = 10
    ckpt_every: int = 0
    ckpt_dir: str = "checkpoints"
    metrics_file: Optional[str] = None
    sink: Optional[obs.MetricsSink] = None
    tokens_per_step: float = 0.0   # for throughput_items_per_s in the sink
    profile_dir: Optional[str] = None   # torch.profiler capture target
    profile_start: int = 0              # capture window: steps
    profile_stop: int = 4               # [profile_start, profile_stop]
    device: Device = None               # cuda unless "cpu" is asked for

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.step_fn = make_train_step(self.cfg, self.tc, self.n_agents,
                                       self.n_pods)
        self._history: list[Dict[str, float]] = []
        self.profile: Optional[obs.ProfileWindow] = None

    def init(self, seed: int = 0, params: Any = None) -> TrainState:
        """Random init from ``seed``, or a fresh state around ``params``
        (a tree of numpy arrays, e.g. the JAX package's, or of tensors)."""
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return init_train_state(gen, self.cfg, self.tc, self.n_agents,
                                    self.device)
        if isinstance(TR.leaves(params)[0], np.ndarray):
            params = params_from_numpy(params, self.device)
        return train_state_from_params(params, self.tc)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, state: TrainState, data: Iterator[Dict[str, np.ndarray]],
            steps: int) -> TrainState:
        timer = obs.StepTimer(items_per_step=self.tokens_per_step)
        prof = obs.ProfileWindow(self.profile_dir, self.profile_start,
                                 self.profile_stop)
        self.profile = prof
        try:
            for i in range(steps):
                prof.maybe_start(i)
                t_step = time.perf_counter()
                with obs.span("train.step", step=i):
                    with obs.span("train.data"):
                        batch = next(data)
                    t0 = time.perf_counter()
                    with obs.step_annotation("train", step=i), \
                            obs.span("train.device_step"):
                        state, metrics = self.step_fn(state, batch)
                        if (self.sink is not None
                                or obs.get_recorder() is not None):
                            # wait so the timer (and the span) measures
                            # the step, not the launch
                            self._sync()
                    t1 = time.perf_counter()
                    timer.tick()
                    with obs.span("train.metrics"):
                        scalars = _scalars(metrics)
                        t2 = time.perf_counter()
                        if self.sink is not None:
                            rec = dict(
                                step=i, **scalars, **timer.counters(),
                                phase_data_ms=round((t0 - t_step) * 1e3, 3),
                                phase_step_ms=round((t1 - t0) * 1e3, 3),
                                phase_metrics_ms=round((t2 - t1) * 1e3, 3))
                            self.sink.write(rec)
                if i % self.log_every == 0 or i == steps - 1:
                    m = dict(scalars)
                    m.update(step=i, wall=round(timer.wall_s, 2))
                    self._history.append(m)
                    print(json.dumps(m), flush=True)
                if self.ckpt_every and (i + 1) % self.ckpt_every == 0:
                    with obs.annotate("checkpoint_save"):
                        ckpt.save(
                            os.path.join(self.ckpt_dir, f"step{i+1}.npz"),
                            state.params, {"step": i + 1})
                prof.maybe_stop(i)
        finally:
            prof.close()
        if self.metrics_file:
            os.makedirs(os.path.dirname(self.metrics_file) or ".",
                        exist_ok=True)
            with open(self.metrics_file, "w") as f:
                json.dump(self._history, f, indent=1)
        return state

    @property
    def history(self):
        return self._history
