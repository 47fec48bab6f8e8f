"""Trainer loop: wires data pipeline, train step, metrics, checkpoints.

The port of the JAX package's ``repro.training.trainer``.  There is no
``jit``: the step runs eagerly.  Telemetry: every step's scalar metrics are
merged with the host-side step-timing counters and drained into ``sink``
(any ``obs.MetricsSink``); ``metrics_file`` keeps the end-of-run JSON
history.  With a sink or a span recorder present, each step ends in a
device sync, so the timer and the spans measure the step, not its launch.

With a process ``group`` the agents are split over its ranks
(``train_step.make_train_step``): each rank draws the one-process initial
stack and keeps its slice, takes its rows of every batch, and only rank 0
prints, writes the sink and the metrics file, and saves checkpoints (of
every rank's agents, gathered).
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
from repro_torch.distributed import comm
from repro_torch.models import transformer as T
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
    group: Any = None                   # process group: agent-sharded

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.step_fn = make_train_step(self.cfg, self.tc, self.n_agents,
                                       self.n_pods, self.group)
        self.rank = self.first_agent = 0
        self.n_local = self.n_agents
        if self.group is not None:
            self.rank = comm.rank(self.group)
            self.n_local = self.n_agents // comm.world_size(self.group)
            self.first_agent = self.rank * self.n_local
        self._history: list[Dict[str, float]] = []
        self.profile: Optional[obs.ProfileWindow] = None

    def init(self, seed: int = 0, params: Any = None) -> TrainState:
        """Random init from ``seed``, or a fresh state around ``params``
        (a tree of numpy arrays, e.g. the JAX package's, or of tensors)."""
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            if self.group is None:
                return init_train_state(gen, self.cfg, self.tc,
                                        self.n_agents, self.device)
            # every agent's draw, as one process makes it (no optimizer
            # state: this rank's is made for its slice below)
            params = T.init_params(gen, self.cfg, (self.n_agents,),
                                   self.device)
        if isinstance(TR.leaves(params)[0], np.ndarray):
            params = params_from_numpy(params, self.device)
        if self.group is not None:
            params = self._local(params)
        return train_state_from_params(params, self.tc)

    def _local(self, tree):
        """This rank's agents of an all-agent stack (tensors copied, so the
        whole stack can be freed; numpy arrays as views)."""
        lo, n = self.first_agent, self.n_local
        return TR.tree_map(lambda t: t[lo:lo + n].clone() if isinstance(
            t, torch.Tensor) else t[lo:lo + n], tree)

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
                        if self.group is not None:
                            batch = self._local(batch)
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
                        if self.sink is not None and self.rank == 0:
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
                    if self.rank == 0:
                        print(json.dumps(m), flush=True)
                if self.ckpt_every and (i + 1) % self.ckpt_every == 0:
                    with obs.annotate("checkpoint_save"):
                        self._save(state, i + 1)
                prof.maybe_stop(i)
        finally:
            prof.close()
        if self.metrics_file and self.rank == 0:
            os.makedirs(os.path.dirname(self.metrics_file) or ".",
                        exist_ok=True)
            with open(self.metrics_file, "w") as f:
                json.dump(self._history, f, indent=1)
        return state

    def _save(self, state: TrainState, step: int) -> None:
        params = state.params
        if self.group is not None:          # every rank's agents, stacked
            params = TR.tree_map(lambda t: comm.all_gather(t, self.group)
                                 .reshape((-1,) + t.shape[1:]), params)
        if self.rank == 0:
            ckpt.save(os.path.join(self.ckpt_dir, f"step{step}.npz"),
                      params, {"step": step})

    @property
    def history(self):
        return self._history
