"""Metrics layer: host-side sinks + metric computations on tensor trees.

* **On the device** — functions on parameter trees (``global_norm``,
  ``consensus_error``, ...).  Producers (``frodo.update``,
  ``consensus.mix_stacked``) call them only when asked to collect metrics
  and return 0-d float32 tensors, so collecting costs no host sync until the
  caller reads the values.
* **On the host** — a ``MetricsSink`` that experiment scripts write one flat,
  JSON-serialisable record per step into.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from typing import (Any, Dict, Iterable, List, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.distributed import comm

Tree = Any


# --------------------------------------------------------------------- sinks

@runtime_checkable
class MetricsSink(Protocol):
    """Anything that can absorb one flat dict of JSON-serialisable values."""

    def write(self, record: Dict[str, Any]) -> None: ...

    def close(self) -> None: ...


class NullSink:
    """Drops everything."""

    def write(self, record: Dict[str, Any]) -> None:
        pass

    def close(self) -> None:
        pass


class MemorySink:
    """Accumulates records in ``self.records`` (tests, notebooks)."""

    def __init__(self) -> None:
        self.records: List[Dict[str, Any]] = []

    def write(self, record: Dict[str, Any]) -> None:
        self.records.append(dict(record))

    def close(self) -> None:
        pass


class JsonlSink:
    """One JSON object per line, flushed per write so partial runs are
    readable.  ``mode='w'`` truncates, ``'a'`` appends."""

    def __init__(self, path: str, mode: str = "w") -> None:
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, mode)
        self._lock = threading.Lock()

    def write(self, record: Dict[str, Any]) -> None:
        line = json.dumps(scalarize(record))
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class JsonlRecords(List[Dict[str, Any]]):
    """``read_jsonl`` result: a list of records that also carries
    ``n_skipped``, the number of torn or malformed lines dropped."""

    n_skipped: int = 0


def read_jsonl(path: str, strict: bool = False) -> JsonlRecords:
    """Load a JSONL metrics file.  Malformed lines (a run killed mid-write
    leaves a torn last line) are skipped, counted in ``n_skipped`` and
    logged; ``strict=True`` raises on the first bad line instead."""
    out = JsonlRecords()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if strict:
                    raise
                out.n_skipped += 1
    if out.n_skipped:
        logging.getLogger(__name__).warning(
            "read_jsonl: skipped %d malformed line(s) in %s",
            out.n_skipped, path)
    return out


def scalarize(record: Dict[str, Any]) -> Dict[str, Any]:
    """Tensors and numpy scalars become plain Python for ``json.dumps``;
    non-scalar arrays are dropped (per-agent vectors stay out of JSONL)."""
    out: Dict[str, Any] = {}
    for k, v in record.items():
        if isinstance(v, torch.Tensor):
            if v.dim() == 0:
                out[k] = v.item()
        elif isinstance(v, (np.ndarray, np.generic)):
            a = np.asarray(v)
            if a.ndim == 0:
                out[k] = a.item()
        else:
            out[k] = v
    return out


# ------------------------------------------------------- module-default sink

_DEFAULT_SINK: MetricsSink = NullSink()


def set_sink(sink: Optional[MetricsSink]) -> MetricsSink:
    """Install the process-default sink; returns the previous one."""
    global _DEFAULT_SINK
    prev = _DEFAULT_SINK
    _DEFAULT_SINK = sink if sink is not None else NullSink()
    return prev


def get_sink() -> MetricsSink:
    return _DEFAULT_SINK


def record(name: str, value: Any, step: Optional[int] = None,
           sink: Optional[MetricsSink] = None, **extra: Any) -> None:
    """Write one named value (plus extras) to ``sink``, or to the
    process-default sink."""
    rec: Dict[str, Any] = {"name": name, "value": value}
    if step is not None:
        rec["step"] = step
    rec.update(extra)
    (sink or _DEFAULT_SINK).write(rec)


# ------------------------------------------------------ tree computations

def tree_sq_sum(tree: Tree,
                counted: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Sum of squares over every leaf (float32 accumulation); with
    ``counted`` (per leaf, in ``tree.leaves`` order) only over the leaves
    flagged True: a rank holding its shards on a mesh counts a leaf only
    where its coordinate is 0 on every non-agent axis over which the leaf
    is replicated, so the sum over every rank counts each element once."""
    leaves = T.leaves(tree)
    if counted is not None:
        leaves = [l for l, c in zip(leaves, counted) if c]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return sum(sq_sum(l) for l in leaves)


#: Elements of a leaf (of each agent's columns where the agent dim is kept)
#: that the norms square, the clip scales and the uniform mix averages at a
#: time: their f32 temporaries stay at 256 MiB an agent however large the
#: leaf, where the tied 256,000 x 4,096 embedding of two agents would take
#: 7.8 GiB a temporary beside the whole train state.  A leaf no larger is
#: done in one piece, so its value is the unsplit expression's.
CHUNK = 1 << 26


def col_slices(n: int) -> List[Tuple[int, int]]:
    """The ranges [i, j) of at most CHUNK that cover ``range(n)``."""
    if n <= CHUNK:
        return [(0, n)]
    return [(i, min(n, i + CHUNK)) for i in range(0, n, CHUNK)]


def chunks(x: torch.Tensor) -> List[torch.Tensor]:
    """``x`` flattened, in slices of at most CHUNK elements (views)."""
    flat = x.reshape(-1)
    return [flat[i:j] for i, j in col_slices(flat.numel())]


def sq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the squares of ``x``'s elements in f32, slice by slice."""
    return sum(torch.sum(torch.square(c.float())) for c in chunks(x))


def global_norm(tree: Tree) -> torch.Tensor:
    """L2 norm over the flattened tree."""
    return torch.sqrt(tree_sq_sum(tree))


def consensus_error(tree: Tree, group=None,
                    counted: Optional[Sequence[bool]] = None
                    ) -> torch.Tensor:
    """RMS per-agent disagreement sqrt(1/A sum_i ||x_i - x̄||^2), the norm
    taken over all leaves jointly.  Leaves carry a leading agent dim A.
    It is the Lyapunov quantity of Thm 2.1 and is 0 exactly at consensus.
    With a process ``group`` (``distributed.comm``) the leaves hold this
    rank's slice of the agents, and the mean and the sum span every
    rank's.  On a mesh whose non-agent axes split the leaves (``counted``
    given), the leaves are this rank's shards: only the leaves flagged in
    ``counted`` add to the sum, which then spans the agents' group and
    every non-agent axis, that is the whole mesh (the default group)."""
    leaves = T.leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    A = leaves[0].shape[0]
    A_all = A if group is None else A * comm.world_size(group)
    per_agent = torch.zeros((A,), dtype=torch.float32,
                            device=leaves[0].device)
    if counted is not None:
        leaves = [l for l, c in zip(leaves, counted) if c]
    for l in leaves:
        # in column slices of at most CHUNK elements an agent (the mean
        # over agents is per column), one all-reduce a leaf with a group
        x = l.reshape(A, -1)
        cols = col_slices(x.shape[1])
        if group is not None:
            col_sum = torch.empty((1, x.shape[1]), dtype=torch.float32,
                                  device=l.device)
            for i, j in cols:
                col_sum[:, i:j] = torch.sum(x[:, i:j].float(), dim=0,
                                            keepdim=True)
            mean = comm.all_reduce_sum(col_sum, group) / A_all
        for i, j in cols:
            v = x[:, i:j].float()
            m = (torch.mean(v, dim=0, keepdim=True) if group is None
                 else mean[:, i:j])
            per_agent = per_agent + torch.sum(torch.square(v - m), dim=1)
    if group is None and counted is None:
        return torch.sqrt(torch.mean(per_agent))
    total = comm.all_reduce_sum(per_agent.sum(),
                                None if counted is not None else group)
    return torch.sqrt(total / A_all)


def frodo_step_metrics(grads: Tree, memory_terms: Tree,
                       delta: Tree) -> Dict[str, torch.Tensor]:
    """The per-update scalar pack the optimizer attaches to its state."""
    return frodo_step_metrics_sq(
        grads, [tree_sq_sum(m) for m in T.leaves(memory_terms)], delta)


def frodo_step_metrics_sq(grads: Tree, memory_sq: Sequence[torch.Tensor],
                          delta: Tree,
                          counted: Optional[Sequence[bool]] = None
                          ) -> Dict[str, torch.Tensor]:
    """``frodo_step_metrics`` from the memory terms' per-leaf squared norms,
    in leaf order (the same sum, so the same value): the optimizer keeps
    these instead of the f32 memory terms themselves.  With ``counted``
    (``tree_sq_sum``'s) the leaves flagged False are left out of all
    three."""
    memory_sq = list(memory_sq)
    if counted is not None:
        memory_sq = [m for m, c in zip(memory_sq, counted) if c]
    return {
        "grad_norm": torch.sqrt(tree_sq_sum(grads, counted)),
        "memory_norm": torch.sqrt(sum(memory_sq) if memory_sq else
                                  torch.zeros((), dtype=torch.float32)),
        "update_norm": torch.sqrt(tree_sq_sum(delta, counted)),
    }


def zeros_like_metrics(names: Iterable[str],
                       device=None) -> Dict[str, torch.Tensor]:
    """Placeholder with the same keys as ``frodo_step_metrics``."""
    return {n: torch.zeros((), dtype=torch.float32, device=device)
            for n in names}
