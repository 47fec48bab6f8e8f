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
from typing import (Any, Dict, Iterable, List, Protocol, Sequence,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch import tree as T

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


# ------------------------------------------------------ tree computations

def tree_sq_sum(tree: Tree) -> torch.Tensor:
    """Sum of squares over every leaf (float32 accumulation)."""
    leaves = T.leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return sum(torch.sum(torch.square(l.float())) for l in leaves)


def global_norm(tree: Tree) -> torch.Tensor:
    """L2 norm over the flattened tree."""
    return torch.sqrt(tree_sq_sum(tree))


def consensus_error(tree: Tree) -> torch.Tensor:
    """RMS per-agent disagreement sqrt(1/A sum_i ||x_i - x̄||^2), the norm
    taken over all leaves jointly.  Leaves carry a leading agent dim A.
    It is the Lyapunov quantity of Thm 2.1 and is 0 exactly at consensus."""
    leaves = T.leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    A = leaves[0].shape[0]
    per_agent = torch.zeros((A,), dtype=torch.float32,
                            device=leaves[0].device)
    for l in leaves:
        v = l.float()
        mean = torch.mean(v, dim=0, keepdim=True)
        per_agent = per_agent + torch.sum(
            torch.square(v - mean).reshape(A, -1), dim=1)
    return torch.sqrt(torch.mean(per_agent))


def frodo_step_metrics(grads: Tree, memory_terms: Tree,
                       delta: Tree) -> Dict[str, torch.Tensor]:
    """The per-update scalar pack the optimizer attaches to its state."""
    return frodo_step_metrics_sq(
        grads, [tree_sq_sum(m) for m in T.leaves(memory_terms)], delta)


def frodo_step_metrics_sq(grads: Tree, memory_sq: Sequence[torch.Tensor],
                          delta: Tree) -> Dict[str, torch.Tensor]:
    """``frodo_step_metrics`` from the memory terms' per-leaf squared norms,
    in leaf order (the same sum, so the same value): the optimizer keeps
    these instead of the f32 memory terms themselves."""
    memory_sq = list(memory_sq)
    return {
        "grad_norm": global_norm(grads),
        "memory_norm": torch.sqrt(sum(memory_sq) if memory_sq else
                                  torch.zeros((), dtype=torch.float32)),
        "update_norm": global_norm(delta),
    }


def zeros_like_metrics(names: Iterable[str],
                       device=None) -> Dict[str, torch.Tensor]:
    """Placeholder with the same keys as ``frodo_step_metrics``."""
    return {n: torch.zeros((), dtype=torch.float32, device=device)
            for n in names}
