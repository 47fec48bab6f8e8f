"""Flat-file checkpointing (npz) for parameter / optimizer-state trees.

The port of the JAX package's ``repro.training.checkpoint``, in the same
format: one array per leaf, keyed by the JAX key-path string of the leaf
(``jax.tree_util.keystr``, e.g. ``['blocks']['mlp']['up']['w']``), bf16
saved as f32.  A checkpoint written by either package restores into the
other bit for bit.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten_with_keys(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key-path string, leaf) pairs in ``jax.tree.leaves`` order: dicts in
    sorted-key order, each key written as ``['name']``."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        out += _flatten_with_keys(tree[k], f"{prefix}[{k!r}]")
    return out


def _np_safe(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def save(path: str, tree: Any, metadata: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrs: Dict[str, np.ndarray] = {k: _np_safe(v)
                                   for k, v in _flatten_with_keys(tree)}
    np.savez(path, **arrs)
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)


def restore(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (shape checked; each leaf
    takes the dtype and device of its counterpart in ``like``)."""
    fname = path if path.endswith(".npz") else path + ".npz"
    with np.load(fname) as z:
        def leaf(key: str, ref: torch.Tensor) -> torch.Tensor:
            arr = z[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"{tuple(ref.shape)}")
            return torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=ref.device, dtype=ref.dtype)

        return _unflatten_like(like, leaf, "")


def _unflatten_like(like: Any, leaf, prefix: str) -> Any:
    if not isinstance(like, dict):
        return leaf(prefix, like)
    return {k: _unflatten_like(v, leaf, f"{prefix}[{k!r}]")
            for k, v in like.items()}
