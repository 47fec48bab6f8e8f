"""Carry parameters and optimizer state across from the JAX package.

The JAX package's arrays are exported with ``np.asarray`` (its bf16 arrays
become numpy arrays of the ``ml_dtypes`` bfloat16 type); these functions turn
such numpy trees into the port's tensors on a device, bit for bit.

For a tensor-parallel run each rank takes its local shard of every leaf
under a spec tree (``train_state_specs``, ``param_specs``,
``cache_specs``, sanitized): ``shard_tree`` cuts whole trees (numpy
arrays or tensors) into contiguous shards in their own storage, which the
fused update kernels take in place, and ``gather_tree`` puts every rank's
shards back together (for checks).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.device import Device
from repro_torch.distributed import sharding as SH


def tensor_from_numpy(a, device: Device) -> torch.Tensor:
    """One array, bit-exact: bf16 goes through a 16-bit integer view."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(tree: Any, device: Device) -> Any:
    """A tree (nested dicts, or one array) of numpy arrays -> tensors."""
    return TR.tree_map(lambda a: tensor_from_numpy(a, device), tree)


def frodo_state_from_numpy(state: Dict[str, Any],
                           device: Device) -> Dict[str, Any]:
    """An exported optimizer state (``{"step", "hist" | "acc", ...}``) ->
    the port's state: ``step`` becomes a Python int, every other entry a
    tree of tensors."""
    out: Dict[str, Any] = {}
    for k, v in state.items():
        if k == "step":
            out[k] = int(np.asarray(v))
        else:
            out[k] = params_from_numpy(v, device)
    return out


def shard_tree(tree: Any, specs: Any, mesh, device: Device) -> Any:
    """This rank's shard of every leaf of ``tree`` (numpy arrays, bit for
    bit, or tensors) under the matching leaf of ``specs``, on ``device``.
    A leaf without a shape (an optimizer's step count) passes through."""
    sizes, coords = SH.mesh_axis_sizes(mesh), SH.mesh_coords(mesh)

    def one(a, spec):
        if not hasattr(a, "shape") or (isinstance(a, np.ndarray)
                                       and a.ndim == 0 and
                                       a.dtype.kind in "iu"):
            return int(a) if isinstance(a, np.ndarray) else a
        sl = SH.local_slice(a.shape, spec, sizes, coords)
        if isinstance(a, torch.Tensor):
            return a[sl].to(device).clone(
                memory_format=torch.contiguous_format)
        return tensor_from_numpy(a[sl], device)

    return TR.tree_map(one, tree, specs)


def gather_tree(local: Any, specs: Any, mesh, shapes: Any) -> Any:
    """Every rank's shards of ``local`` put together into whole tensors of
    the shapes of ``shapes`` (a tree of anything with a ``shape``); a
    collective: every rank of the mesh calls it."""
    return TR.tree_map(
        lambda t, spec, s: SH.gather(t, spec, mesh, tuple(s.shape))
        if isinstance(t, torch.Tensor) else t, local, specs, shapes)
