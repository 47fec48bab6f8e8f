"""Carry parameters and optimizer state across from the JAX package.

The JAX package's arrays are exported with ``np.asarray`` (its bf16 arrays
become numpy arrays of the ``ml_dtypes`` bfloat16 type); these functions turn
such numpy trees into the port's tensors on a device, bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.device import Device


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
