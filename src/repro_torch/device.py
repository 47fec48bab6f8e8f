"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """``cuda`` unless the caller asks for another device.

    With no device given (or ``"cuda"``) and no CUDA device present this
    raises: an entry point never carries on silently on the CPU.  Pass
    ``device="cpu"`` to run on the CPU on purpose (the tests do).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU on purpose")
    return dev


def set_full_precision() -> None:
    """Keep float32 products in full float32 (no TF32), as the reference
    mixes at ``Precision.HIGHEST``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
