"""Build, load and launch the hand-written CUDA kernels of the FrODO update.

The kernels are in ``csrc/frodo_update.cu`` (see its header for the design).
They replace the JAX package's Pallas kernels ``exact_update_2d`` and
``expsum_update_2d`` (``src/repro/kernels/frodo_update.py``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``build/repro_torch/`` at the
root of the checkout, under a name keyed by a hash of the source and flags.
The library is loaded with ``ctypes``.  Nothing CUDA-specific happens when
this module is imported, so it imports on a machine without ``nvcc``.

``LAUNCHES`` counts the launches of each kernel: a wrapper adds one exactly
where it launches, so a run can show which kernels its path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

LAUNCHES: Dict[str, int] = {"frodo_exact_update": 0,
                            "frodo_expsum_update": 0}

SOURCE = Path(__file__).resolve().parent / "csrc" / "frodo_update.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_SLOTS = 12288          # kMaxSlots in the source: f32 slot weights in 48 KB
MAX_K = 16                 # kMaxK in the source

_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin): the FrODO CUDA kernels are built from "
        f"{SOURCE} with nvcc for sm_90a and there is no other build")


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfrodo_update_{key}.so"


def build() -> dict:
    """Compile the kernels unless this source's library is already built.
    Returns ``{"path", "seconds", "log", "cached"}``; ``log`` holds nvcc's
    output, with ptxas's register and shared-memory counts."""
    out = library_path()
    if out.is_file():
        return {"path": str(out), "seconds": 0.0, "log": "", "cached": True}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "log": log, "cached": False}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        fptr = ctypes.POINTER(ctypes.c_float)
        lib.frodo_error_string.argtypes = [i32]
        lib.frodo_error_string.restype = ctypes.c_char_p
        for tag in ("f32", "bf16"):
            fn = getattr(lib, f"frodo_exact_update_{tag}")
            fn.argtypes = [ptr, ptr, ptr, ptr, i32, i64, i32, f32, f32, ptr]
            fn.restype = i32
            for atag in ("f32", "bf16"):
                fn = getattr(lib, f"frodo_expsum_update_{tag}_{atag}")
                fn.argtypes = [ptr, ptr, ptr, fptr, fptr, i32, i64, f32, f32,
                               ptr]
                fn.restype = i32
        _lib = lib
    return _lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        msg = _library().frodo_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def exact_update(g: torch.Tensor, hist: torch.Tensor, cursor: int,
                 weights: torch.Tensor, alpha: float,
                 beta: float) -> torch.Tensor:
    """Launch the exact-memory kernel.  Returns delta (g's shape and dtype)
    and pushes g into ``hist[cursor]`` IN PLACE.

    g: (...) f32 or bf16; hist: (T, ...) of g's dtype; weights: (T,) f32
    unrotated mu; all contiguous on one CUDA device; 0 <= cursor < T."""
    dev = g.device
    _require(dev.type == "cuda", f"exact_update: g is on {dev}, not CUDA")
    _require(hist.device == dev and weights.device == dev,
             "exact_update: g, hist and weights must be on one device")
    _require(g.dtype in _DTYPE_TAG and hist.dtype == g.dtype,
             f"exact_update: (g, hist) dtypes ({g.dtype}, {hist.dtype}) not "
             "in {(f32, f32), (bf16, bf16)}")
    _require(weights.dtype == torch.float32, "exact_update: weights not f32")
    _require(g.is_contiguous() and hist.is_contiguous()
             and weights.is_contiguous(), "exact_update: not contiguous")
    T = hist.shape[0]
    _require(tuple(hist.shape[1:]) == tuple(g.shape),
             f"exact_update: hist {tuple(hist.shape)} vs g {tuple(g.shape)}")
    _require(tuple(weights.shape) == (T,),
             f"exact_update: weights {tuple(weights.shape)}, want ({T},)")
    _require(1 <= T <= MAX_SLOTS, f"exact_update: T={T} not in 1..{MAX_SLOTS}")
    _require(0 <= cursor < T, f"exact_update: cursor {cursor} not in [0, {T})")
    delta = torch.empty_like(g)
    if g.numel() == 0:
        return delta
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"frodo_exact_update_{_DTYPE_TAG[g.dtype]}")(
            g.data_ptr(), hist.data_ptr(), delta.data_ptr(),
            weights.data_ptr(), T, g.numel(), int(cursor), float(alpha),
            float(beta), stream)
    _check(rc, "frodo_exact_update")
    LAUNCHES["frodo_exact_update"] += 1
    return delta


def expsum_update(g: torch.Tensor, acc: torch.Tensor, rates: torch.Tensor,
                  coeffs: torch.Tensor, alpha: float,
                  beta: float) -> torch.Tensor:
    """Launch the exp-sum kernel.  Returns delta (g's shape and dtype) and
    advances the accumulators IN PLACE.

    g: (...) f32 or bf16; acc: (K, ...) f32 or bf16, contiguous on g's CUDA
    device; rates, coeffs: (K,) on the host (they reach the kernel by
    value, so reading them never waits for the device); K <= 16."""
    dev = g.device
    _require(dev.type == "cuda", f"expsum_update: g is on {dev}, not CUDA")
    _require(acc.device == dev, "expsum_update: g and acc on two devices")
    _require(g.dtype in _DTYPE_TAG and acc.dtype in _DTYPE_TAG,
             f"expsum_update: dtypes ({g.dtype}, {acc.dtype}) not f32/bf16")
    _require(g.is_contiguous() and acc.is_contiguous(),
             "expsum_update: not contiguous")
    K = acc.shape[0]
    _require(tuple(acc.shape[1:]) == tuple(g.shape),
             f"expsum_update: acc {tuple(acc.shape)} vs g {tuple(g.shape)}")
    _require(1 <= K <= MAX_K, f"expsum_update: K={K} not in 1..{MAX_K}")
    _require(rates.device.type == "cpu" and coeffs.device.type == "cpu",
             "expsum_update: rates and coeffs must be host tensors")
    _require(tuple(rates.shape) == (K,) and tuple(coeffs.shape) == (K,),
             f"expsum_update: rates/coeffs must have shape ({K},)")
    r = (ctypes.c_float * K)(*rates.tolist())
    c = (ctypes.c_float * K)(*coeffs.tolist())
    delta = torch.empty_like(g)
    if g.numel() == 0:
        return delta
    lib = _library()
    name = f"frodo_expsum_update_{_DTYPE_TAG[g.dtype]}_{_DTYPE_TAG[acc.dtype]}"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(
            g.data_ptr(), acc.data_ptr(), delta.data_ptr(), r, c, K,
            g.numel(), float(alpha), float(beta), stream)
    _check(rc, "frodo_expsum_update")
    LAUNCHES["frodo_expsum_update"] += 1
    return delta
