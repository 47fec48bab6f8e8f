"""Build, load and launch the hand-written CUDA kernels of the FrODO update.

The kernels are in ``csrc/frodo_update.cu`` (see its header for the design).
They replace the JAX package's Pallas kernels ``exact_update_2d`` and
``expsum_update_2d`` (``src/repro/kernels/frodo_update.py``).

The source is compiled with ``nvcc`` for ``sm_90a`` (``UNITS`` objects side
by side) into a shared library with a plain C interface, at first use, into
``build/repro_torch/`` at the root of the checkout, under a name keyed by a
hash of the source and flags.  The library is loaded with ``ctypes``, and
each entry resolved once.  Nothing CUDA-specific happens when this module
is imported, so it imports on a machine without ``nvcc``.

The per-launch host path is kept short: the exp-sum rates and
coefficients are packed again only when the pair of host tensors (an
optimizer's, the same for all its leaves) or its contents change, the
stream is read without a device context when the tensor's device is
current, and a check builds its message only when it fails.

``LAUNCHES`` counts the launches of each kernel: a wrapper adds one exactly
where it launches, so a run can show which kernels its path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

LAUNCHES: Dict[str, int] = {"frodo_exact_update": 0,
                            "frodo_expsum_update": 0}

SOURCE = Path(__file__).resolve().parent / "csrc" / "frodo_update.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
UNITS = 4                  # objects compiled side by side (FRODO_UNIT)
MAX_SLOTS = 12288          # kMaxSlots in the source: f32 slot weights in 48 KB
MAX_K = 16                 # kMaxK in the source

_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
_lib: Optional[ctypes.CDLL] = None
# resolved once, when the library loads: the entry for each dtype (pair)
_EXACT_FN: Dict[torch.dtype, Callable] = {}
_EXPSUM_FN: Dict[Tuple[torch.dtype, torch.dtype], Callable] = {}
# the last (rates, coeffs) packed: (rates, coeffs, their versions, packed)
_LAST_PACKED: Optional[tuple] = None


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
                         + " ".join(NVCC_FLAGS).encode()
                         + f"units={UNITS}".encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfrodo_update_{key}.so"


def build() -> dict:
    """Compile the kernels unless this source's library is already built:
    ``UNITS`` nvcc runs side by side, one object each, then one link.
    Returns ``{"path", "seconds", "log", "cached"}``; ``log`` holds nvcc's
    output, with ptxas's register and shared-memory counts."""
    out = library_path()
    if out.is_file():
        return {"path": str(out), "seconds": 0.0, "log": "", "cached": True}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    objs = [f"{stem}.{u}.o" for u in range(UNITS)]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, f"-DFRODO_UNIT={u}", "-c", "-o", obj,
         str(SOURCE)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for u, obj in enumerate(objs)]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    failed = [p.args for p in procs if p.returncode != 0]
    link = [nvcc, "-shared", "-o", f"{stem}.so", *objs]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed = [link]
    seconds = time.perf_counter() - t0
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    if failed:
        Path(f"{stem}.so").unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed: {' '.join(map(str, failed[0]))}"
                           f"\n{log}")
    os.replace(f"{stem}.so", out)
    return {"path": str(out), "seconds": seconds, "log": log, "cached": False}


class ExpsumWeights(ctypes.Structure):
    """The source's ``ExpsumWeights``: K rates and coefficients as f32, zero
    past K, handed to the kernel by value."""
    _fields_ = [("r", ctypes.c_float * MAX_K), ("c", ctypes.c_float * MAX_K)]


def pack_expsum_weights(rates: torch.Tensor,
                        coeffs: torch.Tensor) -> ExpsumWeights:
    """``rates`` and ``coeffs`` ((K,) host tensors, 1 <= K <= 16) packed as
    the kernel takes them."""
    K = rates.shape[0] if rates.dim() == 1 else -1
    if not 1 <= K <= MAX_K:
        raise ValueError(f"expsum_update: K={K} not in 1..{MAX_K}")
    if tuple(coeffs.shape) != (K,):
        raise ValueError(f"expsum_update: rates/coeffs must have shape ({K},)")
    w = ExpsumWeights()
    w.r[:K] = rates.float().tolist()
    w.c[:K] = coeffs.float().tolist()
    return w


def expsum_entry(g_dtype: torch.dtype, acc_dtype: torch.dtype) -> str:
    """The library's exp-sum entry for a (g, acc) dtype pair."""
    if g_dtype not in _DTYPE_TAG or acc_dtype not in _DTYPE_TAG:
        raise ValueError(f"expsum_update: dtypes ({g_dtype}, {acc_dtype}) "
                         "not f32/bf16")
    return f"frodo_expsum_update_{_DTYPE_TAG[g_dtype]}_{_DTYPE_TAG[acc_dtype]}"


def ptxas_registers(log: str) -> tuple:
    """From ``build()``'s log (``nvcc -Xptxas -v``): ``({kernel: registers},
    {kernel: spill store bytes})`` for each kernel instantiation, named
    ``expsum<g,acc,K=k>`` or ``exact<t>``; the spills only where nonzero."""
    types = {"f": "f32", "13__nv_bfloat16": "bf16"}
    regs, spills, name = {}, {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # the second bf16 of a pair is mangled as a back-reference S<n>_
            k = re.search(r"(exact|expsum)_update_kernelI((?:f|13__nv_bfloat16"
                          r"|S\d*_)+)(?:Li(\d+)E)?E", m.group(1))
            if k is None:
                name = m.group(1)
            else:
                t = ",".join(types.get(x, "bf16") for x in re.findall(
                    r"f|13__nv_bfloat16|S\d*_", k.group(2)))
                name = f"{k.group(1)}<{t}" + (f",K={k.group(3)}>"
                                              if k.group(3) else ">")
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name and int(m.group(1)):
            spills[name] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
    return regs, spills


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        lib.frodo_error_string.argtypes = [i32]
        lib.frodo_error_string.restype = ctypes.c_char_p
        for dt, tag in _DTYPE_TAG.items():
            fn = getattr(lib, f"frodo_exact_update_{tag}")
            fn.argtypes = [ptr, ptr, ptr, ptr, i32, i64, i32, f32, f32, ptr]
            fn.restype = i32
            _EXACT_FN[dt] = fn
            for adt in _DTYPE_TAG:
                fn = getattr(lib, expsum_entry(dt, adt))
                fn.argtypes = [ptr, ptr, ptr, ctypes.POINTER(ExpsumWeights),
                               i32, i64, f32, f32, ptr]
                fn.restype = i32
                _EXPSUM_FN[(dt, adt)] = fn
        _lib = lib
    return _lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        msg = _library().frodo_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def _launch(fn: Callable, dev: int, *args) -> int:
    """``fn(*args, stream)`` on CUDA device ``dev``'s current stream,
    entering a device context only when ``dev`` is not already the current
    device (a launch goes to the current device)."""
    if dev == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev))


def _packed(rates: torch.Tensor, coeffs: torch.Tensor) -> ExpsumWeights:
    """``rates``/``coeffs`` packed, packed again only when the pair (an
    optimizer's, the same for all its leaves) or its contents changed
    since the last call."""
    global _LAST_PACKED
    last = _LAST_PACKED
    if (last is not None and last[0] is rates and last[1] is coeffs
            and last[2] == (rates._version, coeffs._version)):
        return last[3]
    w = pack_expsum_weights(rates, coeffs)
    _LAST_PACKED = (rates, coeffs, (rates._version, coeffs._version), w)
    return w


def exact_update(g: torch.Tensor, hist: torch.Tensor, cursor: int,
                 weights: torch.Tensor, alpha: float,
                 beta: float) -> torch.Tensor:
    """Launch the exact-memory kernel.  Returns delta (g's shape and dtype)
    and pushes g into ``hist[cursor]`` IN PLACE.

    g: (...) f32 or bf16; hist: (T, ...) of g's dtype; weights: (T,) f32
    unrotated mu; all contiguous on one CUDA device; 0 <= cursor < T."""
    if not g.is_cuda:
        raise ValueError(f"exact_update: g is on {g.device}, not CUDA")
    dev = g.get_device()
    if hist.get_device() != dev or weights.get_device() != dev:
        raise ValueError("exact_update: g, hist and weights must be on one "
                         "device")
    if g.dtype not in _DTYPE_TAG or hist.dtype != g.dtype:
        raise ValueError(f"exact_update: (g, hist) dtypes ({g.dtype}, "
                         f"{hist.dtype}) not in {{(f32, f32), (bf16, bf16)}}")
    if weights.dtype != torch.float32:
        raise ValueError("exact_update: weights not f32")
    if not (g.is_contiguous() and hist.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError("exact_update: not contiguous")
    T = hist.shape[0]
    if hist.shape[1:] != g.shape:
        raise ValueError(f"exact_update: hist {tuple(hist.shape)} vs g "
                         f"{tuple(g.shape)}")
    if weights.shape != (T,):
        raise ValueError(f"exact_update: weights {tuple(weights.shape)}, "
                         f"want ({T},)")
    if not 1 <= T <= MAX_SLOTS:
        raise ValueError(f"exact_update: T={T} not in 1..{MAX_SLOTS}")
    if not 0 <= cursor < T:
        raise ValueError(f"exact_update: cursor {cursor} not in [0, {T})")
    delta = torch.empty_like(g)
    n = g.numel()
    if n == 0:
        return delta
    if _lib is None:
        _library()
    rc = _launch(_EXACT_FN[g.dtype], dev, g.data_ptr(), hist.data_ptr(),
                 delta.data_ptr(), weights.data_ptr(), T, n, int(cursor),
                 float(alpha), float(beta))
    if rc:
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
    value, packed again only when the pair changes, so reading them never
    waits for the device); K <= 16."""
    if not g.is_cuda:
        raise ValueError(f"expsum_update: g is on {g.device}, not CUDA")
    dev = g.get_device()
    if acc.get_device() != dev:
        raise ValueError("expsum_update: g and acc on two devices")
    if g.dtype not in _DTYPE_TAG or acc.dtype not in _DTYPE_TAG:
        raise ValueError(f"expsum_update: dtypes ({g.dtype}, {acc.dtype}) "
                         "not f32/bf16")
    if not (g.is_contiguous() and acc.is_contiguous()):
        raise ValueError("expsum_update: not contiguous")
    K = acc.shape[0]
    if acc.shape[1:] != g.shape:
        raise ValueError(f"expsum_update: acc {tuple(acc.shape)} vs g "
                         f"{tuple(g.shape)}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"expsum_update: K={K} not in 1..{MAX_K}")
    if not (rates.is_cpu and coeffs.is_cpu):
        raise ValueError("expsum_update: rates and coeffs must be host "
                         "tensors")
    if rates.shape != (K,) or coeffs.shape != (K,):
        raise ValueError(f"expsum_update: rates/coeffs must have shape "
                         f"({K},)")
    w = _packed(rates, coeffs)
    delta = torch.empty_like(g)
    n = g.numel()
    if n == 0:
        return delta
    if _lib is None:
        _library()
    rc = _launch(_EXPSUM_FN[(g.dtype, acc.dtype)], dev, g.data_ptr(),
                 acc.data_ptr(), delta.data_ptr(), w, K, n, float(alpha),
                 float(beta))
    if rc:
        _check(rc, "frodo_expsum_update")
    LAUNCHES["frodo_expsum_update"] += 1
    return delta
