"""Kernel micro-benchmarks: the port of the JAX package's
``benchmarks/kernel_bench.py``.

Each FrODO update kernel against its plain version (``kernels.ref``) and
against its memory bound, at the JAX bench's sizes (n = 2^14 and 2^17 f32
elements, T = 32 slots, K = 8 accumulators) and at two full-width leaves of
the LLM trainer's path: h2o-danube-1.8b's ``blocks/mlp/up/w`` (2 agents x
8 layers, the depth the trainer runs on one card) and qwen3-moe-30b-a3b's
``blocks/moe/experts/gate`` (2 agents x 1 layer x 128 experts), both with
bf16 gradients and history, the exp-sum accumulators in the dtype each
trainer keeps them in (f32 and bf16).

One row per kernel and size.  ``name`` is the JAX bench's row name without
its implementation suffix (its ``frodo_exact_jnp_n16384`` and
``frodo_exact_pallas_n16384(interp)`` rows are this bench's
``frodo_exact_n16384``, listed under ``jax_rows``).  Columns on the card:

* ``us_events``: CUDA events around one wrapper call (host launch path
  included), median of the repeats, with L2 overwritten before each;
* ``us_device``: the kernel's device time, CUDA events around calls
  queued back to back behind a spin kernel (the host's launch path off
  the clock), L2 overwritten before each, the overwrite's time taken off;
* ``us_plain``: the plain version, by events; for the exact kernel also
  ``us_library``, ``torch.addmv`` computing the same memory term;
* ``us_copy_ceiling`` (exp-sum rows): one ``Tensor.copy_`` that reads and
  writes as many bytes as the kernel, half each way, by events: the rate
  this card gives a pass of that read/write mix;
* ``kernel_bytes``: the bytes the kernel must move, each input read once
  and each output written once: exact ``(T + 3) * n * bytes`` (history and
  g read, delta and the pushed slot written), exp-sum ``2 * n * g_bytes +
  2 * K * n * acc_bytes``;
* ``gb_per_s`` and ``share_of_hbm``: those bytes over the device time,
  against 3.35 TB/s;
* ``traffic_model_bytes``: the JAX bench's modelled fused and unfused HBM
  bytes, for the rows it has;
* ``vs_plain``: the kernel against its plain version on the row's inputs,
  before the timed calls: the delta under ``DELTA_TOL`` of the g dtype,
  the new state (exact: the history with g pushed; exp-sum: the
  accumulators) bit for bit, and planted faults in the plain version on a
  slab of the same inputs, each of which must fail the delta check.  The
  bench raises if the kernel fails or a planted fault passes.

``--device cpu`` runs the plain versions alone, at small n, by the host
clock: a check of the bench's arithmetic, not a measurement of a device.
On ``cuda`` the kernels are built at first use and the bench raises if
they do not build.

    PYTHONPATH=src python -m repro_torch.experiments.kernel_bench --device cuda
    PYTHONPATH=src python -m repro_torch.experiments.kernel_bench --device cpu
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import memory as fmem
from repro_torch.device import resolve_device, set_full_precision
from repro_torch.kernels import frodo_update as KU
from repro_torch.kernels import ref

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
T_SLOTS, K_ACC = 32, 8             # the JAX bench's
ALPHA, BETA = 0.8, 0.35            # the JAX bench's step sizes
SMALL_N = (1 << 14, 1 << 17)       # the JAX bench's sizes
CPU_N = (1 << 10, 1 << 12)         # --device cpu: small, for the test

#: full-width leaves: (label, arch, leaf shape, exp-sum accumulator dtype)
FULL_WIDTH = (
    ("h2o_mlp_up", "h2o-danube-1.8b", "blocks/mlp/up/w", torch.float32),
    ("qwen3moe_experts_gate", "qwen3-moe-30b-a3b",
     "blocks/moe/experts/gate", torch.bfloat16),
)
#: agents and layers of the full-width rows (the trainers' cuts)
FULL_WIDTH_STACK = {"h2o-danube-1.8b": (2, 8), "qwen3-moe-30b-a3b": (2, 1)}

# A delta, kernel vs plain version.  Both form -(a g + b M) in f32 and round
# once to the g dtype, so an element can differ only where the two f32
# results (sums in another order, FMA) differ in the last bits.  In f32 that
# is tests/test_kernels.py's tolerance.  In bf16 it moves the result across
# a rounding boundary: one bf16 ulp (at most 2^-7 of the value), at few
# elements; atol covers elements where a g and b M cancel.  Planted faults
# in the plain version (M weighted 10% high, one coefficient or the slot
# weights off, truncation in place of rounding) must each fail it.  On an
# H100, at full-width LLM leaves, 4.0e-5 (exp-sum) and 4.7e-5 (exact) of
# the bf16 elements differ, each by one ulp; the planted faults make 0.50
# to 0.99 of them differ.
BF16_DELTA_TOL = dict(rtol=2.0 ** -7, atol=1e-6, max_share_differing=1e-3)
DELTA_TOL = {"float32": dict(rtol=1e-5, atol=1e-6, max_share_differing=1.0),
             "bfloat16": BF16_DELTA_TOL}
#: elements of a check's f32 temporaries at a time, and of a planted slab
CHECK_CHUNK, SLAB = 1 << 26, 1 << 22


def traffic_model(n: int, T: Optional[int] = None, K: Optional[int] = None,
                  itemsize: int = 4):
    """The JAX bench's HBM bytes per step: fused = one pass; unfused =
    also writes and reads M."""
    if T is not None:
        return (T + 3) * n * itemsize, (T + 5) * n * itemsize
    return (2 * K + 3) * n * itemsize, (2 * K + 5) * n * itemsize


def exact_bytes(n: int, T: int, itemsize: int) -> int:
    return (T + 3) * n * itemsize


def expsum_bytes(n: int, K: int, g_itemsize: int, acc_itemsize: int) -> int:
    return 2 * n * g_itemsize + 2 * K * n * acc_itemsize


def full_width_shape(arch: str) -> tuple:
    """The agent-stacked leaf of a full-width row."""
    from repro_torch.configs import registry as REG
    cfg = REG.get_config(arch)
    A, L = FULL_WIDTH_STACK[arch]
    if cfg.family == "moe":
        return (A, L, cfg.moe.n_experts, cfg.d_model, cfg.moe.expert_d_ff)
    return (A, L, cfg.d_model, cfg.d_ff)


# ----------------------------------------------------------------- timing

def host_us(fn: Callable, reps: int) -> float:
    """Median host-clock time of one call (CPU rows)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6


def cuda_us(fn: Callable, reps: int, warmup: int = 2,
            flush: Optional[Callable] = None) -> float:
    """Median device time of one call by CUDA events; ``flush`` runs
    before each timed call, outside the events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times) * 1e3


#: GPU cycles of the spin kernel that holds the stream while the host
#: queues the timed calls (~10 ms on an H100)
SPIN_CYCLES = 20_000_000


def device_us(fn: Callable, reps: int,
              flush: Optional[Callable] = None) -> float:
    """Device time of one call of ``fn``: CUDA events around ``reps``
    back-to-back calls, queued behind a spin kernel so that the host's
    launch path is off the clock.  With ``flush``, each call follows a
    flush, whose own time, measured the same way, is taken off."""
    def run(body) -> float:
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            body()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) * 1e3 / reps

    fn()                                   # warm
    if flush is None:
        return run(fn)

    def both():
        flush()
        fn()

    return run(both) - run(flush)


def copy_ceiling_us(nbytes: int, dev, reps: int,
                    flush: Optional[Callable] = None) -> float:
    """Events time of one device ``Tensor.copy_`` of ``nbytes // 2`` bytes
    (as many read as written: ``nbytes`` moved)."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    return cuda_us(lambda: dst.copy_(src), reps, flush=flush)


# -------------------------------------------------------------------- rows

def _rate(row: dict) -> None:
    us = row["us_device"]
    if us:
        row["gb_per_s"] = row["kernel_bytes"] / us / 1e3
        row["share_of_hbm"] = row["kernel_bytes"] / us / 1e-6 \
            / HBM_BYTES_PER_S


def _randn(shape: tuple, dtype, dev, gen) -> torch.Tensor:
    """Normal draws in ``dtype``, one leading slice at a time (a full-width
    history in bf16 is 26 GB; drawn whole in f32 it would not fit)."""
    if np.prod(shape) <= 1 << 29:
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=dev)
    for s in range(shape[0]):
        out[s] = torch.randn(shape[1:], generator=gen, device=dev)
    return out


def delta_diff(a: torch.Tensor, b: torch.Tensor, tol: dict) -> dict:
    """A delta ``a`` against its plain version ``b`` under ``tol``, in
    chunks (the f32 temporaries stay small): the largest |a - b|, the
    elements past rtol/atol, the share of elements that differ at all, and
    whether that passes."""
    x_all, y_all = a.reshape(-1), b.reshape(-1)
    worst, n_past, n_diff = 0.0, 0, 0
    for i in range(0, x_all.numel(), CHECK_CHUNK):
        x = x_all[i:i + CHECK_CHUNK].float()
        y = y_all[i:i + CHECK_CHUNK].float()
        e = (x - y).abs()
        n_past += int((e > tol["atol"] + tol["rtol"] * y.abs()).sum())
        n_diff += int((e > 0).sum())
        worst = max(worst, float(e.max()))
    share = n_diff / max(a.numel(), 1)
    return {"max_abs_err": worst, "elements_past_tol": n_past,
            "share_differing": share,
            "passes": n_past == 0 and share <= tol["max_share_differing"]}


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` and ``b`` hold the same bits (compared in chunks)."""
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    x, y = a.reshape(-1).view(view), b.reshape(-1).view(view)
    return a.shape == b.shape and all(
        torch.equal(x[i:i + CHECK_CHUNK], y[i:i + CHECK_CHUNK])
        for i in range(0, x.numel(), CHECK_CHUNK))


def truncated(d32: torch.Tensor) -> torch.Tensor:
    """An f32 delta cut to bf16 by truncation instead of rounding."""
    return (d32.view(torch.int32) & -65536).view(torch.float32).to(
        torch.bfloat16)


def vs_plain(kernel: str, g, state, coef: tuple, plain: Callable,
             kern: Callable) -> dict:
    """The ``vs_plain`` column of a row: ``kern()`` (which advances
    ``state`` in place and returns the delta) against ``plain(st)`` (which
    advances ``st`` in place and returns ``(delta, st)``) run on a copy of
    the same state; ``coef`` is ``(mu, cursor)`` (exact) or ``(rates,
    coeffs)`` (exp-sum).  Raises if the delta fails ``DELTA_TOL``, the new
    state is not the plain version's bit for bit, or a planted fault in
    the plain version, run on a slab of the same inputs, passes."""
    depth = state.shape[0]
    g_s = g.reshape(-1)[:SLAB]
    st_s = state.reshape(depth, -1)[:, :SLAB].clone()
    state_plain = state.clone()
    d_plain, _ = plain(state_plain)
    d_kern = kern()
    tol = DELTA_TOL[str(g.dtype).replace("torch.", "")]
    d = delta_diff(d_kern, d_plain, tol)
    same = bit_equal(state, state_plain)
    del state_plain, d_kern
    d_ref = d_plain.reshape(-1)[:g_s.numel()]
    if kernel == "exact":
        mu, cursor = coef

        def run(g_, cur=cursor, beta=BETA):
            return ref.frodo_update_ref(g_, st_s.clone(), cur, mu, ALPHA,
                                        beta)[0]

        faults = {"beta_M_x1.1": run(g_s, beta=BETA * 1.1),
                  "slot_weights_off_by_one": run(
                      g_s, cur=(cursor - 1) % depth)}
    else:
        rates, coeffs = coef
        c0 = coeffs.clone()
        c0[0] *= 1.1

        def run(g_, c=coeffs, beta=BETA):
            return ref.frodo_expsum_update_ref(g_, st_s.clone(), rates, c,
                                               ALPHA, beta)[0]

        faults = {"beta_M_x1.1": run(g_s, beta=BETA * 1.1),
                  "c0_x1.1": run(g_s, c=c0)}
    if g.dtype == torch.bfloat16:
        faults["truncation"] = truncated(run(g_s.float()))
    planted = {name: delta_diff(f, d_ref, tol) for name, f in faults.items()}
    out = {"delta_max_abs_err": d["max_abs_err"],
           "delta_elements_past_tol": d["elements_past_tol"],
           "delta_share_differing": d["share_differing"], "delta_tol": tol,
           "state": "bit-equal" if same else "differs", "slab": g_s.numel(),
           "planted": {k: {m: v[m] for m in ("max_abs_err",
                                             "elements_past_tol",
                                             "share_differing")}
                       for k, v in planted.items()}}
    missed = [k for k, v in planted.items() if v["passes"]]
    if not d["passes"] or not same or missed:
        raise RuntimeError(f"{kernel} kernel vs plain version at "
                           f"{list(g.shape)}: {out}; planted faults that "
                           f"pass: {missed}")
    return out


def l2_flush(dev) -> Callable:
    """A call that overwrites 256 MB on ``dev``, five times the H100's 50
    MB L2, so the next kernel reads its inputs from HBM, as an update of
    a model's leaves does (the JAX bench's 2^17 row, 18 MB, would
    otherwise stay in L2 between repeats)."""
    buf = torch.empty(1 << 26, dtype=torch.float32, device=dev)
    return buf.zero_


def _case(name, kernel, shape, g_dtype, state_dtype, jax_rows, dev, gen,
          reps, flush=None) -> dict:
    n = int(np.prod(shape))
    on_card = dev.type == "cuda"
    g = _randn(shape, g_dtype, dev, gen)
    gi = g.element_size()
    si = torch.empty((), dtype=state_dtype).element_size()
    row: Dict = {"name": name, "kernel": kernel, "shape": list(shape),
                 "n": n, "g_dtype": str(g_dtype).replace("torch.", ""),
                 "state_dtype": str(state_dtype).replace("torch.", ""),
                 "jax_rows": jax_rows, "us_events": None, "us_device": None,
                 "us_plain": None,
                 "device": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu")}
    if kernel == "exact":
        T = T_SLOTS
        hist = _randn((T,) + tuple(shape), state_dtype, dev, gen)
        mu = torch.tensor(fmem.mu_weights(T, 0.15), dtype=torch.float32,
                          device=dev)
        cursor = 3
        row.update(T=T, kernel_bytes=exact_bytes(n, T, si))
        state, coef = hist, (mu, cursor)

        def plain(st=hist):
            return ref.frodo_update_ref(g, st, cursor, mu, ALPHA, BETA)

        def kern():
            return KU.exact_update(g, hist, cursor, mu, ALPHA, BETA)

        if on_card:
            w_slot = fmem.slot_weights(mu, cursor).to(state_dtype)
            row["us_library"] = cuda_us(lambda: torch.addmv(
                g.view(-1), hist.view(T, -1).t(), w_slot, beta=-ALPHA,
                alpha=-BETA), reps, flush=flush)
    else:
        K = K_ACC
        acc = _randn((K,) + tuple(shape), state_dtype, dev, gen)
        rates_np, coeffs_np = fmem.fit_expsum(90, 0.15, K)
        rates = torch.tensor(rates_np, dtype=torch.float32)
        coeffs = torch.tensor(coeffs_np, dtype=torch.float32)
        row.update(K=K, kernel_bytes=expsum_bytes(n, K, gi, si))
        state, coef = acc, (rates, coeffs)

        def plain(st=acc):
            return ref.frodo_expsum_update_ref(g, st, rates, coeffs, ALPHA,
                                               BETA)

        def kern():
            return KU.expsum_update(g, acc, rates, coeffs, ALPHA, BETA)

        if on_card:
            row["us_library"] = None   # no one PyTorch call does this update
    if on_card:
        row["vs_plain"] = vs_plain(kernel, g, state, coef, plain, kern)
        row["us_events"] = cuda_us(kern, reps, flush=flush)
        row["us_device"] = device_us(kern, reps, flush)
        row["us_plain"] = cuda_us(plain, max(2, reps // 5), warmup=1,
                                  flush=flush)
        if kernel == "expsum":
            row["us_copy_ceiling"] = copy_ceiling_us(row["kernel_bytes"],
                                                     dev, reps, flush)
    else:
        row["us_plain_host"] = host_us(plain, reps)
    _rate(row)
    return row


def rows(device=None, seed: int = 0, reps: int = 20) -> List[dict]:
    """The bench's rows on ``device`` (cuda by default; ``"cpu"`` runs the
    plain versions alone at small n, and no full-width row)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        set_full_precision()
        KU.build()                       # raises if the kernels do not build
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = l2_flush(dev) if on_card else None
    out = []
    for n in (SMALL_N if on_card else CPU_N):
        for kernel in ("exact", "expsum"):
            fused, unfused = (traffic_model(n, T=T_SLOTS) if kernel == "exact"
                              else traffic_model(n, K=K_ACC))
            jax = [f"frodo_{kernel}_jnp_n{n}",
                   f"frodo_{kernel}_pallas_n{n}(interp)"]
            row = _case(f"frodo_{kernel}_n{n}", kernel, (n,), torch.float32,
                        torch.float32, jax, dev, gen, reps, flush)
            row["traffic_model_bytes"] = {"fused": fused, "unfused": unfused}
            out.append(row)
    if on_card:
        for label, arch, leaf, acc_dtype in FULL_WIDTH:
            shape = full_width_shape(arch)
            for kernel, state in (("exact", torch.bfloat16),
                                  ("expsum", acc_dtype)):
                row = _case(f"frodo_{kernel}_{label}", kernel, shape,
                            torch.bfloat16, state, [], dev, gen,
                            max(3, reps // 4), flush)
                row.update(arch=arch, leaf=leaf)
                out.append(row)
                torch.cuda.empty_cache()
    return out


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(prog="python -m "
                                 "repro_torch.experiments.kernel_bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions alone)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    for r in rows(args.device, args.seed, args.reps):
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
