#!/usr/bin/env python3
"""The FrODO update kernels of this tree beside a parent tree's, on one card.

    python3 tools/frodo_kernels_pair.py --parent build/parent [--out FILE]

``--parent`` is an unpacked source tree of the port (``git archive <commit>
| tar -x -C build/parent``); its ``kernels/frodo_update.py`` is loaded under
another name and builds its own source into its own ``build/`` directory.
The exp-sum cases are Exp 2's ``w0`` leaf in f32 and h2o-danube-1.8b's
``mlp/up`` leaf, qwen3-moe-30b-a3b's ``experts/gate`` leaf and
recurrentgemma-9b's tied embedding at the trainers' cuts (bf16 gradients,
the accumulators in the dtype each trainer keeps); the exact case is Exp
2's ``w0`` at T = 80.  At each the script

* holds this tree's kernel against the plain version (``kernels.ref``, in
  slices of ``kernel_bench.CHECK_CHUNK`` elements): the new state (the
  accumulators, the pushed history) bit-equal, the delta within
  ``kernel_bench.DELTA_TOL``;
* times both kernels in turns (parent, this tree, this tree, parent) by
  CUDA events around one wrapper call (after an L2 flush, and with nothing
  queued before it, which puts the host's launch path on the clock) and by
  device time (calls queued behind a spin kernel, L2 overwritten before
  each), as ``kernel_bench`` does;
* gives the bound (the bytes each input read once and each output written
  once, over 3.35 TB/s) and, for exp-sum, the copy ceiling: the events time
  of one ``Tensor.copy_`` that reads and writes as many bytes as the kernel
  (half of its bytes each way), after the case's tensors are freed.

Two more rows weigh pieces of this tree's host side: ``host_path_packing``
times Exp 2's ``w0`` exp-sum call by CUDA events back to back as shipped
(the rates and coefficients packed once, ``frodo_update._packed``) and
with them packed anew into one preallocated ``ExpsumWeights`` on every
call, in turns (shipped, per call, per call, shipped); ``build`` times a
cold build as shipped (``UNITS`` nvcc runs side by side, then a link) and
one nvcc run of the whole source into the library.

One JSON line per case on stdout (and in ``--out``).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.core import memory as fmem  # noqa: E402
from repro_torch.device import set_full_precision  # noqa: E402
from repro_torch.experiments import kernel_bench as KB  # noqa: E402
from repro_torch.kernels import frodo_update as KU  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

T_FIT = 90              # the trainers' T; Exp 2's is 80


def cases() -> list:
    """(label, leaf shape, K, g dtype, acc dtype, T of the fit); K None is
    the exact kernel at T slots."""
    bf16, f32 = torch.bfloat16, torch.float32
    rg = REG.get_config("recurrentgemma-9b")
    return [
        ("exact_exp2_w0", (2, 784, 1024), None, f32, f32, 80),
        ("exp2_w0", (2, 784, 1024), 8, f32, f32, 80),
        ("h2o_mlp_up", KB.full_width_shape("h2o-danube-1.8b"), 8, bf16, f32,
         T_FIT),
        ("qwen3moe_experts_gate", KB.full_width_shape("qwen3-moe-30b-a3b"), 8,
         bf16, bf16, T_FIT),
        ("recurrentgemma_embed_k4", (2, rg.vocab, rg.d_model), 4, bf16, bf16,
         T_FIT),
    ]


def load_parent(tree: str):
    path = os.path.join(tree, "src", "repro_torch", "kernels",
                        "frodo_update.py")
    spec = importlib.util.spec_from_file_location("parent_frodo_update", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plain_in_slices(g, acc, rates, coeffs):
    """The plain version's delta, advancing ``acc`` in place, in slices."""
    K, n = acc.shape[0], g.numel()
    g_f, a_f = g.view(-1), acc.view(K, -1)
    d = torch.empty_like(g_f)
    for i in range(0, n, KB.CHECK_CHUNK):
        j = min(n, i + KB.CHECK_CHUNK)
        d[i:j], _ = ref.frodo_expsum_update_ref(
            g_f[i:j], a_f[:, i:j], rates, coeffs, KB.ALPHA, KB.BETA)
    return d.view(g.shape)


def pair_times(old, new, reps, flush) -> dict:
    """us of each, in turns (old, new, new, old): ``events_us`` around one
    call after an L2 flush (the flush hides the host's launch path),
    ``events_back_to_back_us`` around one call with nothing queued before
    it (the host's launch path included, as ``chip_smoke.py``'s timing
    rows), ``device_us`` behind a spin kernel."""
    keys = ("events_us", "events_back_to_back_us", "device_us")
    times = {who: {k: [] for k in keys} for who in ("parent", "change")}
    for who, fn in (("parent", old), ("change", new), ("change", new),
                    ("parent", old)):
        t = times[who]
        t["events_us"].append(KB.cuda_us(fn, reps, flush=flush))
        t["events_back_to_back_us"].append(KB.cuda_us(fn, reps))
        t["device_us"].append(KB.device_us(fn, reps, flush))
    return times


def run_exact(label, shape, T, parent, dev, gen, flush, reps) -> dict:
    g = KB._randn(shape, torch.float32, dev, gen)
    hist = KB._randn((T,) + tuple(shape), torch.float32, dev, gen)
    mu = torch.tensor(fmem.mu_weights(T, 0.15), dtype=torch.float32,
                      device=dev)
    n, cursor = g.numel(), 5
    h_p = hist.clone()
    d_plain, _ = ref.frodo_update_ref(g, h_p, cursor, mu, KB.ALPHA, KB.BETA)
    d_kern = KU.exact_update(g, hist, cursor, mu, KB.ALPHA, KB.BETA)
    torch.cuda.synchronize()
    diff = KB.delta_diff(d_kern, d_plain, KB.DELTA_TOL["float32"])
    same = KB.bit_equal(hist, h_p)
    del h_p, d_plain, d_kern
    times = pair_times(
        lambda: parent.exact_update(g, hist, cursor, mu, KB.ALPHA, KB.BETA),
        lambda: KU.exact_update(g, hist, cursor, mu, KB.ALPHA, KB.BETA),
        reps, flush)
    nbytes = KB.exact_bytes(n, T, 4)
    return {"case": label, "shape": [T] + list(shape), "T": T,
            "bytes": nbytes, "state": "bit-equal" if same else "differs",
            "delta_max_abs_err": diff["max_abs_err"],
            "delta_passes": diff["passes"], **times,
            "bound_us": nbytes / KB.HBM_BYTES_PER_S * 1e6,
            "device": torch.cuda.get_device_name(dev)}


def run_case(label, shape, K, gdt, adt, T, parent, dev, gen, flush,
             reps) -> dict:
    if K is None:
        return run_exact(label, shape, T, parent, dev, gen, flush, reps)
    rates_np, coeffs_np = fmem.fit_expsum(T, 0.15, K)
    rates = torch.tensor(rates_np, dtype=torch.float32)
    coeffs = torch.tensor(coeffs_np, dtype=torch.float32)
    g = KB._randn(shape, gdt, dev, gen)
    acc = KB._randn((K,) + tuple(shape), adt, dev, gen)
    n = g.numel()
    nbytes = KB.expsum_bytes(n, K, g.element_size(), acc.element_size())

    state_plain = acc.clone()
    d_plain = plain_in_slices(g, state_plain, rates, coeffs)
    d_kern = KU.expsum_update(g, acc, rates, coeffs, KB.ALPHA, KB.BETA)
    torch.cuda.synchronize()
    tol = KB.DELTA_TOL[str(gdt).replace("torch.", "")]
    diff = KB.delta_diff(d_kern, d_plain, tol)
    same = KB.bit_equal(acc, state_plain)
    del state_plain, d_plain, d_kern
    torch.cuda.empty_cache()
    times = pair_times(
        lambda: parent.expsum_update(g, acc, rates, coeffs, KB.ALPHA,
                                     KB.BETA),
        lambda: KU.expsum_update(g, acc, rates, coeffs, KB.ALPHA, KB.BETA),
        reps, flush)
    del g, acc
    torch.cuda.empty_cache()
    copy_us = KB.copy_ceiling_us(nbytes, dev, reps, flush)
    torch.cuda.empty_cache()
    return {"case": label, "shape": [K] + list(shape), "K": K,
            "g_dtype": str(gdt).replace("torch.", ""),
            "acc_dtype": str(adt).replace("torch.", ""), "bytes": nbytes,
            "state": "bit-equal" if same else "differs",
            "delta_max_abs_err": diff["max_abs_err"],
            "delta_share_differing": diff["share_differing"],
            "delta_passes": diff["passes"], **times,
            "bound_us": nbytes / KB.HBM_BYTES_PER_S * 1e6,
            "copy_ceiling_us": copy_us,
            "device": torch.cuda.get_device_name(dev)}


def host_path_packing(dev, gen, reps) -> dict:
    """Exp 2's ``w0`` exp-sum call, back to back, with the weights packed
    once (as shipped) and packed on every call into one struct."""
    rates_np, coeffs_np = fmem.fit_expsum(80, 0.15, 8)
    rates = torch.tensor(rates_np, dtype=torch.float32)
    coeffs = torch.tensor(coeffs_np, dtype=torch.float32)
    g = KB._randn((2, 784, 1024), torch.float32, dev, gen)
    acc = KB._randn((8, 2, 784, 1024), torch.float32, dev, gen)
    scratch = KU.ExpsumWeights()

    def per_call(r, c):
        k = r.shape[0]
        scratch.r[:k] = r.float().tolist()
        scratch.c[:k] = c.float().tolist()
        return scratch

    def call():
        KU.expsum_update(g, acc, rates, coeffs, KB.ALPHA, KB.BETA)

    shipped = KU._packed
    times = {"shipped": [], "per_call": []}
    try:
        for who in ("shipped", "per_call", "per_call", "shipped"):
            KU._packed = shipped if who == "shipped" else per_call
            times[who].append(KB.cuda_us(call, reps))
    finally:
        KU._packed = shipped
    return {"case": "host_path_packing", "shape": [8, 2, 784, 1024],
            "reps": reps, "events_back_to_back_us": times,
            "device": torch.cuda.get_device_name(dev)}


def build_times() -> dict:
    """Seconds of a cold build as shipped and of one nvcc run of the
    whole source, each into a directory of its own."""
    with tempfile.TemporaryDirectory(prefix="frodo_build_") as d:
        shipped_dir = KU.BUILD_DIR
        KU.BUILD_DIR = Path(d) / "units"
        try:
            units_s = KU.build()["seconds"]
        finally:
            KU.BUILD_DIR = shipped_dir
        cmd = [KU._nvcc(), *KU.NVCC_FLAGS, "-shared", "-o",
               os.path.join(d, "one.so"), str(KU.SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        one_s = time.perf_counter() - t0
    return {"case": "build", "units": KU.UNITS, "units_s": units_s,
            "one_object_s": one_s, "one_object_rc": proc.returncode}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default="")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", nargs="*", default=None,
                    help="case labels to run (default all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("frodo_kernels_pair: needs a CUDA card", file=sys.stderr)
        return 1
    set_full_precision()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    parent = load_parent(args.parent)
    parent.build()
    KU.build()
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = KB.l2_flush(dev)
    ok = True
    out = open(args.out, "w") if args.out else None

    def put(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for case in cases():
        if args.only and case[0] not in args.only:
            continue
        row = run_case(*case, parent, dev, gen, flush, args.reps)
        ok = ok and row["state"] == "bit-equal" and row["delta_passes"]
        put(row)
    if not args.only or "host_path_packing" in args.only:
        put(host_path_packing(dev, gen, 20 * args.reps))
    if not args.only or "build" in args.only:
        row = build_times()
        ok = ok and row["one_object_rc"] == 0
        put(row)
    if out:
        out.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
