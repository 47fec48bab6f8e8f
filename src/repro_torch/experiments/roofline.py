"""Roofline of NVIDIA H100s per (arch x shape x mesh), from the port's
dry-run records (``repro_torch.launch.dryrun``, in
``experiments/dryrun_torch``): the port of the JAX package's
``benchmarks/roofline.py``.

    compute term = exec_FLOPs / (cards * peak_FLOPs)                  [s]
    memory term  = HBM_bytes  / (cards * HBM_bw)                      [s]
    link term    = collective_effective_bytes_per_device / LINK_BW    [s]

Constants: NVIDIA's H100 SXM5 data sheet, dense bf16 without sparsity,
for the card ``nvidia-smi`` names ``NVIDIA H100 80GB HBM3`` at its full
power limit of 700 W (a card set lower runs slower under load: every
table names the card and limit it was written for).  The FLOPs are the
closed-form counts of ``repro_torch.utils.flops``, and so are the bytes
(``analytic.hbm_bytes``): the port runs eagerly and has no compiler cost
analysis to read, where the JAX roofline takes the larger of the two.
Memory per card is the dry-run's argument bytes (parameters, gradients,
optimizer state, batch or cache), or the probe's extrapolated peak where
that is larger.

The link term is the counterpart of the JAX roofline's one link figure:
the collective bytes a device moves per step (the dry-run's count of the
tensor-parallel step's collectives, extrapolated affine in depth, times
the ring factors) over ``LINK_BW``, NVLink 4's 450 GB/s in one direction
(NVIDIA's H100 SXM5 data sheet: 900 GB/s bidirectional).  That rate holds
within one 8-card NVLink node; the production meshes' model axis of 16
spans two nodes and crosses InfiniBand, far slower, so there the term is
a lower bound.  A one-card record moves nothing over a link (0); a mesh
record without a collective record (the families and rules that do not
run tensor-parallel yet) has no link term, and its bound is the larger of
the other two.

    PYTHONPATH=src python -m repro_torch.experiments.roofline \\
        --dir experiments/dryrun_torch --out experiments/roofline_torch.md
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional, Sequence

PEAK_FLOPS = 989.4e12        # dense bf16, H100 SXM5
HBM_BW = 3.35e12             # bytes/s, HBM3
HBM_PER_CARD = 80e9          # bytes
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
LINK_BW = 450e9               # bytes/s, NVLink 4, one direction
CHIPS = {"1xH100": 1, "16x16": 256, "2x16x16": 512}
LINK_NOTE = (f"link term: collective bytes per card / "
             f"{LINK_BW / 1e9:.0f} GB/s NVLink 4 (a lower bound where the "
             f"16-wide model axis crosses InfiniBand; 0 on one card; n/a "
             f"without a collective record)")


def load_records(dirpath: str = "experiments/dryrun_torch") -> List[Dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def mem_per_card_bytes(rec: Dict) -> float:
    """The dry-run's argument bytes, or the probe's extrapolated peak where
    that is larger."""
    mem = float(rec["memory"]["argument_size_in_bytes"])
    peak = (rec.get("extrapolated") or {}).get("peak_bytes")
    return max(mem, float(peak)) if peak is not None else mem


def link_term(rec: Dict) -> Optional[float]:
    """Seconds a step's collectives take over NVLink at ``LINK_BW``: 0 for
    a one-card record, None for a mesh record without a collective
    record."""
    if rec["mesh"] == "1xH100":
        return 0.0
    if not rec.get("collectives"):
        return None
    ext = rec.get("extrapolated") or {}
    return ext.get("collective_effective_bytes_per_device",
                   rec["collectives"]["effective_bytes_per_device"]) / LINK_BW


def roofline_terms(rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "ok" or rec["mesh"] not in CHIPS:
        return None
    chips = CHIPS[rec["mesh"]]
    ana = rec.get("analytic", {})
    exec_flops = ana.get("exec_flops", 0.0)
    model_flops = ana.get("model_flops", 0.0)
    hbm_bytes = ana.get("hbm_bytes", 0.0)

    t_compute = exec_flops / (chips * PEAK_FLOPS)
    t_memory = hbm_bytes / (chips * HBM_BW)
    t_link = link_term(rec)
    terms = [("compute", t_compute), ("memory", t_memory)]
    if t_link is not None:
        terms.append(("link", t_link))
    dominant = max(terms, key=lambda kv: kv[1])[0]
    mem_dev = mem_per_card_bytes(rec)
    bound = max(t for _, t in terms)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "kind": rec["kind"],
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_link_s": t_link, "dominant": dominant,
        "model_flops": model_flops, "exec_flops": exec_flops,
        "useful_ratio": model_flops / exec_flops if exec_flops else 0.0,
        "mem_per_dev_gib": mem_dev / 2 ** 30,
        "fits_hbm": mem_dev <= HBM_PER_CARD,
        "step_time_bound_s": bound,
        "mfu_bound": (model_flops / (bound * chips * PEAK_FLOPS)
                      if bound > 0 else 0.0),
        "probe_device_ms": (rec.get("extrapolated") or {}).get("device_ms"),
    }


_SUGGEST = {
    ("compute", "train"): "raise per-card utilization: larger microbatch, "
        "fuse attention chain, drop remat recompute on cheap ops",
    ("memory", "train"): "cut activation traffic: longer fused chains, "
        "bf16 accumulators, microbatch balance",
    ("compute", "decode"): "decode is tiny-matmul bound: batch requests or "
        "quantize weights",
    ("memory", "decode"): "weight+cache streaming bound: quantize KV cache, "
        "MLA-style compression",
    ("memory", "prefill"): "chunked prefill with cache writes fused",
    ("compute", "prefill"): "near-roofline already; check attention skip",
}


def one_liner(t: Dict) -> str:
    return _SUGGEST.get((t["dominant"], t["kind"]), "rebalance the step")


def markdown_table(terms: List[Dict], card: str = CARD) -> str:
    hdr = (f"Card: {card} (peaks: {PEAK_FLOPS / 1e12:.1f} TFLOP/s dense "
           f"bf16, {HBM_BW / 1e12:.2f} TB/s HBM, {HBM_PER_CARD / 1e9:.0f} GB)"
           f"; {LINK_NOTE}.\n\n"
           "| arch | shape | mesh | compute s | memory s | link s | "
           "dominant | useful 6ND/exec | mem/card GiB | fits | MFU bound |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for t in terms:
        rows.append(
            f"| {t['arch']} | {t['shape']} | {t['mesh']} "
            f"| {t['t_compute_s']:.3e} | {t['t_memory_s']:.3e} "
            f"| {'n/a' if t['t_link_s'] is None else format(t['t_link_s'], '.3e')} "
            f"| **{t['dominant']}** "
            f"| {t['useful_ratio']:.2f} | {t['mem_per_dev_gib']:.1f} "
            f"| {'y' if t['fits_hbm'] else 'N'} | {t['mfu_bound']:.2f} |")
    return hdr + "\n".join(rows)


def report(recs: List[Dict], card: str = CARD) -> str:
    """The table, a line per pair, and the skipped and failed pairs."""
    terms = [t for t in (roofline_terms(r) for r in recs) if t]
    lines = [markdown_table(terms, card), ""]
    for t in terms:
        lines.append(f"- {t['arch']} x {t['shape']} x {t['mesh']}: "
                     f"{t['dominant']}-bound -> {one_liner(t)}")
    for r in recs:
        if r.get("status") == "skipped":
            lines.append(f"- SKIPPED {r['arch']} x {r['shape']}: "
                         f"{r['reason']}")
        elif r.get("status") == "error":
            lines.append(f"- ERROR {r['arch']} x {r['shape']} x "
                         f"{r['mesh']}: {r.get('error', '')[:200]}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--out", default="experiments/roofline_torch.md")
    ap.add_argument("--card", default=CARD,
                    help="the card and power limit the table is for, as "
                         "nvidia-smi --query-gpu=name,power.limit gives "
                         "them")
    args = ap.parse_args(argv)
    out = report(load_records(args.dir), args.card)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(out)
    print(out)
    return out


if __name__ == "__main__":
    main()
