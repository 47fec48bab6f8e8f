"""The card script's ``fsdp`` phase (``chip_smoke.fsdp_phase``) from two
trees of this repo in turns on one card: a parent commit's and this one,
each run in a process of its own (parent, change, change, parent), so
that the two are compared within one call on one card.

    git archive <parent commit> | tar -x -C build/parent
    python3 tools/fsdp_phase_pair.py --parent build/parent [--out DIR]

Each run builds the kernels of its own tree and prints one JSON line: the
phase's seconds (one process; ranks), rank 0's ms a step, loss against one
process and worst shard of each train run, its launches, and each planted
fault's result on every rank.  A run's whole output goes to ``--out``.
Needs a CUDA card.  Each run's temporary files (the phase's one-process
references: whole parameters, ~10 GB) go to a directory of its own under
``--out``, removed when the run ends.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: one phase run from the tree given as the first argument
RUNNER = """
import os, sys, time
root = os.path.abspath(sys.argv[1])
sys.path[:0] = [root, os.path.join(root, "src")]
import torch
import chip_smoke as CS
from repro_torch.device import set_full_precision
from repro_torch.kernels import frodo_update as KU

set_full_precision()
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
KU.build()
try:
    CS.fsdp_phase(dev)
finally:
    CS.stop_children()
"""


def summary(i: int, name: str, p: subprocess.CompletedProcess,
            wall: float) -> dict:
    out = {"run": i, "tree": name, "rc": p.returncode,
           "wall_s": round(wall, 1)}
    phase = None
    for line in p.stdout.splitlines():
        if line.startswith('{"phase": "fsdp"'):
            phase = json.loads(line)
    if phase is None:
        out["stderr_tail"] = p.stderr[-2500:]
        return out
    ranks = phase["per_rank"]
    r0 = ranks[0]
    out.update(
        phase_seconds=phase["seconds"],
        one_process_seconds=phase["one_process_seconds"],
        ranks_seconds=phase["ranks_seconds"],
        nvidia_smi=phase["nvidia_smi"],
        rank0={k: {"ms": r0[k]["ms_per_step"],
                   "loss_diff": r0[k]["max_abs_loss_diff"],
                   "worst": r0[k]["param_worst_leaves"][:1],
                   "launches": r0[k]["launches"]}
               for k in ("moe", "moe_exact", "dense")},
        planted={k: [r["planted"][k]["passes_the_check"] for r in ranks]
                 for k in r0["planted"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the parent commit's tree (a git archive)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "fsdp_phase_pair"),
                    help="the runs' whole output")
    args = ap.parse_args(argv)
    args.out = os.path.abspath(args.out)     # each run's TMPDIR, any cwd
    os.makedirs(args.out, exist_ok=True)
    trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
    rc = 0
    for i, name in enumerate(("parent", "change", "change", "parent")):
        tree = trees[name]
        tmp = os.path.join(args.out, f"{i}_{name}.tmp")
        os.makedirs(tmp, exist_ok=True)
        t0 = time.time()
        try:
            p = subprocess.run([sys.executable, "-c", RUNNER, tree],
                               cwd=tree, capture_output=True, text=True,
                               env=dict(os.environ, TMPDIR=tmp))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        wall = time.time() - t0
        with open(os.path.join(args.out, f"{i}_{name}.log"), "w") as f:
            f.write(p.stdout + "\n--- stderr ---\n" + p.stderr)
        print(json.dumps(summary(i, name, p, wall)), flush=True)
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
