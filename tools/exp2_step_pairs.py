#!/usr/bin/env python3
"""Exp 2 ms/step of two source trees of the port, in pairs on one card.

    python3 tools/exp2_step_pairs.py OLD_TREE NEW_TREE [--pairs 4]

Each run is a process of its own with ``TREE/src`` on its path.  It trains
Exp 2 at full width (2 agents, MLP 784-1024-128-10, batch 64, FrODO exact
memory T = 80 through the exact kernel) for 40 steps on the host clock,
ending in a device sync: one warm-up run, then the median of 3, as the
timing phase of ``chip_smoke.py`` does.  The runs go old, new, new, old
in each pair.  The script prints one JSON line per run, then one line with
the median, least and largest ms/step of each tree.  It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import json, statistics, torch
from repro_torch.core import graph as G
from repro_torch.data.synthetic import make_classification
from repro_torch.device import set_full_precision
from repro_torch.experiments import exp2_federated as E

set_full_precision()
dev = torch.device("cuda", 0)
X, y = make_classification(n_per_class=200, n_agents=E.N_AGENTS, seed=0,
                           noise=2.0)
W = G.xiao_boyd_weights(G.complete(E.N_AGENTS))
idx = E.batch_indices(0, 40, y.shape[1])
X, y, idx = (torch.as_tensor(X, device=dev),
             torch.as_tensor(y, dtype=torch.int64, device=dev),
             torch.as_tensor(idx, dtype=torch.int64, device=dev))
p0 = E.init_mlp(torch.Generator().manual_seed(0), device=dev)

def run():
    return E.train(E.make_optimizer("frodo"), p0, X, y, idx, W,
                   device=dev)["step_time_ms"]

run()
print(json.dumps({"ms_per_step": statistics.median(run() for _ in range(3))}))
"""


def one_run(tree: str) -> float:
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.abspath(tree),
                                                   "src"))
    out = subprocess.run([sys.executable, "-c", CHILD], env=env, check=True,
                         capture_output=True, text=True, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])["ms_per_step"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--pairs", type=int, default=4)
    args = ap.parse_args()
    got = {"old": [], "new": []}
    for i in range(args.pairs):
        for side in ("old", "new", "new", "old"):
            ms = one_run(getattr(args, side))
            got[side].append(ms)
            print(json.dumps({"pair": i, "tree": side, "ms_per_step": ms}),
                  flush=True)
    print(json.dumps({side: {"tree": getattr(args, side), "runs": len(v),
                             "median": statistics.median(v), "min": min(v),
                             "max": max(v)} for side, v in got.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
