#!/usr/bin/env python3
"""The consensus all-reduce of two ranks that share one card over gloo, three
ways, on one card.

    python3 tools/gloo_allreduce_bench.py [--layers 2] [--reps 3]

Each of two spawned ranks holds the f32 sums that ``mix_uniform_constrained``
all-reduces in one step of the ``distributed`` phase of ``chip_smoke.py``:
one agent's h2o-danube-1.8b tree at full width and ``--layers`` layers, a
tensor per leaf on the card.  Each way is timed over one step's leaves on
the host clock, between device syncs, after one warm-up step:

* ``gloo_cuda``: ``all_reduce`` of the CUDA tensors (gloo's own CUDA path);
* ``gloo_cuda_async``: the same, every leaf's started (``async_op``)
  before the first is waited on;
* ``staged_pinned``: each leaf copied into one pinned host buffer made
  once, ``all_reduce`` there, copied back;
* ``host_only``: the ``all_reduce`` of the pinned host buffers alone (the
  transport), and ``host_async`` with every leaf's started at once.

Rank 0 prints one JSON line per way and rep (ms, GB/s of one rank's
bytes), then one line with the median of each way.  It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def _rank(rank: int, world: int, n_layers: int, reps: int) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch import tree as TR
    from repro_torch.configs import registry as REG
    from repro_torch.models import transformer as TM

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = REG.get_config("h2o-danube-1.8b").replace(n_layers=n_layers)
    shapes = [tuple(t.shape) for t in TR.leaves(TM.init_params(
        torch.Generator(), cfg, (), device="meta"))]
    dev_t = [torch.full(s, float(rank + 1), device=dev) for s in shapes]
    host = [torch.empty(s, pin_memory=True) for s in shapes]
    nbytes = sum(t.numel() * 4 for t in dev_t)

    def gloo_cuda():
        for t in dev_t:
            dist.all_reduce(t)

    def gloo_cuda_async():
        for w in [dist.all_reduce(t, async_op=True) for t in dev_t]:
            w.wait()

    def host_async():
        for w in [dist.all_reduce(h, async_op=True) for h in host]:
            w.wait()

    def staged_pinned():
        for t, h in zip(dev_t, host):
            h.copy_(t, non_blocking=True)
            torch.cuda.synchronize(dev)
            dist.all_reduce(h)
            t.copy_(h, non_blocking=True)

    def host_only():
        for h in host:
            dist.all_reduce(h)

    out = {}
    for name, fn in (("gloo_cuda", gloo_cuda),
                     ("gloo_cuda_async", gloo_cuda_async),
                     ("staged_pinned", staged_pinned),
                     ("host_only", host_only), ("host_async", host_async)):
        times = []
        for rep in range(reps + 1):
            torch.cuda.synchronize(dev)
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
            if rank == 0:
                print(json.dumps({"way": name, "rep": rep, "warm_up": rep == 0,
                                  "ms": ms, "bytes": nbytes,
                                  "GB_per_s": nbytes / ms / 1e6}),
                      flush=True)
            if rep:
                times.append(ms)
        out[name] = statistics.median(times)
    if rank == 0:
        print(json.dumps({"median_ms": out, "bytes": nbytes,
                          "leaves": len(shapes), "layers": n_layers,
                          "device": torch.cuda.get_device_name(dev)}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gloo_allreduce_bench: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.distributed import comm
    comm.spawn(_rank, 2, args.layers, args.reps, backend="gloo")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
