#!/usr/bin/env python3
"""kimi-k2-1t-a32b's serving (``chip_smoke.serve_late_phase``) alone on one
card, then the ``distributed`` and ``tensor_parallel`` phases, with the
card's memory (``nvidia-smi``'s ``memory.used``, every process's) sampled
every 0.5 s: how much of the card each holds at its peak, so as to know
whether kimi-k2 fits beside them.

    python3 tools/kimi_memory_probe.py

Every check's failure is printed and counted instead of raised (a
reading prints whatever it is).  It prints the card's name and power
limit first, a ``probe.mem_max_mib`` line with the largest sample between
each pair of marks (``kimi_start``, ``kimi_end``, ``dist_start``,
``tp_start``, ``tp_end``), and ``probe.failed`` last; the samples go to
``chiprun_out/probe_mem.csv``.  Exits 1 if a check failed.
"""
import datetime
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as C  # noqa: E402

FAILED = []
STAMP = "%Y/%m/%d %H:%M:%S.%f"      # nvidia-smi's timestamp, in local time


def lenient(cond, msg):
    if not cond:
        FAILED.append(msg)
        print(json.dumps({"phase": "probe.check_failed", "msg": msg[:3000]}),
              flush=True)


# the ranks of the distributed phases re-import this file: patch there too
C.check = lenient


def main() -> int:
    import torch
    from repro_torch.device import set_full_precision
    from repro_torch.kernels import frodo_update as KU

    set_full_precision()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(C.nvidia_smi(), flush=True)
    KU.build()
    out = os.path.join(C.ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "probe_mem.csv")
    marks = []

    def mark(name):
        marks.append((name, datetime.datetime.now().strftime(STAMP)))
        print(json.dumps({"phase": "probe.mark", "name": name,
                          "at": marks[-1][1]}), flush=True)

    def timed(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        print(json.dumps({"phase": f"probe.{name}_seconds",
                          "s": time.perf_counter() - t}), flush=True)
        return res

    with open(path, "w") as mem:
        poll = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=timestamp,memory.used",
             "--format=csv,noheader", "-lms", "500"], stdout=mem)
        try:
            mark("kimi_start")
            timed("kimi", C.serve_late_phase, dev)
            torch.cuda.empty_cache()
            mark("kimi_end")
            time.sleep(2)
            mark("dist_start")
            dist = timed("dist", C.distributed_phase, dev)
            mark("tp_start")
            timed("tp", C.tensor_parallel_phase, dev, dist["ref_dir"])
            mark("tp_end")
        finally:
            time.sleep(1)
            poll.terminate()
            poll.wait(10)
            C.stop_children()
    rows = []
    with open(path) as f:
        for line in f:
            parts = [p.strip() for p in line.split(",")]
            if len(parts) == 2 and parts[1].endswith("MiB"):
                rows.append((parts[0], int(parts[1].split()[0])))
    windows = {}
    for (a, ta), (b, tb) in zip(marks, marks[1:]):
        vals = [m for ts, m in rows if ta <= ts <= tb]
        windows[f"{a}..{b}"] = max(vals) if vals else None
    print(json.dumps({"phase": "probe.mem_max_mib", "windows": windows,
                      "samples": len(rows)}), flush=True)
    print(json.dumps({"phase": "probe.failed", "n": len(FAILED),
                      "msgs": [m[:500] for m in FAILED]}), flush=True)
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
