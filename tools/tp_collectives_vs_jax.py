"""The port's tensor-parallel collectives a step beside the JAX package's,
for the families that run over the "model" axis, at their smoke configs on
a (data 1, model 2) mesh, and for two fsdp configs' train steps on a
(data 2, model 2) mesh (the batch and fsdp rules over "data"; qwen3-32b's
also at two microbatches); and the dry-run's link term for one production
record of each family and for the fsdp configs' train records.

    PYTHONPATH=src python tools/tp_collectives_vs_jax.py [--out FILE]

The port's side is ``repro_torch.launch.dryrun.count_collectives`` on
``meta`` tensors in a two-rank (four-rank) ``fake`` world (the calls and
bytes each rank would issue).  The JAX side lowers and compiles the same
unit with ``repro.launch.dryrun.lower_train``/``lower_decode`` on two
(four) forced host CPU devices and reads the partitioned HLO's collectives
(``parse_collectives``), with the layer scan unrolled so that every
layer's collectives appear.  It runs in a subprocess on the CPU.

The qwen3-32b fsdp row at two microbatches (``MB_ROW``: 4 rows, one a data
rank in each microbatch) counts the port's step as it runs: every
microbatch's collectives and the rows' exchange.  The JAX step
accumulates its microbatches in a ``lax.scan``, which stays a ``while``
loop in the partitioned HLO (only the layer scan is unrolled): the HLO
text holds the loop body once, so the JAX side counts one microbatch's
collectives plus the once-a-step ones.
"""
import argparse
import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

ARCHS = ("h2o-danube-1.8b", "phi-3-vision-4.2b", "minicpm3-4b",
         "qwen3-moe-30b-a3b", "whisper-tiny", "mamba2-780m",
         "recurrentgemma-9b")
#: (name, seq, global batch, kind) of the smoke-size units
UNITS = (("smoke_train", 32, 2, "train"), ("smoke_decode", 64, 2, "decode"))
#: one production record of each family (16x16), as the dry-run makes it
RECORDS = {"h2o-danube-1.8b": "train_4k", "phi-3-vision-4.2b": "train_4k",
           "minicpm3-4b": "train_4k", "qwen3-moe-30b-a3b": "prefill_32k",
           "whisper-tiny": "train_4k", "mamba2-780m": "train_4k",
           "recurrentgemma-9b": "prefill_32k"}
#: fsdp configs whose smoke train step runs on (data 2, model 2)
FSDP_ARCHS = ("qwen3-32b", "qwen3-moe-30b-a3b")
#: an fsdp config's smoke train step at two microbatches on (data 2,
#: model 2): (arch, global batch, microbatches)
MB_ROW = ("qwen3-32b", 4, 2)
#: the fsdp configs' production train records (16x16)
FSDP_RECORDS = ("qwen3-32b", "nemotron-4-15b", "qwen3-moe-30b-a3b",
                "recurrentgemma-9b", "kimi-k2-1t-a32b")

JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from repro.configs import registry as REG
    from repro.configs.base import InputShape
    from repro.launch import dryrun as DR
    from repro.training import train_step as TS

    archs, units, fsdp, mb_row = map(json.loads, sys.argv[1:5])
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    mesh4 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                 ("data", "model"))
    out = {}
    for arch in archs:
        cfg = REG.get_smoke_config(arch).replace(unroll_scan=True)
        for name, seq, batch, kind in units:
            shape = InputShape(name, seq, batch, kind)
            if kind == "train":
                low, _ = DR.lower_train(cfg, shape, mesh, False,
                                        TS.TrainConfig())
            else:
                low, _ = DR.lower_decode(cfg, shape, mesh, False)
            out[arch + "|" + name] = DR.parse_collectives(
                low.compile().as_text())
    for arch in fsdp:
        cfg = REG.get_smoke_config(arch).replace(unroll_scan=True)
        name, seq, batch, kind = units[0]
        low, _ = DR.lower_train(cfg, InputShape(name, seq, batch, kind),
                                mesh4, False, TS.TrainConfig())
        out[arch + "|" + name + "|d2m2"] = DR.parse_collectives(
            low.compile().as_text())
    arch, batch, m = mb_row
    cfg = REG.get_smoke_config(arch).replace(unroll_scan=True)
    name, seq, _, kind = units[0]
    low, _ = DR.lower_train(cfg, InputShape(name, seq, batch, kind), mesh4,
                            False, TS.TrainConfig(microbatches=m))
    out["%s|%s|d2m2|mb%d" % (arch, name, m)] = DR.parse_collectives(
        low.compile().as_text())
    print(json.dumps(out))
""")


def port_counts() -> dict:
    import dataclasses

    from repro_torch.configs import registry as REG
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as ML

    tc = dataclasses.replace(DR.TRAIN_CONFIG, use_kernel=False,
                             microbatches=1)
    out = {}
    with ML.fake_world(2):
        mesh = ML.make_host_mesh(2)
        for arch in ARCHS:
            cfg = REG.get_smoke_config(arch)
            for name, seq, batch, kind in UNITS:
                out[f"{arch}|{name}"] = DR.count_collectives(
                    cfg, InputShape(name, seq, batch, kind), mesh, False, tc)
    with ML.fake_world(4):
        mesh = ML.make_host_mesh(2)
        name, seq, batch, kind = UNITS[0]
        for arch in FSDP_ARCHS:
            out[f"{arch}|{name}|d2m2"] = DR.count_collectives(
                REG.get_smoke_config(arch),
                InputShape(name, seq, batch, kind), mesh, False, tc)
        arch, batch, m = MB_ROW
        out[f"{arch}|{name}|d2m2|mb{m}"] = DR.count_collectives(
            REG.get_smoke_config(arch), InputShape(name, seq, batch, kind),
            mesh, False, dataclasses.replace(tc, microbatches=m))
    return out


def jax_counts() -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT,
                          json.dumps(ARCHS), json.dumps(UNITS),
                          json.dumps(FSDP_ARCHS), json.dumps(MB_ROW)],
                         env=env,
                         capture_output=True, text=True, timeout=1800)
    if res.returncode:
        raise RuntimeError(res.stderr[-3000:])
    return json.loads(res.stdout.strip().splitlines()[-1])


def link_terms() -> dict:
    from repro_torch.experiments import roofline as RF
    from repro_torch.launch import dryrun as DR

    out = {}
    for arch, shape in (*RECORDS.items(),
                        *((a, "train_4k") for a in FSDP_RECORDS)):
        rec = DR.run_mesh([arch], [shape], False)[0]
        t = RF.roofline_terms(rec)
        ext = rec["extrapolated"]
        out[f"{arch}|{shape}|16x16"] = {
            "microbatches": rec.get("microbatches", 1),
            "collective_bytes_by_kind": ext["collective_bytes_by_kind"],
            "effective_bytes_per_device":
                ext["collective_effective_bytes_per_device"],
            "t_link_s": t["t_link_s"], "t_compute_s": t["t_compute_s"],
            "t_memory_s": t["t_memory_s"], "dominant": t["dominant"]}
    return out


def _fmt(c: dict) -> str:
    return ", ".join(f"{k} {c['counts'][k]} / {c['bytes_by_kind'][k]:.0f} B"
                     for k in sorted(c["counts"])) or "none"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)
    res = {"port": port_counts(), "jax": jax_counts(), "link": link_terms()}
    print("| unit | port (calls / bytes a rank) | JAX HLO (ops / bytes a "
          "device) |")
    print("| --- | --- | --- |")
    for key in res["port"]:
        print(f"| {key} | {_fmt(res['port'][key])} | "
              f"{_fmt(res['jax'][key])} |")
    print()
    for key, t in res["link"].items():
        print(f"{key}: microbatches {t['microbatches']}, link "
              f"{t['t_link_s']:.4g} s, compute "
              f"{t['t_compute_s']:.4g} s, memory {t['t_memory_s']:.4g} s, "
              f"{t['effective_bytes_per_device'] / 2 ** 30:.4g} GiB a "
              f"device")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
