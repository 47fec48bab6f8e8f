"""The dry-run's production-mesh records (repro_torch.launch.dryrun
``--both-meshes``/``--multi-pod``) against the JAX package.

* Every (arch x shape) on 16x16 and 2x16x16: ``ok`` where the JAX dry-run
  lowers the pair, ``skipped`` with its reason where ``shape_supported``
  refuses it; ``n_agents`` and ``rules`` are what the JAX ``n_agents_for``
  and ``build_rules``/``serve_rules`` give (the rules as ``str``s, as the
  JAX records hold them).
* The per-device argument bytes, by part, equal the bytes of one device's
  shard of each leaf, ``NamedSharding(mesh, spec).shard_shape(shape)``,
  computed by JAX in a subprocess with 512 forced host devices (nothing
  compiled) under the JAX package's own specs, for h2o-danube-1.8b,
  qwen3-moe-30b-a3b and kimi-k2-1t-a32b.  The JAX step's 0-d int32
  arguments (the train and optimizer step counts, decode's position) are
  host integers in the port and are left out of both sums."""
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BYTES_ARCHS = ("h2o-danube-1.8b", "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

JAX_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import registry as REG
    from repro.configs.base import INPUT_SHAPES
    from repro.launch.mesh import make_production_mesh
    from repro.models import decode as D
    from repro.models import transformer as T
    from repro.training import train_step as TS

    def shard_bytes(tree, specs, mesh):
        leaves = jax.tree.leaves(tree)
        sp = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
        assert len(leaves) == len(sp)
        total = 0
        for leaf, s in zip(leaves, sp):
            if leaf.ndim == 0 and jnp.issubdtype(leaf.dtype, jnp.integer):
                continue                      # a step count
            local = NamedSharding(mesh, s).shard_shape(leaf.shape)
            total += int(np.prod(local)) * leaf.dtype.itemsize
        return total

    out = {}
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        name = "2x16x16" if mp else "16x16"
        for arch in sys.argv[1].split(","):
            cfg = REG.get_config(arch)
            for sname, shape in INPUT_SHAPES.items():
                if not REG.shape_supported(cfg, shape)[0]:
                    continue
                mem = {}
                if shape.kind == "train":
                    tc = TS.TrainConfig(microbatches=8)
                    n = TS.n_agents_for(cfg, mesh, mp)
                    rules = TS.build_rules(cfg, mp)
                    st = TS.abstract_train_state(cfg, tc, n)
                    sp = TS.train_state_specs(st, cfg, rules, mesh)
                    mem["params_bytes"] = shard_bytes(st.params, sp.params,
                                                      mesh)
                    mem["opt_state_bytes"] = shard_bytes(
                        st.opt_state, sp.opt_state, mesh)
                    batch = REG.input_specs(cfg, shape, n)
                    bsp = TS.batch_specs(batch, rules, mesh)
                else:
                    rules = TS.serve_rules(cfg, mp, shape.global_batch,
                                           mesh)
                    ps = jax.eval_shape(lambda k: T.init_params(k, cfg),
                                        jax.random.key(0))
                    mem["params_bytes"] = shard_bytes(
                        ps, TS.param_specs(ps, rules, mesh, False), mesh)
                    batch = REG.input_specs(cfg, shape)
                    bsp = TS.batch_specs_serve(batch, rules, mesh)
                    if shape.kind == "decode":
                        w = REG.decode_window(cfg, shape)
                        cs = jax.eval_shape(lambda: D.init_cache(
                            cfg, shape.global_batch, shape.seq_len, w))
                        mem["cache_bytes"] = shard_bytes(
                            cs, TS.cache_specs(cs, rules, mesh), mesh)
                        bsp = {"tokens": P()}   # lower_decode's sharding
                mem["batch_bytes"] = shard_bytes(batch, bsp, mesh)
                out[f"{arch}|{sname}|{name}"] = mem
    print(json.dumps(out))
""")


def stub(mesh_name):
    shape, names = MESHES[mesh_name]
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=np.int8))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun_mesh"))
    assert DR.main(["--all", "--both-meshes", "--device", "cpu",
                    "--out", out]) == 0
    recs = {}
    for name in os.listdir(out):
        with open(os.path.join(out, name)) as f:
            r = json.load(f)
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


@pytest.fixture(scope="module")
def jax_bytes():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT,
                          ",".join(BYTES_ARCHS)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh_name", MESHES)
def test_records_carry_the_jax_agents_and_rules(records, mesh_name):
    mp = mesh_name == "2x16x16"
    mesh = stub(mesh_name)
    assert len([k for k in records if k[2] == mesh_name]) == \
        len(REG.ARCH_IDS) * len(INPUT_SHAPES)
    for arch in REG.ARCH_IDS:
        jcfg = JREG.get_config(arch)
        for sname, shape in INPUT_SHAPES.items():
            r = records[(arch, sname, mesh_name)]
            ok, reason = JREG.shape_supported(jcfg, shape)
            assert r["status"] == ("ok" if ok else "skipped"), r
            if not ok:
                assert r["reason"] == reason
                continue
            assert r["devices"] == int(np.prod(MESHES[mesh_name][0]))
            if shape.kind == "train":
                assert r["n_agents"] == JTS.n_agents_for(jcfg, mesh, mp)
                rules = JTS.build_rules(jcfg, mp)
            else:
                assert "n_agents" not in r
                rules = JTS.serve_rules(jcfg, mp, shape.global_batch, mesh)
            assert r["rules"] == {k: str(v) for k, v in rules.items()}
            mem = r["memory"]
            assert mem["argument_size_in_bytes"] == sum(
                v for k, v in mem.items() if k != "argument_size_in_bytes")


def test_per_device_bytes_equal_jax_shard_shapes(records, jax_bytes):
    assert len(jax_bytes) == 2 * sum(
        REG.shape_supported(REG.get_config(a), s)[0]
        for a in BYTES_ARCHS for s in INPUT_SHAPES.values())
    for key, want in jax_bytes.items():
        arch, sname, mesh_name = key.split("|")
        mem = dict(records[(arch, sname, mesh_name)]["memory"])
        mem.pop("argument_size_in_bytes")
        assert mem == want, key
    # sharding does something: kimi-k2's train state is split 16 ways
    # over "model" at least
    k = records[("kimi-k2-1t-a32b", "train_4k", "16x16")]["memory"]
    full = DR.argument_bytes(REG.get_config("kimi-k2-1t-a32b"),
                             INPUT_SHAPES["train_4k"], DR.TRAIN_CONFIG, 1,
                             None)
    assert k["params_bytes"] * 16 <= full["params_bytes"]
