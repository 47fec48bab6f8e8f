"""The serving units (``engine.make_prefill``, ``engine.make_serve_step``
and ``decode.decode_step``) tensor-parallel under ``serve_rules`` on gloo
ranks, against the JAX units jitted with the same specs' shardings on
forced host devices.

h2o-danube-1.8b's smoke config in f32, the same numpy parameters and
prompts (16 tokens a row): the prefill's last logits, then 12 greedy
decode steps from an empty cache with a window of 8 (a ring of 8 slots,
which wraps), each rank holding its span of the slots:

* (1, 2) and (1, 4), batch 4: the cache's slots split over "model" (2 kv
  heads split over 2 ranks; whole over 4);
* (2, 2), batch 4: the rows over "data" too;
* (2, 2), batch 3, which the data axis does not divide: the rows whole,
  the slots over ("data", "model").

Logits agree to atol 1e-5 and the greedy tokens are equal.  Combining the
spans' partial softmaxes without rescaling them to the common max (the
planted fault) misses.  Under a model axis of 2 the SSM and hybrid
families' forwards (mamba2-780m's and recurrentgemma-9b's smoke configs
in f32) equal the one-process forward to atol 1e-5.  The JAX subprocess
and the two worlds of ranks run at the same time.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.distributed import comm  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIN, STEPS, MAXLEN, PROMPT = 8, 12, 32, 16
#: name: (mesh shape, batch, world)
CASES = {"m2": ((1, 2), 4, 2), "m4": ((1, 4), 4, 4),
         "d2m2": ((2, 2), 4, 4), "ragged": ((2, 2), 3, 4)}


def config():
    return REG.get_smoke_config("h2o-danube-1.8b").replace(
        param_dtype="float32", compute_dtype="float32")


def write_inputs(d):
    p = T.init_params(torch.Generator().manual_seed(3), config(), ())
    np.savez(os.path.join(d, "params.npz"),
             **{k: v.numpy() for k, v in SH.flatten_with_paths(p).items()})
    rng = np.random.default_rng(4)
    for name, (_, B, _) in CASES.items():
        np.save(os.path.join(d, f"{name}.prompt.npy"),
                rng.integers(0, 512, size=(B, PROMPT)).astype(np.int32))


JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import registry as REG
    from repro.distributed import sharding as SH
    from repro.models import decode as D
    from repro.serving.engine import make_prefill
    from repro.training import train_step as TS

    d, cases, win, steps, maxlen = sys.argv[1], json.loads(sys.argv[2]), \\
        *map(int, sys.argv[3:6])

    def shardings(specs, mesh):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                            is_leaf=lambda x: isinstance(x, P))

    cfg = REG.get_smoke_config("h2o-danube-1.8b").replace(
        param_dtype="float32", compute_dtype="float32")
    with np.load(os.path.join(d, "params.npz")) as z:
        params = SH._unflatten_with_paths({k: jnp.asarray(z[k])
                                           for k in z.files})
    out = {}
    for name, (shape, B, _) in cases.items():
        n = shape[0] * shape[1]
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))
        prompt = np.load(os.path.join(d, name + ".prompt.npy"))
        rules = TS.serve_rules(cfg, False, B, mesh)
        ps = shardings(TS.param_specs(params, rules, mesh, False), mesh)
        bs = shardings(TS.batch_specs_serve({"tokens": prompt}, rules,
                                            mesh), mesh)
        cache = D.init_cache(cfg, B, maxlen, win)
        cs = shardings(TS.cache_specs(cache, rules, mesh), mesh)
        rep = NamedSharding(mesh, P())
        with SH.use_rules(rules, mesh):
            pre = jax.jit(make_prefill(cfg), in_shardings=(ps, bs))
            res = {"prefill": np.asarray(pre(params, {"tokens": prompt}))}
            dec = jax.jit(lambda p, c, t, pos: D.decode_step(
                p, c, t, pos, cfg, win), in_shardings=(ps, cs, rep, rep))
            tok, logits, toks = prompt[:, :1], [], []
            for t in range(steps):
                l, cache = dec(params, cache, tok, jnp.int32(t))
                # make_serve_step's token: the argmax of these logits
                tok = np.asarray(jnp.argmax(l[:, -1], -1).astype(
                    jnp.int32))[:, None]
                logits.append(np.asarray(l[:, -1]))
                toks.append(tok[:, 0])
        res["logits"] = np.stack(logits)
        res["tokens"] = np.stack(toks)
        np.savez(os.path.join(d, name + ".jax.npz"), **res)
""")


def gather_rows(t, rules, mesh, shape, vocab_last):
    """Every rank's (rows, vocab columns) of ``t`` put together."""
    axes = ("batch", "vocab") if vocab_last else ("batch",)
    spec = SH.divisible_spec(SH.logical_to_spec(axes, rules), shape,
                             SH.mesh_axis_sizes(mesh))
    return SH.gather(t.contiguous(), spec, mesh, shape)


def serve(name, d, mesh, planted=False):
    """The prefill's logits, then decode's logits and tokens, gathered."""
    _, B, _ = CASES[name]
    cfg = config()
    with np.load(os.path.join(d, "params.npz")) as z:
        params = SH.unflatten_with_paths({k: torch.from_numpy(z[k])
                                          for k in z.files})
    prompt = np.load(os.path.join(d, f"{name}.prompt.npy"))
    rules = TS.serve_rules(cfg, False, B, mesh)
    local = CV.shard_tree(params, TS.param_specs(params, rules, mesh, False),
                          mesh, "cpu")
    bspecs = TS.batch_specs_serve({"tokens": prompt}, rules, mesh)
    tokens = CV.shard_tree({"tokens": prompt}, bspecs, mesh, "cpu")["tokens"]
    cache = D.init_cache(cfg, B, MAXLEN, WIN)
    cache = CV.shard_tree(cache, TS.cache_specs(cache, rules, mesh), mesh,
                          "cpu")
    real = A._partial_scale
    if planted:
        A._partial_scale = lambda m, m_all: torch.ones_like(m)
    try:
        with torch.no_grad(), SH.use_rules(rules, mesh):
            pre = E.make_prefill(cfg)(local, {"tokens": tokens})
            step = E.make_serve_step(cfg, WIN)
            tok, logits, toks = tokens[:, :1], [], []
            for t in range(STEPS):
                lg, _ = D.decode_step(local, cache, tok, t, cfg, WIN)
                tok, cache = step(local, cache, tok, t)
                logits.append(gather_rows(lg[:, -1], rules, mesh,
                                          (B, cfg.vocab), True))
                toks.append(gather_rows(tok[:, 0], rules, mesh, (B,), False))
    finally:
        A._partial_scale = real
    return {"prefill": gather_rows(pre, rules, mesh, (B, cfg.vocab),
                                   True).numpy(),
            "logits": torch.stack(logits).numpy(),
            "tokens": torch.stack(toks).numpy()}


#: the families that ran one-device only before the hybrid and SSM slice
OTHER = ("mamba2-780m", "recurrentgemma-9b")


def other_inputs(arch):
    """(f32 smoke config, seeded parameters, 4 x 16 prompt tokens)."""
    cfg = REG.get_smoke_config(arch).replace(param_dtype="float32",
                                             compute_dtype="float32")
    params = T.init_params(torch.Generator().manual_seed(5), cfg, ())
    tokens = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab, size=(4, PROMPT)))
    return cfg, params, tokens


def _rank_serve(rank, world, d):
    from repro_torch.launch import mesh as ML

    out = {}
    for name, (shape, _, w) in CASES.items():
        if w == world:
            out[name] = serve(name, d, ML.make_host_mesh(shape[1]))
    if world == 2:
        mesh = ML.make_host_mesh(2)
        out["planted"] = serve("m2", d, mesh, planted=True)
        for arch in OTHER:
            cfg, params, tokens = other_inputs(arch)
            rules = TS.serve_rules(cfg, False, tokens.shape[0], mesh)
            local = CV.shard_tree(params, TS.param_specs(params, rules, mesh,
                                                         False), mesh, "cpu")
            with torch.no_grad(), SH.use_rules(rules, mesh):
                lg, _ = T.forward(local, {"tokens": tokens}, cfg)
                out[arch] = {"logits": SH.gather(
                    lg.contiguous(), SH.P(None, None, "model"), mesh,
                    tuple(tokens.shape) + (cfg.vocab,)).numpy()}
    if rank == 0:
        for name, res in out.items():
            np.savez(os.path.join(d, f"{name}.port.npz"), **res)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp_serve"))
    write_inputs(d)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jax = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, d, json.dumps(CASES), str(WIN),
         str(STEPS), str(MAXLEN)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ctxs = []
    try:
        for w in (2, 4):
            sd = os.path.join(d, f"world{w}")
            os.makedirs(sd)
            ctxs.append(comm.spawn(_rank_serve, w, d, store_dir=sd,
                                   threads=1, join=False))
        for ctx in ctxs:
            while not ctx.join():
                pass
    finally:
        _, err = jax.communicate(timeout=600)
    assert jax.returncode == 0, err[-3000:]
    return d


def load(d, name, who):
    with np.load(os.path.join(d, f"{name}.{who}.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", CASES)
def test_units_equal_the_jax_units(runs, name):
    mine, ref = load(runs, name, "port"), load(runs, name, "jax")
    np.testing.assert_allclose(mine["prefill"], ref["prefill"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(mine["logits"], ref["logits"], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(mine["tokens"], ref["tokens"])


def test_combine_without_the_max_rescale_misses(runs):
    bad, ref = load(runs, "planted", "port"), load(runs, "m2", "jax")
    assert np.abs(bad["logits"] - ref["logits"]).max() > 1e-2


def test_other_families_raise_under_a_model_axis(runs):
    # they no longer raise: the SSM and hybrid forwards run on two ranks'
    # shards and equal the one-process forward
    for arch in OTHER:
        cfg, params, tokens = other_inputs(arch)
        with torch.no_grad():
            want, _ = T.forward(params, {"tokens": tokens}, cfg)
        mine = load(runs, arch, "port")["logits"]
        np.testing.assert_allclose(mine, want.numpy(), rtol=0, atol=1e-5,
                                   err_msg=arch)
