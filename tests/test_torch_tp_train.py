"""The tensor-parallel train step (``make_train_step`` under
``use_rules(build_rules(...), make_host_mesh(m))``, each rank holding its
local shards under ``train_state_specs``) on four gloo ranks, against the
JAX step jitted with the same specs' shardings on four forced host devices.

h2o-danube-1.8b's smoke config (8 heads, 2 kv heads, vocab 512), the same
numpy initial parameters and tokens (2 sequences of 16 an agent), 3 steps,
a gradient clip of 0.05·sqrt(A) that binds at every step:

* (2, 2): 2 agents over "data", the model split in two (kv heads split),
  exact memory T = 4 with the in-step metrics, in f32; exp-sum K = 4 in
  bf16.
* (1, 4): 1 agent, the model split in four (kv heads whole: each local q
  head takes its group), exp-sum K = 4 in f32.

Losses, metrics and the gathered parameters agree with the JAX package's to
f32 rtol 1e-5 / atol 1e-6; the bf16 losses to rtol 1e-3.  A clip norm that
counts replicated leaves on every model rank (the planted fault) misses.
On a (4, 1) mesh (model axis 1) the step is bit-equal to the agent-sharded
step without rules.  A backward run in another thread than the forward
(as autograd runs it on a CUDA device) recomputes the remat layers under
the forward's rules.  recurrentgemma-9b (fsdp=True) trains on the (2, 2)
mesh, where its batch and fsdp rules span the data axis: its first loss
is the one-process loss.
The JAX subprocess and the ranks run at the same time.
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
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.distributed import comm  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, SEQ, BATCH, CLIP = 3, 16, 2, 0.05
TOL = dict(rtol=1e-5, atol=1e-6)
#: name: (model axis, TrainConfig keywords, dtype)
CASES = {
    "m2_exact_f32": (2, dict(memory_mode="exact", T=4,
                             collect_metrics=True), "float32"),
    "m2_expsum_bf16": (2, dict(memory_mode="expsum", K=4), "bfloat16"),
    "m4_expsum_f32": (4, dict(memory_mode="expsum", K=4), "float32"),
}
METRICS = ("loss", "grad_norm", "ce", "accuracy", "consensus_error_pre_mix",
           "consensus_error", "param_norm", "memory_norm", "update_norm")


def config(dtype):
    return REG.get_smoke_config("h2o-danube-1.8b").replace(
        param_dtype=dtype, compute_dtype=dtype)


def agents(mp):
    return 4 // mp


def write_inputs(d):
    """Per case: agent-stacked initial parameters (f32 arrays, exact in the
    case's dtype) and the tokens of every step."""
    rng = np.random.default_rng(0)
    for name, (mp, _, dt) in CASES.items():
        A = agents(mp)
        p = T.init_params(torch.Generator().manual_seed(1), config(dt), (A,))
        flat = {k: v.float().numpy()
                for k, v in SH.flatten_with_paths(p).items()}
        np.savez(os.path.join(d, f"{name}.params.npz"), **flat)
        toks = rng.integers(0, 512, size=(STEPS, A, BATCH, SEQ + 1))
        np.save(os.path.join(d, f"{name}.tokens.npy"), toks.astype(np.int32))


def load_inputs(d, name, dt):
    with np.load(os.path.join(d, f"{name}.params.npz")) as z:
        flat = {k: torch.from_numpy(z[k]).to(getattr(torch, dt))
                for k in z.files}
    toks = np.load(os.path.join(d, f"{name}.tokens.npy"))
    return SH.unflatten_with_paths(flat), toks


JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import registry as REG
    from repro.distributed import sharding as SH
    from repro.launch.mesh import make_host_mesh
    from repro.training import train_step as TS

    d, cases, clip, steps = sys.argv[1], json.loads(sys.argv[2]), \\
        float(sys.argv[3]), int(sys.argv[4])

    def shardings(specs, mesh):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                            is_leaf=lambda x: isinstance(x, P))

    out = {}
    for name, (mp, kw, dt) in cases.items():
        cfg = REG.get_smoke_config("h2o-danube-1.8b").replace(
            param_dtype=dt, compute_dtype=dt)
        mesh = make_host_mesh(mp)
        A = TS.n_agents_for(cfg, mesh, False)
        tc = TS.TrainConfig(grad_clip=clip, remat=False, **kw)
        with np.load(os.path.join(d, name + ".params.npz")) as z:
            params = SH._unflatten_with_paths(
                {k: jnp.asarray(z[k]).astype(dt) for k in z.files})
        toks = np.load(os.path.join(d, name + ".tokens.npy"))
        state = TS.TrainState(params, TS.build_optimizer(tc).init(params),
                              jnp.zeros((), jnp.int32))
        rules = TS.build_rules(cfg, False)
        specs = TS.train_state_specs(state, cfg, rules, mesh)
        b0 = {"tokens": toks[0, ..., :-1], "labels": toks[0, ..., 1:]}
        bspecs = TS.batch_specs(b0, rules, mesh)
        step = TS.make_train_step(cfg, tc, A)
        hist = []
        with SH.use_rules(rules, mesh):
            jit = jax.jit(step, in_shardings=(shardings(specs, mesh),
                                              shardings(bspecs, mesh)))
            for i in range(steps):
                state, m = jit(state, {"tokens": toks[i, ..., :-1],
                                       "labels": toks[i, ..., 1:]})
                hist.append({k: float(v) for k, v in m.items()
                             if np.ndim(v) == 0})
        out[name] = hist
        np.savez(os.path.join(d, name + ".jax.npz"),
                 **{k: np.asarray(v.astype(jnp.float32)) for k, v in
                    SH._flatten_with_paths(state.params).items()})
    with open(os.path.join(d, "jax.json"), "w") as f:
        json.dump(out, f)
""")


def run_case(name, d, mesh, counted_fault=False):
    """3 steps of a case on this rank's shards: (history, gathered params
    as f32 numpy, replicated leaves' bytes equal across model ranks)."""
    mp, kw, dt = CASES[name]
    cfg = config(dt)
    A = agents(mp)
    tc = TS.TrainConfig(grad_clip=CLIP, **kw)
    params, toks = load_inputs(d, name, dt)
    full = TS.train_state_from_params(params, tc)
    rules = TS.build_rules(cfg, False)
    specs = TS.train_state_specs(full, cfg, rules, mesh)
    state = TS.TrainState(
        CV.shard_tree(full.params, specs.params, mesh, "cpu"),
        CV.shard_tree(full.opt_state, specs.opt_state, mesh, "cpu"), 0)
    b0 = {"tokens": toks[0, ..., :-1], "labels": toks[0, ..., 1:]}
    bspecs = TS.batch_specs(b0, rules, mesh)
    real = TS.model_counted
    if counted_fault:
        TS.model_counted = lambda *a, **k: [True] * len(real(*a, **k))
    try:
        with SH.use_rules(rules, mesh):
            step = TS.make_train_step(cfg, tc, A)
            hist = []
            for i in range(STEPS):
                b = CV.shard_tree({"tokens": toks[i, ..., :-1],
                                   "labels": toks[i, ..., 1:]}, bspecs,
                                  mesh, "cpu")
                state, m = step(state, b)
                hist.append({k: float(v) for k, v in m.items()
                             if v.dim() == 0})
    finally:
        TS.model_counted = real
    gathered = CV.gather_tree(state.params, specs.params, mesh, full.params)
    out = {k: v.float().numpy()
           for k, v in SH.flatten_with_paths(gathered).items()}
    # replicated leaves: every model rank's bytes equal rank 0's
    same = True
    model = SH.axes_group(mesh, ("model",))
    for leaf, spec in zip(TR.leaves(state.params), TR.leaves(specs.params)):
        if not any("model" in SH.axes_of(p) for p in spec):
            got = comm.all_gather(leaf.float().contiguous(), model)
            same &= bool((got == got[0]).all())
    return hist, out, same


def run_model_axis_one(d):
    """The agent-sharded step on a (4, 1) mesh under its rules, and without
    rules: (bit-equal losses, bit-equal local params)."""
    from repro_torch.launch import mesh as ML

    cfg = config("float32")
    tc = TS.TrainConfig(grad_clip=CLIP, memory_mode="expsum", K=4)
    mesh = ML.make_host_mesh(1)
    r = torch.distributed.get_rank()
    params = T.init_params(torch.Generator().manual_seed(2), cfg, (4,))
    toks = np.random.default_rng(1).integers(0, 512, size=(2, 4, 1, 9))
    res = []
    for with_rules in (True, False):
        st = TS.train_state_from_params(
            TR.tree_map(lambda t: t[r:r + 1].clone(), params), tc)
        losses = []
        with SH.use_rules(TS.build_rules(cfg, False) if with_rules else None,
                          mesh if with_rules else None):
            step = TS.make_train_step(cfg, tc, 4, group=(mesh, "data"))
            for i in range(2):
                st, m = step(st, {"tokens": toks[i, r:r + 1, :, :-1],
                                  "labels": toks[i, r:r + 1, :, 1:]})
                losses.append(m["loss"])
        res.append((torch.stack(losses), TR.leaves(st.params)))
    (l1, p1), (l2, p2) = res
    return bool(torch.equal(l1, l2)) and all(torch.equal(a, b)
                                             for a, b in zip(p1, p2))


def backward_in_another_thread(d, mesh):
    """A remat forward under the rules, its backward run in a thread where
    they are not set (as autograd runs a CUDA backward): the recomputed
    layers and loss chunks must see the rules all the same and give the
    gradients of a backward in this thread."""
    import threading

    cfg = config("float32")
    tc = TS.TrainConfig(remat=True)
    params, toks = load_inputs(d, "m2_exact_f32", "float32")
    rules = TS.build_rules(cfg, False)
    specs = TS.param_specs(params, rules, mesh)
    local = CV.shard_tree(params, specs, mesh, "cpu")
    flat, treedef = TR.flatten(local)
    b = {"tokens": toks[0, ..., :-1], "labels": toks[0, ..., 1:]}
    b = CV.shard_tree(b, TS.batch_specs(b, rules, mesh), mesh, "cpu")
    loss_fn = TS.make_loss_fn(cfg, tc)
    grads = []
    for other_thread in (False, True):
        req = [t[0].detach().requires_grad_(True) for t in flat]
        with SH.use_rules(rules, mesh):
            loss, _ = loss_fn(TR.unflatten(treedef, req),
                              {k: v[0] for k, v in b.items()})
        out = []

        def backward():
            try:
                out.append(torch.autograd.grad(loss, req))
            except Exception as e:  # noqa: BLE001 — reported below
                out.append(e)

        if other_thread:
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        else:
            backward()
        grads.append(out[0])
    return (not isinstance(grads[1], Exception)
            and all(torch.equal(a, b) for a, b in zip(*grads)))


def fsdp_inputs():
    """recurrentgemma-9b's (fsdp=True) f32 smoke config, one agent's
    parameters and a batch of 2 rows of 8 tokens."""
    cfg = REG.get_smoke_config("recurrentgemma-9b").replace(
        param_dtype="float32", compute_dtype="float32")
    params = T.init_params(torch.Generator().manual_seed(4), cfg, (1,))
    toks = np.random.default_rng(4).integers(0, 512, size=(1, 2, 9))
    return cfg, params, {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def fsdp_first_loss(mesh):
    """The first step's loss of recurrentgemma-9b on a (2, 2) mesh, whose
    batch and fsdp rules span the data axis: each rank on its shards and
    its row."""
    cfg, params, batch = fsdp_inputs()
    tc = TS.TrainConfig(memory_mode="expsum", K=4)
    full = TS.train_state_from_params(params, tc)
    rules = TS.build_rules(cfg, False)
    specs = TS.train_state_specs(full, cfg, rules, mesh)
    state = TS.TrainState(
        CV.shard_tree(full.params, specs.params, mesh, "cpu"),
        CV.shard_tree(full.opt_state, specs.opt_state, mesh, "cpu"), 0)
    b = CV.shard_tree(batch, TS.batch_specs(batch, rules, mesh), mesh, "cpu")
    with SH.use_rules(rules, mesh):
        step = TS.make_train_step(cfg, tc, TS.n_agents_for(cfg, mesh, False))
        _, m = step(state, b)
    return float(m["loss"])


def _rank_train(rank, world, d):
    from repro_torch.launch import mesh as ML

    meshes = {2: ML.make_host_mesh(2), 4: ML.make_host_mesh(4)}
    res = {}
    for name, (mp, _, _) in CASES.items():
        res[name] = run_case(name, d, meshes[mp])
    res["planted_counted_every_rank"] = run_case("m2_exact_f32", d,
                                                 meshes[2], True)
    bit_equal = run_model_axis_one(d)
    threaded = backward_in_another_thread(d, meshes[2])
    fsdp_loss = fsdp_first_loss(meshes[2])
    if rank == 0:
        hists = {k: v[0] for k, v in res.items()}
        with open(os.path.join(d, "port.json"), "w") as f:
            json.dump({"hist": hists, "same": {k: v[2] for k, v in
                                               res.items()},
                       "bit_equal": bit_equal, "fsdp_loss": fsdp_loss,
                       "threaded": threaded}, f)
        for k, v in res.items():
            np.savez(os.path.join(d, f"{k}.port.npz"), **v[1])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp_train"))
    write_inputs(d)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    cases = {k: [mp, kw, dt] for k, (mp, kw, dt) in CASES.items()}
    jax = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, d, json.dumps(cases), str(CLIP),
         str(STEPS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        comm.spawn(_rank_train, 4, d, store_dir=d, threads=1)
    finally:
        _, err = jax.communicate(timeout=600)
    assert jax.returncode == 0, err[-3000:]
    with open(os.path.join(d, "jax.json")) as f:
        ref = json.load(f)
    with open(os.path.join(d, "port.json")) as f:
        port = json.load(f)
    return d, ref, port


def params_of(d, name, who):
    with np.load(os.path.join(d, f"{name}.{who}.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", CASES)
def test_tp_step_equals_the_jax_step(runs, name):
    d, ref, port = runs
    mine, theirs = port["hist"][name], ref[name]
    bf16 = CASES[name][2] == "bfloat16"
    for got, want in zip(mine, theirs):
        if bf16:
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-3)
            continue
        for k in METRICS:
            if k in want:
                np.testing.assert_allclose(got[k], want[k], **TOL,
                                           err_msg=k)
    if not bf16:
        p, q = params_of(d, name, "port"), params_of(d, name, "jax")
        assert set(p) == set(q)
        for k in p:
            np.testing.assert_allclose(p[k], q[k], **TOL, err_msg=k)
    assert port["same"][name], "replicated leaves differ across model ranks"


def test_the_clip_binds_and_counting_replicated_leaves_twice_misses(runs):
    d, ref, port = runs
    want = ref["m2_exact_f32"]
    assert all(h["grad_norm"] > CLIP * np.sqrt(2) for h in want)
    # the updates (parameters less the initial ones) read the clip's scale
    p0 = params_of(d, "m2_exact_f32", "params")
    bad = params_of(d, "planted_counted_every_rank", "port")
    q = params_of(d, "m2_exact_f32", "jax")
    good = params_of(d, "m2_exact_f32", "port")
    step = np.concatenate([(q[k] - p0[k]).ravel() for k in q])
    for run, ok in ((good, True), (bad, False)):
        mine = np.concatenate([(run[k] - p0[k]).ravel() for k in q])
        assert np.allclose(mine, step, rtol=1e-3, atol=1e-7) == ok
    got = port["hist"]["planted_counted_every_rank"]
    assert not np.allclose([h["grad_norm"] for h in got],
                           [h["grad_norm"] for h in want], **TOL)


def test_model_axis_one_is_bit_equal_and_other_families_raise(runs):
    _, _, port = runs
    assert port["bit_equal"]
    assert port["threaded"], "a backward in autograd's own thread differs"
    # fsdp (and batch) over a data axis of 2: the step builds and its
    # first loss (before any update) is the one-process loss
    cfg, params, batch = fsdp_inputs()
    loss_fn = TS.make_loss_fn(cfg, TS.TrainConfig())
    want, _ = loss_fn(TR.tree_map(lambda t: t[0], params),
                      {k: torch.as_tensor(v[0]) for k, v in batch.items()})
    np.testing.assert_allclose(port["fsdp_loss"], float(want), rtol=1e-5)
