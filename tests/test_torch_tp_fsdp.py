"""The fsdp and batch rules over the data axes: the five fsdp configs'
train steps (``make_train_step`` under ``use_rules(build_rules(...),
mesh)``, each rank holding its shards under ``train_state_specs`` and its
rows under ``batch_specs``) and serving under ``serve_rules(...,
weights_fsdp=True)`` on four gloo ranks, against the JAX units jitted with
the same specs' shardings on four forced host devices.

The smoke configs in f32, the same numpy initial parameters and tokens (2
sequences of 16 an agent, one a data rank), 3 steps, in-step metrics, a
gradient clip of 0.05·sqrt(A) that binds at every step:

* (data 2, model 2), one agent: qwen3-32b with exact memory at T = 4,
  nemotron-4-15b with the labels masked unequally across the data ranks
  (12 of rank 0's 16 positions, 2 of rank 1's), qwen3-moe-30b-a3b with a
  capacity factor of 0.5 (the agent's 64 assignments over 4 experts
  overflow a capacity of 8, so a rank's drops depend on the other's
  routing) and a router aux weight of 1, recurrentgemma-9b and
  kimi-k2-1t-a32b, exp-sum K = 4;
* (pod 2, data 2, model 1): qwen3-32b with two agents over "pod", mixed
  by the consensus, each split over "data";
* (data 2, model 2) at two microbatches of 4 rows (one a data rank in
  each): qwen3-moe-30b-a3b as above and nemotron-4-15b with 12, 2, 0 and
  6 of its rows' positions masked.  Microbatch m is the JAX step's, rows
  [2m, 2m + 2) of the agent's, so its capacity, its aux loss's means and
  its CE's count of labels are those rows'.

Losses, metrics and the gathered parameters agree to rtol 1e-5 / atol
1e-6; replicated leaves are bit-equal across the ranks that hold them.
Serving: qwen3-32b's prefill (last logits) and 4 greedy decode steps of 2
rows at (data 2, model 2) under ``weights_fsdp``: logits rtol 1e-4 / atol
1e-5, tokens equal.  Four planted faults must miss: replicated leaves
counted on both data ranks in the clip, the batch sum skipped for the
leaves the data axes replicate, MoE's load balance over each rank's own
means, and microbatches cut from each rank's own rows.
``sharding.fsdp_dims`` names the dims where the JAX specs put the data
axes for every config, and ``local_slice`` of a leaf split over "data" on
one dim and "model" on another is JAX's
``devices_indices_map``.  The dry-run's meta counts of an fsdp train unit
at two microbatches and of a decode unit under ``weights_fsdp`` at (data
2, model 1) equal a real gloo run's.

qwen3_moe_mb2 runs again REPEATS times at two intra-op threads a rank:
its replicated leaves stay bit-equal and its metrics equal the one-thread
run's.

One spawn of four ranks (one thread each) and three JAX subprocesses run
side by side; the ranks' last unit runs in two 2-rank worlds.
"""
import dataclasses
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
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.distributed import comm  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, SEQ, BATCH, CLIP = 3, 16, 2, 0.05
DECODE, MAXLEN = 4, 32
TOL = dict(rtol=1e-5, atol=1e-6)
SERVE_TOL = dict(rtol=1e-4, atol=1e-5)
EXACT = {"memory_mode": "exact", "T": 4}
EXPSUM = {"memory_mode": "expsum", "K": 4}
D2M2 = [[2, 2], ["data", "model"]]
PODS = [[2, 2, 1], ["pod", "data", "model"]]
MB2 = dict(EXPSUM, microbatches=2)
MOE = {"moe": {"capacity_factor": 0.5, "router_aux_weight": 1.0}}
#: case: (arch, [mesh shape, axes], TrainConfig keywords, config overrides)
CASES = {"qwen3_32b_exact": ("qwen3-32b", D2M2, EXACT, {}),
         "nemotron_masked": ("nemotron-4-15b", D2M2, EXPSUM, {}),
         "qwen3_moe": ("qwen3-moe-30b-a3b", D2M2, EXPSUM, MOE),
         "recurrentgemma": ("recurrentgemma-9b", D2M2, EXPSUM, {}),
         "kimi_k2": ("kimi-k2-1t-a32b", D2M2, EXPSUM, {}),
         "qwen3_32b_pods": ("qwen3-32b", PODS, EXPSUM, {}),
         "qwen3_moe_mb2": ("qwen3-moe-30b-a3b", D2M2, MB2, MOE),
         "nemotron_masked_mb2": ("nemotron-4-15b", D2M2, MB2, {})}
#: the agent's rows where not BATCH: two a data rank, one a data rank in
#: each of the two microbatches
ROWS = {"qwen3_moe_mb2": 4, "nemotron_masked_mb2": 4}
#: masked positions, by row of the agent's batch (BATCH rows: one a data
#: rank)
MASKED = {"nemotron_masked": (12, 2), "nemotron_masked_mb2": (12, 2, 0, 6)}
#: planted fault: the case it plants into
PLANTED = {"replicated_counted_on_every_data_rank": "qwen3_32b_exact",
           "batch_sum_skipped": "nemotron_masked",
           "load_balance_over_local_means": "qwen3_moe",
           "microbatch_from_local_rows": "qwen3_moe_mb2"}
SERVE_ARCH = "qwen3-32b"
#: the microbatched MoE case run again at two intra-op threads a rank
REPEATS, REPEAT_CASE = 3, "qwen3_moe_mb2"
METRICS = ("loss", "grad_norm", "ce", "accuracy", "consensus_error_pre_mix",
           "consensus_error", "param_norm", "memory_norm", "update_norm")
#: the dry-run's fsdp units at (data 2, model 1): a train step of two
#: microbatches (4 rows: one a data rank in each), and a decode step under
#: ``weights_fsdp``
UNITS = (InputShape("tiny_train", 16, 4, "train"),
         InputShape("tiny_decode", 32, 2, "decode"))


def config(arch, over=None):
    cfg = REG.get_smoke_config(arch).replace(param_dtype="float32",
                                             compute_dtype="float32")
    for k, v in (over or {}).items():
        cfg = cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)})
    return cfg


def n_agents(case):
    return 2 if "pod" in CASES[case][1][1] else 1


def write_inputs(d):
    """Per case: agent-stacked initial parameters, the tokens and labels
    of every step; the serving prompt."""
    rng = np.random.default_rng(0)
    for i, (name, (arch, _, _, over)) in enumerate(CASES.items()):
        A = n_agents(name)
        p = T.init_params(torch.Generator().manual_seed(i), config(arch, over),
                          (A,))
        np.savez(os.path.join(d, f"{name}.params.npz"),
                 **{k: v.numpy() for k, v in
                    SH.flatten_with_paths(p).items()})
        toks = rng.integers(0, 512, size=(STEPS, A, ROWS.get(name, BATCH),
                                          SEQ + 1))
        labels = toks[..., 1:].copy()
        for row, n in enumerate(MASKED.get(name, ())):
            labels[:, :, row, :n] = -1
        np.savez(os.path.join(d, f"{name}.batch.npz"),
                 tokens=toks[..., :-1].astype(np.int32),
                 labels=labels.astype(np.int32))
    p = T.init_params(torch.Generator().manual_seed(9), config(SERVE_ARCH), ())
    np.savez(os.path.join(d, "serve.params.npz"),
             **{k: v.numpy() for k, v in SH.flatten_with_paths(p).items()})
    np.save(os.path.join(d, "serve.prompt.npy"),
            rng.integers(0, 512, size=(2, SEQ)).astype(np.int32))


def load_case(d, name):
    with np.load(os.path.join(d, f"{name}.params.npz")) as z:
        params = SH.unflatten_with_paths({k: torch.from_numpy(z[k])
                                          for k in z.files})
    with np.load(os.path.join(d, f"{name}.batch.npz")) as z:
        batches = [{"tokens": z["tokens"][i], "labels": z["labels"][i]}
                   for i in range(STEPS)]
    return params, batches


JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=4 "
        "--xla_cpu_collective_call_terminate_timeout_seconds=1200 "
        "--xla_cpu_collective_timeout_seconds=1200")
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import registry as REG
    from repro.distributed import sharding as SH
    from repro.models import decode as D
    from repro.models import transformer as T
    from repro.serving.engine import make_prefill
    from repro.training import train_step as TS

    d, cases = sys.argv[1], json.loads(sys.argv[2])
    clip, steps, n_dec, maxlen = float(sys.argv[3]), *map(int, sys.argv[4:7])
    serve_arch, part = sys.argv[7], sys.argv[8]

    def shardings(specs, mesh):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                            is_leaf=lambda x: isinstance(x, P))

    def config(arch, over):
        cfg = REG.get_smoke_config(arch).replace(param_dtype="float32",
                                                 compute_dtype="float32")
        for k, v in over.items():
            cfg = cfg.replace(**{k: dataclasses.replace(getattr(cfg, k),
                                                        **v)})
        return cfg

    def mesh_of(shape, axes):
        return Mesh(np.array(jax.devices()[:4]).reshape(shape), tuple(axes))

    out = {}
    for name, (arch, (shape, axes), kw, over) in cases.items():
        cfg, mesh = config(arch, over), mesh_of(shape, axes)
        mp = "pod" in axes
        A = TS.n_agents_for(cfg, mesh, mp)
        with np.load(os.path.join(d, name + ".params.npz")) as z:
            params = SH._unflatten_with_paths({k: jnp.asarray(z[k])
                                               for k in z.files})
        with np.load(os.path.join(d, name + ".batch.npz")) as z:
            batches = [{"tokens": z["tokens"][i], "labels": z["labels"][i]}
                       for i in range(steps)]
        tc = TS.TrainConfig(grad_clip=clip, remat=False,
                            collect_metrics=True, **kw)
        state = TS.TrainState(params, TS.build_optimizer(tc).init(params),
                              jnp.zeros((), jnp.int32))
        rules = TS.build_rules(cfg, mp)
        specs = TS.train_state_specs(state, cfg, rules, mesh)
        bspecs = TS.batch_specs(batches[0], rules, mesh)
        step = TS.make_train_step(cfg, tc, A, 2 if mp else 1)
        sst = shardings(specs, mesh)
        hist = []
        with SH.use_rules(rules, mesh):
            jit = jax.jit(step, in_shardings=(sst, shardings(bspecs, mesh)))
            for b in batches:
                state, met = jit(jax.device_put(state, sst), b)
                hist.append({k: float(v) for k, v in met.items()
                             if np.ndim(v) == 0})
        out[name] = hist
        np.savez(os.path.join(d, name + ".jax.npz"),
                 **{k: np.asarray(v) for k, v in
                    SH._flatten_with_paths(state.params).items()})
    if not serve_arch:
        with open(os.path.join(d, "jax." + part + ".json"), "w") as f:
            json.dump({"hist": out}, f)
        sys.exit(0)

    # serving under weights_fsdp at (data 2, model 2)
    cfg, mesh = config(serve_arch, {}), mesh_of((2, 2), ("data", "model"))
    with np.load(os.path.join(d, "serve.params.npz")) as z:
        params = SH._unflatten_with_paths({k: jnp.asarray(z[k])
                                           for k in z.files})
    batch = {"tokens": np.load(os.path.join(d, "serve.prompt.npy"))}
    B = batch["tokens"].shape[0]
    rules = TS.serve_rules(cfg, False, B, mesh, True)
    ps = shardings(TS.param_specs(params, rules, mesh, False), mesh)
    bs = shardings(TS.batch_specs_serve(batch, rules, mesh), mesh)
    cache = D.init_cache(cfg, B, maxlen)
    cs = shardings(TS.cache_specs(cache, rules, mesh), mesh)
    rep = NamedSharding(mesh, P())
    res = {}
    with SH.use_rules(rules, mesh):
        pre = jax.jit(make_prefill(cfg), in_shardings=(ps, bs))
        res["prefill"] = np.asarray(pre(params, batch))
        dec = jax.jit(lambda p, c, t, pos: D.decode_step(p, c, t, pos, cfg),
                      in_shardings=(ps, cs, rep, rep))
        tok, logits, toks = batch["tokens"][:, :1], [], []
        for t in range(n_dec):
            lg, cache = dec(params, cache, tok, jnp.int32(t))
            tok = np.asarray(jnp.argmax(lg[:, -1], -1).astype(
                jnp.int32))[:, None]
            logits.append(np.asarray(lg[:, -1]))
            toks.append(tok[:, 0])
    res["logits"], res["tokens"] = np.stack(logits), np.stack(toks)
    np.savez(os.path.join(d, "serve.jax.npz"), **res)

    # the data axes' dims of every config's specs; a leaf split over
    # "data" on one dim and "model" on another, by device
    mesh = mesh_of((2, 2), ("data", "model"))
    dims = {}
    for arch in REG.ARCH_IDS:
        cfg = REG.get_config(arch)
        shapes = jax.eval_shape(lambda k: T.init_params(k, cfg),
                                jax.random.key(0))
        for rules_name, rules in (
                ("train", TS.build_rules(cfg, False)),
                ("serve", TS.serve_rules(cfg, False, 2, mesh, True))):
            specs = TS.param_specs(shapes, rules, mesh, agent_stacked=False)
            flat = SH._flatten_with_paths(specs)
            dims[arch + "|" + rules_name] = {
                k: [i for i, p in enumerate(s) if p is not None and "data" in
                    (p if isinstance(p, tuple) else (p,))]
                for k, s in flat.items()}
    spec = P("model", "data", None)
    sh = NamedSharding(mesh, spec)
    idx = {}
    for dev, sl in sh.devices_indices_map((4, 8, 6)).items():
        pos = [int(x) for x in np.argwhere(mesh.devices == dev)[0]]
        idx["%d,%d" % tuple(pos)] = [[s.start or 0, s.stop if s.stop is not
                                      None else n] for s, n in
                                     zip(sl, (4, 8, 6))]
    with open(os.path.join(d, "jax." + part + ".json"), "w") as f:
        json.dump({"hist": out, "dims": dims, "indices": idx}, f)
""")
#: the JAX units in processes of their own, run side by side: (train
#: cases, whether the part also runs the serving units and the specs)
JAX_PARTS = ((("qwen3_32b_exact", "nemotron_masked", "nemotron_masked_mb2"),
              False),
             (("qwen3_moe", "recurrentgemma", "qwen3_moe_mb2"), False),
             (("kimi_k2", "qwen3_32b_pods"), True))


# -------------------------------------------------------------- ranks

def _counted_on_model_rank0(cfg, n_agents, rules, mesh):
    """The planted clip fault: a leaf counted on model rank 0 (or where it
    is split over "model"), whatever its data coordinate."""
    shapes = T.init_params(torch.Generator(), cfg, (n_agents,), "meta")
    specs = TS.param_specs(shapes, rules, mesh, agent_stacked=True)
    rank = SH.mesh_coords(mesh)["model"]
    return [rank == 0 or any("model" in SH.axes_of(p) for p in spec)
            for spec in TR.leaves(specs)]


def _local_means(t):
    """The planted MoE fault: the aux losses' means over this rank's own
    rows."""
    return t, 1


def _local_microbatches(batch, M, rows):
    """The planted grouping: each microbatch a slice of this rank's own
    rows (the union of every rank's m-th slice, not the agent's m-th)."""
    return {k: v.reshape((v.shape[0], M, v.shape[1] // M) + v.shape[2:])
            for k, v in batch.items()}


def planted(name):
    """(module, attribute, faulty replacement) of a planted fault."""
    from repro_torch.models import moe

    if name == "microbatch_from_local_rows":
        return TS, "microbatch_rows", _local_microbatches
    if name == "replicated_counted_on_every_data_rank":
        return TS, "model_counted", _counted_on_model_rank0
    if name == "batch_sum_skipped":
        return TS, "batch_summed", lambda *a, **k: [False] * len(
            TS._leaf_axes(*a, **k))
    return moe, "_over_batch", _local_means


def replicas_equal(state, specs, mesh) -> bool:
    """Every leaf bit-equal on the ranks whose coordinates agree on the
    axes that split it."""
    import torch.distributed as dist

    ranks = mesh.mesh
    coords = [dict(zip(mesh.mesh_dim_names,
                       (ranks == r).nonzero()[0].tolist()))
              for r in range(dist.get_world_size())]
    ok = True
    for leaf, spec in zip(TR.leaves(state), TR.leaves(specs)):
        if not isinstance(leaf, torch.Tensor):
            continue
        used = [a for p in spec for a in SH.axes_of(p)]
        parts = comm.all_gather(leaf.contiguous(), None)
        for r, c in enumerate(coords):
            twin = [q for q, e in enumerate(coords)
                    if all(e[a] == c[a] for a in used)][0]
            ok &= bool(torch.equal(parts[r], parts[twin]))
    return ok


def run_case(name, d, meshes):
    """3 steps on this rank's shards and rows: (history, gathered params
    as numpy, replicated leaves bit-equal where they are held)."""
    arch, (shape, axes), kw, over = CASES[name]
    cfg = config(arch, over)
    mesh = meshes[tuple(shape)]
    mp = "pod" in axes
    A = TS.n_agents_for(cfg, mesh, mp)
    params, batches = load_case(d, name)
    tc = TS.TrainConfig(grad_clip=CLIP, collect_metrics=True, **kw)
    full = TS.train_state_from_params(params, tc)
    rules = TS.build_rules(cfg, mp)
    specs = TS.train_state_specs(full, cfg, rules, mesh)
    state = TS.TrainState(
        CV.shard_tree(full.params, specs.params, mesh, "cpu"),
        CV.shard_tree(full.opt_state, specs.opt_state, mesh, "cpu"), 0)
    bspecs = TS.batch_specs(batches[0], rules, mesh)
    hist = []
    with SH.use_rules(rules, mesh):
        step = TS.make_train_step(cfg, tc, A, 2 if mp else 1)
        for b in batches:
            state, m = step(state, CV.shard_tree(b, bspecs, mesh, "cpu"))
            hist.append({k: float(v) for k, v in m.items() if v.dim() == 0})
    same = replicas_equal(state.params, specs.params, mesh)
    gathered = CV.gather_tree(state.params, specs.params, mesh, full.params)
    return hist, {k: v.numpy() for k, v in
                  SH.flatten_with_paths(gathered).items()}, same


def run_serve(d, mesh):
    """Prefill's last logits, then decode's logits and greedy tokens under
    ``weights_fsdp``, gathered whole."""
    from repro_torch.models import decode as D
    from repro_torch.serving import engine as E

    cfg = config(SERVE_ARCH)
    with np.load(os.path.join(d, "serve.params.npz")) as z:
        params = SH.unflatten_with_paths({k: torch.from_numpy(z[k])
                                          for k in z.files})
    batch = {"tokens": torch.from_numpy(
        np.load(os.path.join(d, "serve.prompt.npy")))}
    B = batch["tokens"].shape[0]
    rules = TS.serve_rules(cfg, False, B, mesh, weights_fsdp=True)
    local = CV.shard_tree(params, TS.param_specs(params, rules, mesh, False),
                          mesh, "cpu")
    batch = CV.shard_tree(batch, TS.batch_specs_serve(batch, rules, mesh),
                          mesh, "cpu")
    cache = D.init_cache(cfg, B, MAXLEN)
    cache = CV.shard_tree(cache, TS.cache_specs(cache, rules, mesh), mesh,
                          "cpu")
    vspec = SH.P("data", "model")
    with torch.no_grad(), SH.use_rules(rules, mesh):
        pre = SH.gather(E.make_prefill(cfg)(local, batch), vspec, mesh,
                        (B, cfg.vocab))
        step = E.make_serve_step(cfg)
        tok, logits, toks = batch["tokens"][:, :1], [], []
        for t in range(DECODE):
            lg, _ = D.decode_step(local, cache, tok, t, cfg)
            tok, cache = step(local, cache, tok, t)
            logits.append(SH.gather(lg[:, -1].contiguous(), vspec, mesh,
                                    (B, cfg.vocab)))
            toks.append(SH.gather(tok[:, 0].contiguous(), SH.P("data"),
                                  mesh, (B,)))
    return {"prefill": pre.numpy(), "logits": torch.stack(logits).numpy(),
            "tokens": torch.stack(toks).numpy()}


def unit_counts(device):
    """The dry-run's counts of the fsdp units at (data 2, model 1)."""
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as ML

    tc = dataclasses.replace(DR.TRAIN_CONFIG, use_kernel=False,
                             microbatches=2)
    return {u.kind: DR.count_collectives(
        REG.get_smoke_config("qwen3-32b"), u, ML.make_host_mesh(1), False,
        tc, device, weights_fsdp=True) for u in UNITS}


def _rank_fsdp(rank, world, d):
    import torch.distributed as dist

    from repro_torch.launch import mesh as ML

    meshes = {(2, 2): ML.make_mesh_auto((2, 2), ("data", "model")),
              (2, 2, 1): ML.make_mesh_auto((2, 2, 1),
                                           ("pod", "data", "model"))}
    out = {name: run_case(name, d, meshes) for name in CASES}
    for fault, case in PLANTED.items():
        mod, attr, bad = planted(fault)
        real = getattr(mod, attr)
        setattr(mod, attr, bad)
        try:
            out[fault] = run_case(case, d, meshes)
        finally:
            setattr(mod, attr, real)
    torch.set_num_threads(2)
    try:
        for i in range(REPEATS):
            out[f"{REPEAT_CASE}.threads2.{i}"] = run_case(REPEAT_CASE, d,
                                                          meshes)
    finally:
        torch.set_num_threads(1)
    serve = run_serve(d, meshes[(2, 2)])
    # the last unit in two 2-rank worlds: (data 2, model 1)
    dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(d, f"pair{rank // 2}"), 2), rank=rank % 2, world_size=2)
    counts = unit_counts("cpu")
    if rank == 0:
        for name, (hist, params, same) in out.items():
            np.savez(os.path.join(d, f"{name}.port.npz"), **params)
            with open(os.path.join(d, f"{name}.port.json"), "w") as f:
                json.dump({"hist": hist, "same": same}, f)
        np.savez(os.path.join(d, "serve.port.npz"), **serve)
        with open(os.path.join(d, "unit.json"), "w") as f:
            json.dump(counts, f)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp_fsdp"))
    write_inputs(d)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    assert sorted(sum((list(c) for c, _ in JAX_PARTS), [])) == sorted(CASES)
    jax = [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, d,
         json.dumps({k: CASES[k] for k in cases}), str(CLIP), str(STEPS),
         str(DECODE), str(MAXLEN), SERVE_ARCH if serve else "", str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, (cases, serve) in enumerate(JAX_PARTS)]
    try:
        comm.spawn(_rank_fsdp, 4, d, store_dir=d, threads=1)
    finally:
        errs = [p.communicate(timeout=900)[1] for p in jax]
    for p, err in zip(jax, errs):
        assert p.returncode == 0, err[-3000:]
    ref = {"hist": {}}
    for i in range(len(JAX_PARTS)):
        with open(os.path.join(d, f"jax.{i}.json")) as f:
            part = json.load(f)
        ref["hist"].update(part.pop("hist"))
        ref.update(part)
    return d, ref


def npz(d, name):
    with np.load(os.path.join(d, name)) as z:
        return {k: z[k] for k in z.files}


def port_hist(d, name):
    with open(os.path.join(d, f"{name}.port.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CASES)
def test_fsdp_step_equals_the_jax_step(runs, name):
    d, ref = runs
    want, port = ref["hist"][name], port_hist(d, name)
    A = n_agents(name)
    assert all(h["grad_norm"] > CLIP * np.sqrt(A) for h in want), \
        "the clip must bind"
    for got, exp in zip(port["hist"], want):
        for k in METRICS:
            np.testing.assert_allclose(got[k], exp[k], **TOL,
                                       err_msg=f"{name} {k}")
    p, q = npz(d, f"{name}.port.npz"), npz(d, f"{name}.jax.npz")
    assert set(p) == set(q)
    for k in p:
        np.testing.assert_allclose(p[k], q[k], **TOL, err_msg=k)
    assert port["same"], "replicated leaves differ across the ranks"


def test_replicas_stay_equal_at_two_threads_a_rank(runs):
    """The microbatched MoE case run again at two intra-op threads a rank:
    each run's replicated leaves bit-equal across the ranks, its metrics
    those of the one-thread run."""
    d, _ = runs
    one = port_hist(d, REPEAT_CASE)["hist"]
    for i in range(REPEATS):
        port = port_hist(d, f"{REPEAT_CASE}.threads2.{i}")
        assert port["same"], f"run {i}: replicated leaves differ"
        for got, exp in zip(port["hist"], one):
            for k in METRICS:
                np.testing.assert_allclose(got[k], exp[k], **TOL,
                                           err_msg=f"run {i} {k}")


def test_the_cases_drop_past_capacity_and_mask_unequally(runs):
    """The MoE cases' agent routes more assignments than its experts hold
    (in each microbatch of the microbatched one), and the masked cases'
    data ranks hold different label counts; the microbatched one's
    microbatches count other labels when grouped from each rank's own
    rows (the planted grouping) than as the JAX step groups them."""
    from repro_torch.models import moe

    m = config("qwen3-moe-30b-a3b", MOE).moe
    for rows in (BATCH, ROWS["qwen3_moe_mb2"] // MB2["microbatches"]):
        n_assign = rows * SEQ * m.top_k          # one dispatch's assignments
        assert n_assign / m.n_experts > moe._capacity(rows * SEQ, m)
    assert m.router_aux_weight == 1.0
    d, _ = runs
    _, batches = load_case(d, "nemotron_masked")
    per_rank = (batches[0]["labels"][0] >= 0).sum(axis=-1)
    assert per_rank[0] != per_rank[1]
    _, batches = load_case(d, "nemotron_masked_mb2")
    per_row = (batches[0]["labels"][0] >= 0).sum(axis=-1)       # 4 rows
    M, D = MB2["microbatches"], 2
    jax_mb = per_row.reshape(M, -1).sum(axis=1)
    local_mb = per_row.reshape(D, M, -1).sum(axis=(0, 2))
    assert per_row[:2].sum() != per_row[2:].sum()
    assert sorted(jax_mb) != sorted(local_mb)


@pytest.mark.parametrize("fault", PLANTED)
def test_planted_faults_miss(runs, fault):
    d, ref = runs
    case = PLANTED[fault]
    got = port_hist(d, fault)["hist"]
    want = ref["hist"][case]
    bad = npz(d, f"{fault}.port.npz")
    good = npz(d, f"{case}.jax.npz")
    hist_ok = all(np.allclose(g[k], w[k], **TOL) for g, w in zip(got, want)
                  for k in ("loss", "grad_norm"))
    params_ok = all(np.allclose(bad[k], good[k], **TOL) for k in good)
    assert not (hist_ok and params_ok)


def test_serving_under_weights_fsdp_equals_the_jax_units(runs):
    d, _ = runs
    mine, ref = npz(d, "serve.port.npz"), npz(d, "serve.jax.npz")
    for k in ("prefill", "logits"):
        np.testing.assert_allclose(mine[k], ref[k], **SERVE_TOL, err_msg=k)
    np.testing.assert_array_equal(mine["tokens"], ref["tokens"])


def test_fsdp_dims_are_the_jax_specs_data_dims(runs):
    """``sharding.fsdp_dims`` of every config's whole parameters under the
    train rules and under ``serve_rules(..., weights_fsdp=True)`` on
    (data 2, model 2): the dims where the JAX specs put "data"; and the
    local slice of a (model, data) split leaf is JAX's."""
    import types

    _, ref = runs
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((2, 2)))
    sizes = {"data": 2, "model": 2}
    for arch in REG.ARCH_IDS:
        cfg = REG.get_config(arch)
        shapes = {k: tuple(v.shape) for k, v in SH.flatten_with_paths(
            T.init_params(torch.Generator(), cfg, (), "meta")).items()}
        for kind, rules in (("train", TS.build_rules(cfg, False)),
                            ("serve", TS.serve_rules(cfg, False, 2, mesh,
                                                     True))):
            want = {k: v[0] for k, v in ref["dims"][f"{arch}|{kind}"].items()
                    if v}
            got = {k: d + 1 for k, d in SH.fsdp_dims(shapes, rules,
                                                     sizes).items()}
            assert got == want, (arch, kind)
    spec = SH.P("model", "data", None)
    for key, want in ref["indices"].items():
        coords = dict(zip(("data", "model"), map(int, key.split(","))))
        got = SH.local_slice((4, 8, 6), spec, sizes, coords)
        assert [[s.start, s.stop] for s in got] == want, key


def test_meta_counts_of_an_fsdp_unit_equal_a_real_gloo_run(runs):
    from repro_torch.launch import mesh as ML

    d, _ = runs
    with open(os.path.join(d, "unit.json")) as f:
        real = json.load(f)
    with ML.fake_world(2):
        meta = json.loads(json.dumps(unit_counts("meta")))
    assert meta == real
    # the train step: the rows' exchange, the gathers, their
    # reduce-scatters and the batch sum; decode under weights_fsdp: the
    # gathers alone (the model axis is 1 and decode has no backward)
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(
        real["train"]["counts"])
    assert set(real["decode"]["counts"]) == {"all-gather"}
