"""Tensor-parallel execution of the vision, MLA, MoE, audio, SSM and
hybrid families over the "model" axis, against the JAX package's units
jitted with the same specs' shardings on forced host devices.

Each family's smoke config in f32 (phi-3-vision-4.2b, minicpm3-4b,
qwen3-moe-30b-a3b, whisper-tiny, mamba2-780m, recurrentgemma-9b), the
same numpy parameters and batches (2 sequences of 24 tokens, with patch
embeddings at 16 positions for vision and 64 frames for audio), carried
across by ``convert``:

* Train: 3 steps of ``make_train_step`` (exp-sum K = 4, in-step metrics, a
  gradient clip of 0.05 that binds at every step), each rank on its shards
  under ``train_state_specs``: on (1, 2) for the six families; on (1, 4)
  for minicpm3 with exact memory at T = 4 (rank 3's ``kv_down`` columns
  hold the end of the latent and all of the rope part), for mamba2 with
  exact memory at T = 4 (``in_proj``'s 560 columns, 140 a rank, the
  conv's 288 channels, 72 a rank, and the 16 heads, 4 a rank, all
  straddle one another), for qwen3-moe (one expert a rank) and for
  whisper with 2 heads (the axis does not divide them: attention runs
  replicated, the MLP and the vocab split).  Losses, metrics and the
  gathered parameters agree to rtol 1e-5 / atol 1e-6; replicated leaves
  are bit-equal across model ranks.
* Serve: ``make_prefill``'s last logits (with the patch embeddings or the
  frames), then 4 greedy steps of ``make_serve_step`` beside
  ``decode_step``'s logits from an empty cache (whisper's cross K/V
  written by ``encode_for_decode``) under ``serve_rules``, on (1, 2) for
  the six families and on (1, 4) for the 2-head whisper: logits rtol
  1e-4 / atol 1e-5, tokens equal.
* Planted faults that must miss: the MoE router under ``copy_to_model``
  (its gradient summed over the ranks), the audio cross-attention without
  its reduce, MLA reading ``k_rope`` from rank 0's column range, mamba2's
  gated norm over the local width alone, and the hybrid MLP called
  without ``d_ff`` (its partial sums never reduced).
* recurrentgemma-9b (fsdp=True) trains on a (2, 2) mesh, where its batch
  and fsdp rules span the data axis: its first loss is the JAX step's.

One spawn of four gloo ranks runs every case: two pairs of ranks (two
2-rank worlds in turn) take the (1, 2) cases side by side, then the four
ranks the (1, 4) cases; three JAX subprocesses run the JAX units meanwhile.
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
from repro_torch.data import synthetic as SYN  # noqa: E402
from repro_torch.distributed import comm  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, SEQ, BATCH, CLIP = 3, 24, 2, 0.05
DECODE, MAXLEN = 4, 32
TOL = dict(rtol=1e-5, atol=1e-6)
SERVE_TOL = dict(rtol=1e-4, atol=1e-5)
#: family: (arch, config overrides)
FAMILIES = {"vlm": ("phi-3-vision-4.2b", {}),
            "mla": ("minicpm3-4b", {}),
            "moe": ("qwen3-moe-30b-a3b", {}),
            "audio": ("whisper-tiny", {}),
            "audio_h2": ("whisper-tiny", {"n_heads": 2, "n_kv_heads": 2}),
            "ssm": ("mamba2-780m", {}),
            "hybrid": ("recurrentgemma-9b", {})}
EXPSUM = {"memory_mode": "expsum", "K": 4}
#: train case: (family, model axis, TrainConfig keywords)
EXACT = {"memory_mode": "exact", "T": 4}
TRAIN = {"vlm_m2": ("vlm", 2, EXPSUM), "mla_m2": ("mla", 2, EXPSUM),
         "moe_m2": ("moe", 2, EXPSUM), "audio_m2": ("audio", 2, EXPSUM),
         "ssm_m2": ("ssm", 2, EXPSUM), "hybrid_m2": ("hybrid", 2, EXPSUM),
         "mla_m4_exact": ("mla", 4, EXACT),
         "ssm_m4_exact": ("ssm", 4, EXACT),
         "moe_m4": ("moe", 4, EXPSUM),
         "audio_h2_m4": ("audio_h2", 4, EXPSUM)}
#: serve case: (family, model axis)
SERVE = {"vlm_m2": ("vlm", 2), "mla_m2": ("mla", 2), "moe_m2": ("moe", 2),
         "audio_m2": ("audio", 2), "ssm_m2": ("ssm", 2),
         "hybrid_m2": ("hybrid", 2), "audio_h2_m4": ("audio_h2", 4)}
#: the (1, 2) cases of each pair of ranks, then the (1, 4) cases
PAIRS = (("vlm", "mla", "hybrid"), ("moe", "audio", "ssm"))
#: planted fault: (the case it plants into, train or serve)
PLANTED = {"router_under_copy_to_model": ("moe_m2", "train"),
           "cross_attention_without_reduce": ("audio_m2", "serve"),
           "k_rope_from_rank0_columns": ("mla_m2", "serve"),
           "gated_norm_over_local_width": ("ssm_m2", "serve"),
           "hybrid_mlp_without_d_ff": ("hybrid_m2", "serve")}


def config(family):
    arch, over = FAMILIES[family]
    return REG.get_smoke_config(arch).replace(
        param_dtype="float32", compute_dtype="float32", **over)


def write_inputs(d):
    """Per family: the initial parameters (one agent, stacked) and the
    batches of every step (the serving prompt is step 0's)."""
    for i, fam in enumerate(FAMILIES):
        cfg = config(fam)
        p = T.init_params(torch.Generator().manual_seed(10 + i), cfg, (1,))
        np.savez(os.path.join(d, f"{fam}.params.npz"),
                 **{k: v.numpy() for k, v in
                    SH.flatten_with_paths(p).items()})
        pipe = SYN.TokenPipeline(vocab=cfg.vocab, seq_len=SEQ,
                                 batch_per_agent=BATCH, n_agents=1, seed=i)
        steps = list(SYN.augment_modalities(
            iter([next(pipe) for _ in range(STEPS)]), cfg, seed=i))
        np.savez(os.path.join(d, f"{fam}.batches.npz"),
                 **{f"{s}/{k}": v for s, b in enumerate(steps)
                    for k, v in b.items()})


def load_inputs(d, fam):
    with np.load(os.path.join(d, f"{fam}.params.npz")) as z:
        params = SH.unflatten_with_paths({k: torch.from_numpy(z[k])
                                          for k in z.files})
    with np.load(os.path.join(d, f"{fam}.batches.npz")) as z:
        steps = [{} for _ in range(STEPS)]
        for k in z.files:
            s, name = k.split("/")
            steps[int(s)][name] = z[k]
    return params, steps


def serve_batch(b):
    """Step 0's first agent, without the labels: the serving prompt."""
    return {k: v[0] for k, v in b.items() if k != "labels"}


JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    # four host devices; a collective whose device threads the loaded host
    # starves may wait long before its peers arrive: let it
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
    from repro.serving.engine import make_prefill
    from repro.training import train_step as TS

    d, fams, train, serve = sys.argv[1], *map(json.loads, sys.argv[2:5])
    clip, steps, n_dec, maxlen = float(sys.argv[5]), *map(int, sys.argv[6:9])
    part = sys.argv[9]

    def shardings(specs, mesh):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                            is_leaf=lambda x: isinstance(x, P))

    def config(fam):
        arch, over = fams[fam]
        return REG.get_smoke_config(arch).replace(
            param_dtype="float32", compute_dtype="float32", **over)

    def mesh_of(m):
        return Mesh(np.array(jax.devices()[:m]).reshape(1, m),
                    ("data", "model"))

    def inputs(fam):
        with np.load(os.path.join(d, fam + ".params.npz")) as z:
            params = SH._unflatten_with_paths({k: jnp.asarray(z[k])
                                               for k in z.files})
        with np.load(os.path.join(d, fam + ".batches.npz")) as z:
            batches = [{} for _ in range(steps)]
            for k in z.files:
                s, name = k.split("/")
                batches[int(s)][name] = z[k]
        return params, batches

    out = {}
    for name, (fam, m, kw) in train.items():
        cfg, mesh = config(fam), mesh_of(m)
        params, batches = inputs(fam)
        tc = TS.TrainConfig(grad_clip=clip, remat=False,
                            collect_metrics=True, **kw)
        state = TS.TrainState(params, TS.build_optimizer(tc).init(params),
                              jnp.zeros((), jnp.int32))
        rules = TS.build_rules(cfg, False)
        specs = TS.train_state_specs(state, cfg, rules, mesh)
        bspecs = TS.batch_specs(batches[0], rules, mesh)
        step = TS.make_train_step(cfg, tc, TS.n_agents_for(cfg, mesh, False))
        hist = []
        sst = shardings(specs, mesh)
        with SH.use_rules(rules, mesh):
            jit = jax.jit(step, in_shardings=(sst, shardings(bspecs, mesh)))
            for b in batches:
                # the step's outputs may come back laid out otherwise
                state, met = jit(jax.device_put(state, sst), b)
                hist.append({k: float(v) for k, v in met.items()
                             if np.ndim(v) == 0})
        out[name] = hist
        np.savez(os.path.join(d, name + ".train.jax.npz"),
                 **{k: np.asarray(v) for k, v in
                    SH._flatten_with_paths(state.params).items()})
    for name, (fam, m) in serve.items():
        cfg, mesh = config(fam), mesh_of(m)
        params, batches = inputs(fam)
        params = jax.tree.map(lambda t: t[0], params)
        batch = {k: v[0] for k, v in batches[0].items() if k != "labels"}
        B = batch["tokens"].shape[0]
        rules = TS.serve_rules(cfg, False, B, mesh)
        ps = shardings(TS.param_specs(params, rules, mesh, False), mesh)
        bs = shardings(TS.batch_specs_serve(batch, rules, mesh), mesh)
        cache = D.init_cache(cfg, B, maxlen)
        cs = shardings(TS.cache_specs(cache, rules, mesh), mesh)
        rep = NamedSharding(mesh, P())
        res = {}
        with SH.use_rules(rules, mesh):
            pre = jax.jit(make_prefill(cfg), in_shardings=(ps, bs))
            res["prefill"] = np.asarray(pre(params, batch))
            if cfg.family == "audio":
                enc = jax.jit(lambda p, c, f: D.encode_for_decode(p, c, f,
                                                                  cfg),
                              in_shardings=(ps, cs, bs["frames"]))
                cache = enc(params, cache, batch["frames"])
            dec = jax.jit(lambda p, c, t, pos: D.decode_step(p, c, t, pos,
                                                             cfg),
                          in_shardings=(ps, cs, rep, rep))
            tok, logits, toks = batch["tokens"][:, :1], [], []
            for t in range(n_dec):
                lg, cache = dec(params, cache, tok, jnp.int32(t))
                tok = np.asarray(jnp.argmax(lg[:, -1], -1).astype(
                    jnp.int32))[:, None]
                logits.append(np.asarray(lg[:, -1]))
                toks.append(tok[:, 0])
        res["logits"], res["tokens"] = np.stack(logits), np.stack(toks)
        np.savez(os.path.join(d, name + ".serve.jax.npz"), **res)
    with open(os.path.join(d, "jax." + part + ".json"), "w") as f:
        json.dump(out, f)
""")
#: the JAX units in processes of their own, run side by side (the train
#: cases compile one step each, the serve cases two or three units)
JAX_PARTS = ((("vlm_m2", "mla_m2", "moe_m2", "ssm_m2"), ()),
             (("audio_m2", "mla_m4_exact", "moe_m4", "audio_h2_m4"), ()),
             (("hybrid_m2", "ssm_m4_exact"), tuple(SERVE)))


# ------------------------------------------------------------ planted

def _router_under_copy(real):
    """The fault: the router weight through ``copy_to_model``, so its
    gradient (whole on every rank, from the aux loss and top_w) is summed
    over the ranks."""
    def route(params, xt, cfg):
        tp = SH.model_axis()
        w = comm.copy_to_model(params["router"]["w"], tp.group)
        return real({**params, "router": {"w": w}}, xt, cfg)
    return route


def _without_reduce(real):
    """The fault: ``real`` with every ``reduce_from_model`` in it skipped
    (each rank keeps its partial sums)."""
    def fn(*args, **kwargs):
        saved = comm.reduce_from_model
        comm.reduce_from_model = lambda t, group: t
        try:
            return real(*args, **kwargs)
        finally:
            comm.reduce_from_model = saved
    return fn


def _k_rope_from_rank0(ckv, tp, r):
    """The fault: the rope part read from rank 0's column range (its last
    ``rope`` columns) rather than from the whole output's."""
    full = comm.gather_from_model(ckv, -1, tp.group)
    w, rope = ckv.shape[-1], full.shape[-1] - r
    return full[..., :r], full[..., w - rope:w]


def _local_width_norm(params, x, eps=1e-6):
    """The fault: an RMS norm over this rank's part of the width alone
    (with its slice of the scale)."""
    from repro_torch.models import layers as L

    tp, n = SH.model_axis(), x.shape[-1]
    scale = params["scale"][tp.rank * n:(tp.rank + 1) * n]
    return L.rmsnorm({"scale": scale}, x, eps)


def _without_d_ff(real):
    """The fault: the MLP called without its full hidden width, so a
    split hidden layer's partial sums are never reduced."""
    def mlp(params, x, act_name, d_ff=None):
        return real(params, x, act_name)
    return mlp


def planted(name):
    """(module, attribute, faulty replacement) of a planted fault."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE

    if name == "router_under_copy_to_model":
        return MOE, "route", _router_under_copy(MOE.route)
    if name == "cross_attention_without_reduce":
        return T, "cross_attend", _without_reduce(T.cross_attend)
    if name == "gated_norm_over_local_width":
        return L, "rmsnorm_split", _local_width_norm
    if name == "hybrid_mlp_without_d_ff":
        return L, "mlp", _without_d_ff(L.mlp)
    return A, "_kv_latent", _k_rope_from_rank0


# -------------------------------------------------------------- ranks

def run_train(name, d, mesh):
    """3 steps on this rank's shards: (history, gathered params, whether
    the replicated leaves are bit-equal across model ranks)."""
    from repro_torch.training import train_step as TS

    fam, _, kw = TRAIN[name]
    cfg = config(fam)
    params, batches = load_inputs(d, fam)
    tc = TS.TrainConfig(grad_clip=CLIP, collect_metrics=True, **kw)
    full = TS.train_state_from_params(params, tc)
    rules = TS.build_rules(cfg, False)
    specs = TS.train_state_specs(full, cfg, rules, mesh)
    state = TS.TrainState(
        CV.shard_tree(full.params, specs.params, mesh, "cpu"),
        CV.shard_tree(full.opt_state, specs.opt_state, mesh, "cpu"), 0)
    bspecs = TS.batch_specs(batches[0], rules, mesh)
    hist = []
    with SH.use_rules(rules, mesh):
        step = TS.make_train_step(cfg, tc, TS.n_agents_for(cfg, mesh, False))
        for b in batches:
            state, m = step(state, CV.shard_tree(b, bspecs, mesh, "cpu"))
            hist.append({k: float(v) for k, v in m.items() if v.dim() == 0})
    gathered = CV.gather_tree(state.params, specs.params, mesh, full.params)
    same = True
    model = (mesh, "model")
    for leaf, spec in zip(TR.leaves(state.params), TR.leaves(specs.params)):
        if not any("model" in SH.axes_of(p) for p in spec):
            got = comm.all_gather(leaf.contiguous(), model)
            same &= bool((got == got[0]).all())
    return hist, {k: v.numpy() for k, v in
                  SH.flatten_with_paths(gathered).items()}, same


def run_serve(name, d, mesh):
    """The prefill's last logits, then decode's logits and greedy tokens,
    gathered whole."""
    from repro_torch.models import decode as D
    from repro_torch.serving import engine as E
    from repro_torch.training import train_step as TS

    fam, _ = SERVE[name]
    cfg = config(fam)
    params, batches = load_inputs(d, fam)
    params = TR.tree_map(lambda t: t[0], params)
    batch = {k: torch.as_tensor(v) for k, v in
             serve_batch(batches[0]).items()}
    B = batch["tokens"].shape[0]
    rules = TS.serve_rules(cfg, False, B, mesh)
    local = CV.shard_tree(params, TS.param_specs(params, rules, mesh, False),
                          mesh, "cpu")
    batch = CV.shard_tree(batch, TS.batch_specs_serve(batch, rules, mesh),
                          mesh, "cpu")
    cache = D.init_cache(cfg, B, MAXLEN)
    cache = CV.shard_tree(cache, TS.cache_specs(cache, rules, mesh), mesh,
                          "cpu")
    vspec = SH.P(None, "model")
    with torch.no_grad(), SH.use_rules(rules, mesh):
        pre = SH.gather(E.make_prefill(cfg)(local, batch), vspec, mesh,
                        (B, cfg.vocab))
        if cfg.family == "audio":
            cache = D.encode_for_decode(local, cache, batch["frames"], cfg)
        step = E.make_serve_step(cfg)
        tok, logits, toks = batch["tokens"][:, :1], [], []
        for t in range(DECODE):
            lg, _ = D.decode_step(local, cache, tok, t, cfg)
            tok, cache = step(local, cache, tok, t)
            logits.append(SH.gather(lg[:, -1].contiguous(), vspec, mesh,
                                    (B, cfg.vocab)))
            toks.append(tok[:, 0])
    return {"prefill": pre.numpy(), "logits": torch.stack(logits).numpy(),
            "tokens": torch.stack(toks).numpy()}


def _save(d, rank, out):
    if rank != 0:
        return
    for (kind, name), res in out.items():
        if kind == "train":
            hist, params, same = res
            np.savez(os.path.join(d, f"{name}.train.port.npz"), **params)
            with open(os.path.join(d, f"{name}.train.port.json"), "w") as f:
                json.dump({"hist": hist, "same": same}, f)
        else:
            np.savez(os.path.join(d, f"{name}.serve.port.npz"), **res)


def _regroup(path, rank, world):
    import torch.distributed as dist

    dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.FileStore(path, world),
                            rank=rank, world_size=world)


def _cases(families, m):
    return ([("train", n) for n, c in TRAIN.items()
             if c[0] in families and c[1] == m]
            + [("serve", n) for n, c in SERVE.items()
               if c[0] in families and c[1] == m])


def _run(kind, name, d, mesh):
    return (run_train if kind == "train" else run_serve)(name, d, mesh)


def _rank_families(rank, world, d):
    from repro_torch.launch import mesh as ML

    pair = rank // 2
    _regroup(os.path.join(d, f"pair{pair}"), rank % 2, 2)
    mesh = ML.make_host_mesh(2)
    out = {c: _run(*c, d, mesh) for c in _cases(PAIRS[pair], 2)}
    for fault, (case, kind) in PLANTED.items():
        if SERVE.get(case, TRAIN.get(case))[0] not in PAIRS[pair]:
            continue
        mod, attr, bad = planted(fault)
        real = getattr(mod, attr)
        setattr(mod, attr, bad)
        try:
            out[(kind, fault)] = _run(kind, case, d, mesh)
        finally:
            setattr(mod, attr, real)
    _save(d, rank % 2, out)
    _regroup(os.path.join(d, "four"), rank, 4)
    mesh = ML.make_host_mesh(4)
    _save(d, rank, {c: _run(*c, d, mesh) for c in _cases(FAMILIES, 4)})
    loss = fsdp_first_loss(d, ML.make_host_mesh(2))   # (data 2, model 2)
    if rank == 0:
        with open(os.path.join(d, "fsdp_loss.json"), "w") as f:
            json.dump(loss, f)


def fsdp_first_loss(d, mesh):
    """The first step's loss of recurrentgemma-9b (fsdp=True) on a mesh
    whose data axis is 2 (its batch and fsdp rules span it), each rank on
    its shards and its row of the hybrid case's first batch."""
    from repro_torch.training import train_step as TS

    cfg = config("hybrid")
    params, batches = load_inputs(d, "hybrid")
    tc = TS.TrainConfig(grad_clip=CLIP, collect_metrics=True, **EXPSUM)
    full = TS.train_state_from_params(params, tc)
    rules = TS.build_rules(cfg, False)
    specs = TS.train_state_specs(full, cfg, rules, mesh)
    state = TS.TrainState(
        CV.shard_tree(full.params, specs.params, mesh, "cpu"),
        CV.shard_tree(full.opt_state, specs.opt_state, mesh, "cpu"), 0)
    b = CV.shard_tree(batches[0], TS.batch_specs(batches[0], rules, mesh),
                      mesh, "cpu")
    with SH.use_rules(rules, mesh):
        step = TS.make_train_step(cfg, tc, TS.n_agents_for(cfg, mesh, False))
        _, m = step(state, b)
    return float(m["loss"])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp_families"))
    write_inputs(d)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    assert sorted(sum((list(t) for t, _ in JAX_PARTS), [])) == sorted(TRAIN)
    assert sorted(sum((list(s) for _, s in JAX_PARTS), [])) == sorted(SERVE)
    jax = [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, d, json.dumps(FAMILIES),
         json.dumps({k: TRAIN[k] for k in train}),
         json.dumps({k: SERVE[k] for k in serve}), str(CLIP), str(STEPS),
         str(DECODE), str(MAXLEN), str(i)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for i, (train, serve) in enumerate(JAX_PARTS)]
    try:
        comm.spawn(_rank_families, 4, d, store_dir=d, threads=1)
    finally:
        errs = [p.communicate(timeout=600)[1] for p in jax]
    for p, err in zip(jax, errs):
        assert p.returncode == 0, err[-3000:]
    hists = {}
    for i in range(len(JAX_PARTS)):
        with open(os.path.join(d, f"jax.{i}.json")) as f:
            hists.update(json.load(f))
    return d, hists


def load(d, name, kind, who):
    with np.load(os.path.join(d, f"{name}.{kind}.{who}.npz")) as z:
        return {k: z[k] for k in z.files}


def port_hist(d, name):
    with open(os.path.join(d, f"{name}.train.port.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", TRAIN)
def test_tp_train_step_equals_the_jax_step(runs, name):
    d, ref = runs
    port = port_hist(d, name)
    want = ref[name]
    assert all(h["grad_norm"] > CLIP for h in want), "the clip must bind"
    for got, exp in zip(port["hist"], want):
        for k in exp:
            np.testing.assert_allclose(got[k], exp[k], **TOL,
                                       err_msg=f"{name} {k}")
    p, q = load(d, name, "train", "port"), load(d, name, "train", "jax")
    assert set(p) == set(q)
    for k in p:
        np.testing.assert_allclose(p[k], q[k], **TOL, err_msg=k)
    assert port["same"], "replicated leaves differ across model ranks"


@pytest.mark.parametrize("name", SERVE)
def test_tp_serving_units_equal_the_jax_units(runs, name):
    d, _ = runs
    mine, ref = load(d, name, "serve", "port"), load(d, name, "serve", "jax")
    for k in ("prefill", "logits"):
        np.testing.assert_allclose(mine[k], ref[k], **SERVE_TOL, err_msg=k)
    np.testing.assert_array_equal(mine["tokens"], ref["tokens"])


@pytest.mark.parametrize("fault", PLANTED)
def test_planted_faults_miss(runs, fault):
    d, _ = runs
    case, kind = PLANTED[fault]
    if kind == "train":
        bad, ref = load(d, fault, "train", "port"), load(d, case, "train",
                                                          "jax")
        assert not all(np.allclose(bad[k], ref[k], **TOL) for k in ref)
    else:
        bad, ref = load(d, fault, "serve", "port"), load(d, case, "serve",
                                                          "jax")
        assert not np.allclose(bad["prefill"], ref["prefill"], **SERVE_TOL)


def test_hybrid_training_still_refuses_a_data_axis_under_tp(runs):
    """The hybrid family trains on (data 2, model 2) under its batch and
    fsdp rules: its first loss (before any update) is the JAX step's on
    (1, 2)."""
    d, ref = runs
    with open(os.path.join(d, "fsdp_loss.json")) as f:
        loss = json.load(f)
    np.testing.assert_allclose(loss, ref["hybrid_m2"][0]["loss"], **TOL)
