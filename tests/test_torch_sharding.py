"""The port's sharding rules and spec trees (repro_torch.distributed.sharding
and the spec functions of repro_torch.training.train_step) against the JAX
package's, for all ten architectures at full size on the two production
meshes.

The JAX functions read only ``axis_names`` and ``devices.shape`` of a mesh,
so both packages get the same stub of the 16x16 ("data", "model") and the
2x16x16 ("pod", "data", "model") mesh; the JAX trees are ``eval_shape``
ones, the port's ``meta``-device ones.  Specs are compared exactly, as
tuples, leaf by leaf under the same paths: the train state (parameters and
the exp-sum optimizer state), the serving parameters at a batch the data
axes divide and at one they do not, the decode cache, and the train and
serving batches.  Also: ``shard`` is a no-op on plain tensors and outside
a rules+mesh context, and lays a DTensor out on a ``fake`` 16x16 mesh as
``to_placements`` says."""
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.configs.base import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import mesh as ML  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402
from repro_torch.utils import flops as FL  # noqa: E402

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def stub(multi_pod):
    shape, names = MESHES[multi_pod]
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=np.int8))


def jflat(specs):
    """{path: tuple} of a JAX spec tree (nested dicts of PartitionSpecs)."""
    return {k: tuple(v) for k, v in JSH._flatten_with_paths(specs).items()}


def flat(specs):
    return {k: tuple(v) for k, v in SH.flatten_with_paths(specs).items()}


def jleaves(specs):
    return [tuple(s) for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def test_logical_to_spec_and_param_spec_are_the_jax_package_s():
    rules = dict(JSH.DEFAULT_RULES, agent=("pod", "data"), batch=None,
                 fsdp=("data",), kv_seq=("data", "model"))
    cases = [("agent", "batch", None), ("heads", "kv_heads", "mlp"),
             ("fsdp", "agent", "vocab"), ("kv_seq", "heads"),
             (None, None), (), ("embed", "vocab", None, None),
             ("agent", "fsdp", "expert", "mlp")]
    for axes in cases:
        for r in (rules, JSH.DEFAULT_RULES):
            assert tuple(SH.logical_to_spec(axes, r)) == tuple(
                JSH.logical_to_spec(axes, r)), axes
    paths = [p for p, _ in SH.PARAM_AXIS_PATTERNS] + [
        "blocks/attn/wq/w", "blocks/moe/experts/down", "embed/table",
        "lm_head/w", "blocks/ln1/scale", "groups/rec1/rg_wa/w", "x/y"]
    for path in paths:
        for nd in (1, 2, 3, 4, 5):
            for layer in (False, True):
                assert tuple(SH.param_spec(path, nd, layer, rules)) == tuple(
                    JSH.param_spec(path, nd, layer, rules)), (path, nd)
    assert SH.PARAM_AXIS_PATTERNS == JSH.PARAM_AXIS_PATTERNS
    assert SH.DEFAULT_RULES == JSH.DEFAULT_RULES


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", REG.ARCH_IDS)
def test_spec_functions_equal_the_jax_package_s(arch, multi_pod):
    cfg, jcfg = REG.get_config(arch), JREG.get_config(arch)
    mesh = stub(multi_pod)

    # ---- train: rules, agents, the state's specs, the batch's
    rules = TS.build_rules(cfg, multi_pod)
    assert rules == JTS.build_rules(jcfg, multi_pod)
    n = TS.n_agents_for(cfg, mesh, multi_pod)
    assert n == JTS.n_agents_for(jcfg, mesh, multi_pod)
    tc, jtc = TS.TrainConfig(), JTS.TrainConfig()
    state = TS.abstract_train_state(cfg, tc, n)
    jstate = JTS.abstract_train_state(jcfg, jtc, n)
    specs = TS.train_state_specs(state, cfg, rules, mesh)
    jspecs = JTS.train_state_specs(jstate, jcfg, rules, mesh)
    assert flat(specs.params) == jflat(jspecs.params)
    # the optimizer's paths ("acc/<param path>", "step") are the JAX ones
    assert flat(specs.opt_state) == jflat(jspecs.opt_state)
    assert tuple(specs.step) == tuple(jspecs.step) == ()
    train = INPUT_SHAPES["train_4k"]
    assert flat(TS.batch_specs(REG.input_specs(cfg, train, n), rules,
                               mesh)) == jflat(JTS.batch_specs(
                                   JREG.input_specs(jcfg, JSHAPES["train_4k"],
                                                    n), rules, mesh))

    # ---- serving: parameters at two batches, the cache, the batch
    params = FL.meta_params(cfg)
    jparams = jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                             jax.random.key(0))
    data = 32 if multi_pod else 16
    for batch in (2 * data, 3):
        srules = TS.serve_rules(cfg, multi_pod, batch, mesh)
        assert srules == JTS.serve_rules(jcfg, multi_pod, batch, mesh)
        assert flat(TS.param_specs(params, srules, mesh, False)) == jflat(
            JTS.param_specs(jparams, srules, mesh, False))
    shape = INPUT_SHAPES["decode_32k"]
    srules = TS.serve_rules(cfg, multi_pod, shape.global_batch, mesh)
    window = REG.decode_window(cfg, shape)
    assert window == JREG.decode_window(jcfg, JSHAPES["decode_32k"])
    cache = D.init_cache(cfg, shape.global_batch, shape.seq_len, window,
                         device="meta")
    jcache = jax.eval_shape(lambda: JD.init_cache(
        jcfg, shape.global_batch, shape.seq_len, window))
    got = [tuple(s) for s in TR.leaves(TS.cache_specs(cache, srules, mesh))]
    assert got == jleaves(JTS.cache_specs(jcache, srules, mesh))
    assert [tuple(t.shape) for t in TR.leaves(cache)] == [
        tuple(t.shape) for t in jax.tree.leaves(jcache)]
    prefill = INPUT_SHAPES["prefill_32k"]
    prules = TS.serve_rules(cfg, multi_pod, prefill.global_batch, mesh)
    assert flat(TS.batch_specs_serve(REG.input_specs(cfg, prefill), prules,
                                     mesh)) == jflat(JTS.batch_specs_serve(
        JREG.input_specs(jcfg, JSHAPES["prefill_32k"]), prules, mesh))


def test_shard_is_a_no_op_without_a_mesh_and_on_plain_tensors():
    x = torch.zeros(32, 48)
    assert SH.shard(x, "batch", "mlp") is x
    with SH.use_rules(dict(SH.DEFAULT_RULES), stub(False)):
        assert SH.current_rules()["mlp"] == "model"
        assert SH.shard(x, "batch", "mlp") is x
    assert SH.current_rules() is None and SH.current_mesh() is None


def test_to_placements_and_shard_on_a_fake_16x16_mesh():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with ML.fake_world(256):
        mesh = ML.make_production_mesh()
        assert ML.mesh_axis_sizes(mesh) == {"data": 16, "model": 16}
        assert SH.to_placements(SH.P("data", None, "model"), mesh) == (
            Shard(0), Shard(2))
        assert SH.to_placements(SH.P(None, "model"), mesh) == (
            Replicate(), Shard(1))
        assert SH.to_placements(SH.P(), mesh) == (Replicate(), Replicate())
        x = distribute_tensor(torch.zeros(32, 48, 40), mesh,
                              [Replicate(), Replicate()])
        with SH.use_rules(dict(SH.DEFAULT_RULES), mesh):
            # 40 is not a multiple of the 16-way model axis: dropped
            y = SH.shard(x, "batch", "mlp", "heads")
            assert y.placements == (Shard(0), Shard(1))
            assert tuple(y.to_local().shape) == (2, 3, 40)
        with pytest.raises(RuntimeError, match="already"):
            with ML.fake_world(4):
                pass
    with ML.fake_world(512):
        mesh = ML.make_production_mesh(multi_pod=True)
        assert SH.to_placements(SH.P(("pod", "data"), "model"), mesh) == (
            Shard(0), Shard(0), Shard(1))
