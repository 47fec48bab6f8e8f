"""kimi-k2-1t-a32b served at a cut depth: ``repro_torch.launch.serve``'s
``n_layers`` (``load_model``, ``run_traffic``, ``--n-layers``), which draws
the config at that depth and nothing more.  At 2 layers the model keeps
one dense layer (``dense_blocks``) and one MoE layer (``blocks``), each a
stack of one.

Against the JAX package, on kimi-k2's smoke config at 2 layers (a dense
prefix layer, then 4 experts top 2 with a shared expert) from the JAX
package's initial weights drawn under ``jax.threefry_partitionable(False)``
and carried over by ``convert.params_from_numpy``: the full-sequence
forward and 20 steps of ``decode_step`` in f32, within the tolerances of
``test_torch_decode.py`` (rtol 1e-4 / atol 1e-5).  Without ``n_layers``
``load_model`` draws the tree it drew before, for every architecture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.launch import serve as LS  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

KIMI = "kimi-k2-1t-a32b"
F32 = dict(rtol=1e-4, atol=1e-5)
CUT = 2


def jax_model(n_layers=CUT, seed=0):
    """The JAX smoke config at ``n_layers`` in f32 and its initial weights
    as numpy arrays."""
    jcfg = JREG.get_smoke_config(KIMI).replace(
        n_layers=n_layers, param_dtype="float32", compute_dtype="float32")
    with jax.threefry_partitionable(False):
        jp = JT.init_params(jax.random.key(seed), jcfg)
    return jcfg, jax.tree.map(np.asarray, jp)


def tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab, shape).astype(
        np.int32)


def test_the_cut_keeps_one_dense_and_one_moe_layer():
    cfg, p = LS.load_model(KIMI, True, 0, "cpu", n_layers=CUT)
    assert cfg.n_layers == CUT and cfg.moe.n_dense_layers == 1
    assert set(p) == {"embed", "ln_f", "lm_head", "dense_blocks", "blocks"}
    assert {t.shape[0] for t in TR.leaves(p["dense_blocks"])} == {1}
    assert {t.shape[0] for t in TR.leaves(p["blocks"])} == {1}
    assert "moe" in p["blocks"] and "mlp" in p["dense_blocks"]
    assert p["blocks"]["moe"]["experts"]["gate"].shape[:2] == (
        1, cfg.moe.n_experts)
    # the config at that depth, drawn directly: nothing more is drawn
    want = T.init_params(torch.Generator().manual_seed(0),
                         REG.get_smoke_config(KIMI).replace(n_layers=CUT))
    assert TR.tree_map(lambda t: tuple(t.shape), p) == \
        TR.tree_map(lambda t: tuple(t.shape), want)
    assert all(torch.equal(a, b) for a, b in zip(TR.leaves(p),
                                                 TR.leaves(want)))


def test_the_cut_tree_is_the_jax_tree():
    jcfg, jp = jax_model()
    _, p = LS.load_model(KIMI, True, 0, "cpu", param_dtype="float32",
                         n_layers=CUT)
    assert TR.tree_map(lambda t: tuple(t.shape), p) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)


def test_forward_at_the_cut_matches_jax():
    jcfg, jp = jax_model()
    cfg, p = LS.load_model(KIMI, True, 0, "cpu", param_dtype="float32",
                           init_fn=lambda seed: jp, n_layers=CUT)
    toks = tokens(cfg, (2, 24))
    logits, aux = T.forward(p, {"tokens": torch.from_numpy(
        toks.astype(np.int64))}, cfg)
    jl, jaux = JT.forward(jax.tree.map(jnp.asarray, jp),
                          {"tokens": jnp.asarray(toks)}, jcfg)
    assert logits.shape == (2, 24, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **F32)
    np.testing.assert_allclose(float(aux), float(jaux), **F32)


def test_decode_step_at_the_cut_matches_jax():
    """20 f32 steps from an empty cache: every step's logits and the
    cache at the end (the dense prefix layer's and the MoE layer's)."""
    jcfg, jp = jax_model()
    cfg, p = LS.load_model(KIMI, True, 0, "cpu", param_dtype="float32",
                           init_fn=lambda seed: jp, n_layers=CUT)
    step = jax.jit(JD.decode_step, static_argnums=(4, 5))
    jpp = jax.tree.map(jnp.asarray, jp)
    jc = JD.init_cache(jcfg, 2, 32)
    c = D.init_cache(cfg, 2, 32)
    assert set(c) == {"dense_blocks", "blocks"}
    toks = tokens(cfg, (2, 20))
    for i in range(20):
        jl, jc = step(jpp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i),
                      jcfg, None)
        lg, c = D.decode_step(p, c, torch.from_numpy(
            toks[:, i:i + 1].astype(np.int64)), i, cfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **F32)
    for a, b in zip(TR.leaves(c), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


def test_cli_serves_the_cut_on_the_cpu(capsys):
    """``--n-layers 2`` serves the launcher's default trace (8 requests)
    on the model at that depth: the same tokens as run_traffic's."""
    LS.main(["--device", "cpu", "--smoke", "--arch", KIMI,
             "--n-layers", str(CUT)])
    out = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0] for line in out[:-1]] == [
        f"req{i}" for i in range(8)]
    assert "'total_new_tokens'" in out[-1]
    summary = LS.run_traffic(arch=KIMI, device="cpu", quiet=True,
                             n_layers=CUT)
    assert [line.split("tokens=")[1] for line in out[:-1]] == \
        [str(t) for t in summary["tokens"]]
    full = LS.run_traffic(arch=KIMI, device="cpu", quiet=True)
    assert full["tokens"] != summary["tokens"]


def test_cli_raises_without_a_card_unless_asked_for_the_cpu():
    """The CLI's default device is the card: on a host without CUDA it
    raises before it draws anything, and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LS.main(["--no-smoke", "--arch", KIMI, "--n-layers", str(CUT)])


@pytest.mark.parametrize("arch", REG.ARCH_IDS)
def test_load_model_without_n_layers_draws_the_tree_it_drew(arch):
    """The config's own depth: the tree ``transformer.init_params`` draws
    from the seeded generator, leaf for leaf (``n_layers=0`` alike)."""
    cfg, p = LS.load_model(arch, True, 0, "cpu")
    cfg0, p0 = LS.load_model(arch, True, 0, "cpu", n_layers=0)
    assert cfg == cfg0 == REG.get_smoke_config(arch)
    want = T.init_params(torch.Generator().manual_seed(0), cfg)
    for tree in (p, p0):
        assert TR.tree_map(lambda t: (tuple(t.shape), t.dtype), tree) == \
            TR.tree_map(lambda t: (tuple(t.shape), t.dtype), want)
        assert all(torch.equal(a, b) for a, b in zip(TR.leaves(tree),
                                                     TR.leaves(want)))
