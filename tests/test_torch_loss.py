"""The port's training/loss.py against the JAX package's: cross-entropy
(with masking, z-loss, softcap), chunked CE against plain CE and against
the JAX chunked CE, the global norm, and the clip, which at bf16 must
scale in f32 and round once, bit for bit as the JAX clip does.

Tolerance for the losses: rtol 1e-5 (f32 logsumexp over 64 classes summed
in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.training import loss as JL  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.training import loss as L  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def inputs(seed=0, B=2, S=12, d=8, V=64):
    r = np.random.default_rng(seed)
    x = r.normal(size=(B, S, d)).astype(np.float32)
    w = r.normal(size=(d, V)).astype(np.float32)
    labels = r.integers(0, V, size=(B, S)).astype(np.int32)
    labels[0, :3] = -1                                   # masked
    return x, w, labels


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy_matches_jax(z_loss):
    x, w, labels = inputs()
    logits = x @ w
    loss, met = L.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), z_loss)
    jloss, jmet = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                   z_loss)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    for k in ("ce", "accuracy"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), **TOL)


@pytest.mark.parametrize("n_chunks,softcap", [(8, 0.0), (5, 0.0), (4, 2.5)])
def test_chunked_cross_entropy(n_chunks, softcap):
    """Against the JAX chunked CE, and (without softcap) against plain CE
    over the full logits; n_chunks=5 is halved until it divides B*S."""
    x, w, labels = inputs(1)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    loss, met = L.chunked_cross_entropy(tx, tw, torch.from_numpy(labels),
                                        n_chunks, softcap)
    gx, gw = torch.autograd.grad(loss, (tx, tw))
    loss = loss.detach()
    jloss, jmet = JL.chunked_cross_entropy(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(labels), n_chunks,
                                           softcap)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    np.testing.assert_allclose(float(met["accuracy"]),
                               float(jmet["accuracy"]), **TOL)
    if softcap == 0.0:
        plain, _ = L.cross_entropy(tx @ tw, torch.from_numpy(labels))
        px, pw = torch.autograd.grad(plain, (tx, tw))
        np.testing.assert_allclose(float(loss), float(plain.detach()),
                                   **TOL)
        np.testing.assert_allclose(gx.numpy(), px.numpy(), **TOL)
        np.testing.assert_allclose(gw.numpy(), pw.numpy(), **TOL)


def _tree(dtype, seed=2):
    r = np.random.default_rng(seed)
    return {"a": {"w": r.normal(size=(3, 40)).astype(dtype)},
            "b": (r.normal(size=(7,)) * 5).astype(dtype)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [1.0, 1e6])
def test_clip_by_global_norm_matches_jax(dtype, max_norm):
    """bf16 leaves: bit-equal to the JAX clip (f32 scale, one rounding);
    f32 leaves: within 1 ulp-scale of it (the norm's sum order)."""
    import ml_dtypes
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    tree = _tree(np_dtype)
    mine, norm = L.clip_by_global_norm(
        {"a": {"w": tensor_from_numpy(tree["a"]["w"], "cpu")},
         "b": tensor_from_numpy(tree["b"], "cpu")}, max_norm)
    jtree = {"a": {"w": jnp.asarray(tree["a"]["w"])},
             "b": jnp.asarray(tree["b"])}
    ref, jnorm = JL.clip_by_global_norm(jtree, max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(float(L.global_norm(mine)),
                               float(JL.global_norm(ref)), rtol=1e-6)
    for m, r in ((mine["a"]["w"], ref["a"]["w"]), (mine["b"], ref["b"])):
        assert str(m.dtype).endswith(dtype)
        r = np.asarray(r)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(m.view(torch.int16).numpy(),
                                          r.view(np.int16))
        else:
            np.testing.assert_allclose(m.numpy(), r, rtol=1e-6, atol=0)


def test_bf16_times_f32_scalar_would_round_the_scale():
    """Why the clip casts first: torch keeps bf16 * 0-d f32 in bf16."""
    x = torch.tensor([1.0, 3.0], dtype=torch.bfloat16)
    assert (x * torch.tensor(0.3)).dtype == torch.bfloat16
    assert (x.float() * torch.tensor(0.3)).dtype == torch.float32
