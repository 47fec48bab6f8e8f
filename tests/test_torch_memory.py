"""repro_torch.core.memory against repro.core.memory: the numpy weight and
fit functions bit-equal, the torch state ops on the same numpy inputs.

Tolerances: f32 rtol 1e-6 / atol 1e-6 (the same contraction in another
order), bf16 2e-2 (one bf16 rounding step is ~4e-3 relative)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import memory as jmem  # noqa: E402
from repro_torch.core import memory as tmem  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402

SHAPES = [(7,), (3, 5), (2, 4, 3)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=1e-6, atol=1e-6)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def _pair(rng, shape, name):
    """The same values as a jax array and a torch tensor of one dtype."""
    jdt, _ = DTYPES[name]
    j = jnp.asarray(rng.normal(size=shape), jdt)
    return j, tensor_from_numpy(np.asarray(j), "cpu")


@pytest.mark.parametrize("T,lam,scale", [(1, 0.5, 1.0), (9, 0.15, 1.0),
                                         (80, 0.15, 1.0), (100, 0.2, 2.0)])
def test_mu_weights_bit_equal(T, lam, scale):
    np.testing.assert_array_equal(tmem.mu_weights(T, lam, scale),
                                  jmem.mu_weights(T, lam, scale))


@pytest.mark.parametrize("T,lam,K", [(40, 0.15, 6), (80, 0.15, 8),
                                     (100, 0.2, 10)])
def test_fit_expsum_bit_equal(T, lam, K):
    for a, b in zip(tmem.fit_expsum(T, lam, K), jmem.fit_expsum(T, lam, K)):
        np.testing.assert_array_equal(a, b)
    assert tmem.expsum_error(T, lam, K) == jmem.expsum_error(T, lam, K)


def test_mu_weights_rejects_bad_args():
    with pytest.raises(ValueError):
        tmem.mu_weights(0, 0.5)
    with pytest.raises(ValueError):
        tmem.mu_weights(5, 1.5)


@pytest.mark.parametrize("T", [1, 5, 9])
def test_slot_weights_is_the_reference_rotation(T):
    w = np.arange(1, T + 1, dtype=np.float32)
    for cursor in range(T):
        s = np.arange(T)
        n = np.mod(cursor - s, T)
        n = np.where(n == 0, T, n)
        np.testing.assert_array_equal(
            tmem.slot_weights(torch.from_numpy(w), cursor).numpy(), w[n - 1])
    with pytest.raises(ValueError):
        tmem.slot_weights(torch.from_numpy(w), T)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_exact_memory_term_and_push(shape, name):
    rng = np.random.default_rng(len(shape) * 7 + len(name))
    T = 9
    jh, th = _pair(rng, (T,) + shape, name)
    jg, tg = _pair(rng, shape, name)
    w = tmem.mu_weights(T, 0.15)
    jw, tw = jnp.asarray(w, jnp.float32), torch.tensor(w, dtype=torch.float32)
    for cursor in (0, 4, T - 1):
        jm = jmem.exact_memory_term(jh, jnp.int32(cursor), jw)
        tm = tmem.exact_memory_term(th, cursor, tw)
        assert tm.dtype == th.dtype and tuple(tm.shape) == shape
        np.testing.assert_allclose(_np(tm), _np(jm), **_tol(name))
        jh2 = jmem.exact_push(jh, jnp.int32(cursor), jg)
        th2 = tmem.exact_push(th.clone(), cursor, tg)
        np.testing.assert_array_equal(_np(th2), _np(jh2))


def test_exact_push_is_in_place():
    h = torch.zeros((3, 4))
    out = tmem.exact_push(h, 1, torch.ones(4))
    assert out is h and h[1].eq(1).all() and h[0].eq(0).all()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("acc_name", list(DTYPES))
@pytest.mark.parametrize("g_name", list(DTYPES))
def test_expsum_memory_term_and_push(shape, acc_name, g_name):
    rng = np.random.default_rng(len(shape) + 3 * len(acc_name)
                                + 5 * len(g_name))
    K = 6
    ja, ta = _pair(rng, (K,) + shape, acc_name)
    jg, tg = _pair(rng, shape, g_name)
    r, c = tmem.fit_expsum(40, 0.15, K)
    jr, jc = jnp.asarray(r, jnp.float32), jnp.asarray(c, jnp.float32)
    tr, tc = (torch.tensor(r, dtype=torch.float32),
              torch.tensor(c, dtype=torch.float32))
    tol = _tol("bfloat16" if "bfloat16" in (acc_name, g_name) else "float32")
    np.testing.assert_allclose(_np(tmem.expsum_memory_term(ta, tc)),
                               _np(jmem.expsum_memory_term(ja, jc)), **tol)
    new = tmem.expsum_push(ta, tr, tg)
    assert new.dtype == ta.dtype
    np.testing.assert_allclose(_np(new), _np(jmem.expsum_push(ja, jr, jg)),
                               **tol)


def test_init_shapes_and_dtypes():
    p = torch.zeros((3, 2), dtype=torch.bfloat16)
    assert tmem.exact_init(p, 5).shape == (5, 3, 2)
    assert tmem.exact_init(p, 5).dtype == torch.bfloat16
    e = tmem.expsum_init(p, 4)
    assert e.shape == (4, 3, 2) and e.dtype == torch.float32
    assert jmem.expsum_init(jnp.zeros((3, 2), jnp.bfloat16), 4).dtype \
        == jnp.float32
