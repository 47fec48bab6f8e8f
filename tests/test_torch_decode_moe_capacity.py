"""MoE decode's expert capacity (models/decode.py) against the JAX
package's ``decode_step`` and ``decode_step_ragged``, on the
qwen3-moe-30b-a3b smoke config (4 experts, top 2, capacity factor 1.5) in
f32, from the JAX initial weights of ``jax.random.key(0)`` drawn under
``jax.threefry_partitionable(False)``.

At one shared position the JAX package routes the B rows of a step
together, at its capacity for B tokens (at least 8 a expert), and drops
the assignments past it: with 9 rows of one token every row picks the same
two experts, so the ninth row loses both.  The port takes that capacity
too.  With one position per row the JAX package routes each row alone
(a vmap), where nothing drops; the port raises the capacity to the row
count.  Tolerance: atol 1e-5 on logits of magnitude ~1 (the same f32
arithmetic summed in another order, ~1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
TOL = dict(rtol=0.0, atol=1e-5)
TOKEN, CACHE_LEN = 7, 8
jax_step = jax.jit(JD.decode_step, static_argnums=(4, 5))
jax_ragged = jax.jit(JD.decode_step_ragged, static_argnums=(4, 5))


@pytest.fixture(scope="module")
def model():
    kw = dict(param_dtype="float32", compute_dtype="float32")
    cfg = REG.get_smoke_config(ARCH).replace(**kw)
    jcfg = JREG.get_smoke_config(ARCH).replace(**kw)
    with jax.threefry_partitionable(False):
        jp = jax.tree.map(np.asarray, JT.init_params(jax.random.key(0), jcfg))
    return cfg, jcfg, params_from_numpy(jp, "cpu"), \
        jax.tree.map(jnp.asarray, jp)


def rows(n):
    return np.full((n, 1), TOKEN, np.int32)


@pytest.mark.parametrize("n_rows", [8, 9])
def test_one_shared_position_drops_where_the_jax_package_does(model,
                                                              n_rows):
    """n rows of one token at position 0 through ``decode_step`` with an
    int position.  At 8 rows each chosen expert holds all 8 assignments;
    at 9 the capacity is still 8 and the ninth row loses its experts, in
    both packages."""
    cfg, jcfg, p, jp = model
    assert M._capacity(n_rows, cfg.moe) == 8
    jl, _ = jax_step(jp, JD.init_cache(jcfg, n_rows, CACHE_LEN),
                     jnp.asarray(rows(n_rows)), jnp.int32(0), jcfg, None)
    lg, _ = D.decode_step(p, D.init_cache(cfg, n_rows, CACHE_LEN),
                          torch.from_numpy(rows(n_rows).astype(np.int64)), 0,
                          cfg)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    dropped = float((lg[-1] - lg[0]).abs().max())
    assert (dropped > 0.1) == (n_rows == 9)


def test_prefill_at_one_shared_position_takes_the_jax_capacity(model):
    """prefill_cache steps every row at one shared position: 9 rows of one
    token give the JAX package's last logits, the ninth row's dropped."""
    cfg, jcfg, p, jp = model
    toks = np.full((9, 2), TOKEN, np.int32)
    jl, _ = JD.prefill_cache(jp, JD.init_cache(jcfg, 9, CACHE_LEN),
                             jnp.asarray(toks), jnp.int32(0), jcfg)
    lg, _ = D.prefill_cache(p, D.init_cache(cfg, 9, CACHE_LEN),
                            torch.from_numpy(toks.astype(np.int64)), 0, cfg)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)


def test_one_position_per_row_drops_nothing(model):
    """The same 9 rows with a (9,) position vector (the ragged path): every
    row is row 0 bit for bit, and the logits are the JAX package's
    row-by-row ones."""
    cfg, jcfg, p, jp = model
    jl, _ = jax_ragged(jp, JD.init_cache(jcfg, 9, CACHE_LEN),
                       jnp.asarray(rows(9)), jnp.zeros(9, jnp.int32), jcfg,
                       None)
    lg, _ = D.decode_step_ragged(p, D.init_cache(cfg, 9, CACHE_LEN),
                                 torch.from_numpy(rows(9).astype(np.int64)),
                                 torch.zeros(9, dtype=torch.int64), cfg)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    assert all(torch.equal(lg[i], lg[0]) for i in range(9))
