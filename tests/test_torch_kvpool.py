"""The port's KV slot pool (serving/kvpool.py): the properties the JAX
package's pool tests pin (tests/test_serving_scheduler.py), on the port's
in-place arena; the arena ``create`` builds against the JAX package's; and
``write_slots``, the commit of a masked decode.  Exact: no floating-point
arithmetic is involved."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import hypothesis
    import hypothesis.strategies as st
except ImportError:                                   # pragma: no cover
    hypothesis = None

from repro.configs import registry as JREG  # noqa: E402
from repro.serving.kvpool import KVSlotPool as JPool  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.serving.kvpool import (SLOT_AXIS, KVSlotPool,  # noqa: E402
                                        PoolExhausted)


def tiny_pool(n=3):
    arena = {"kv": torch.zeros((2, n, 4, 8)), "state": torch.zeros((1, n, 5))}
    return KVSlotPool(arena, n)


def tree_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(TR.leaves(a),
                                                 TR.leaves(b)))


def test_pool_alloc_lowest_free_and_counters():
    pool = tiny_pool(3)
    assert pool.n_free == 3 and pool.n_used == 0
    assert [pool.alloc() for _ in range(3)] == [0, 1, 2]
    assert pool.n_free == 0 and pool.occupancy == 1.0
    pool.free(1)
    pool.free(0)
    assert pool.alloc() == 0          # lowest free id, not LIFO
    assert pool.n_used == 2 and pool.n_free == 1


def test_pool_exhaustion_and_misuse_raise():
    pool = tiny_pool(2)
    pool.alloc(), pool.alloc()
    with pytest.raises(PoolExhausted):
        pool.alloc()
    pool.free(0)
    with pytest.raises(ValueError):
        pool.free(0)                  # double free
    with pytest.raises(ValueError):
        pool.read_slot(0)             # unallocated slot
    with pytest.raises(ValueError):
        pool.write_slot(0, None)


def test_pool_zeroes_slot_on_realloc():
    """Slot reuse must not leak the previous occupant's cache: recurrent
    state is not masked at read time."""
    pool = tiny_pool(2)
    s = pool.alloc()
    dirty = TR.tree_map(torch.ones_like, pool.read_slot(s))
    pool.write_slot(s, dirty)
    pool.positions[s] = 7
    pool.free(s)
    s2 = pool.alloc()
    assert s2 == s and pool.positions[s2] == 0
    assert tree_equal(pool.read_slot(s2), TR.tree_map(torch.zeros_like,
                                                      dirty))


def test_pool_write_is_slot_local():
    pool = tiny_pool(3)
    a, b = pool.alloc(), pool.alloc()
    pool.write_slot(b, TR.tree_map(lambda l: torch.full_like(l, 2.0),
                                   pool.read_slot(b)))
    before_b = pool.read_slot(b)
    pool.write_slot(a, TR.tree_map(lambda l: torch.full_like(l, 3.0),
                                   pool.read_slot(a)))
    assert tree_equal(pool.read_slot(b), before_b)
    assert float(pool.read_slot(a)["kv"].min()) == 3.0
    # the free slot 2 kept its zeros
    assert float(pool.arena["kv"][:, 2].abs().sum()) == 0


def test_read_slot_is_a_copy():
    pool = tiny_pool(2)
    s = pool.alloc()
    view = pool.read_slot(s)
    view["kv"].fill_(5.0)
    assert float(pool.arena["kv"].abs().sum()) == 0
    assert view["kv"].shape == (2, 1, 4, 8)


def test_write_slots_copies_only_the_given_slots():
    pool = tiny_pool(4)
    for _ in range(4):
        pool.alloc()
    new = TR.tree_map(lambda l: torch.arange(l.numel(), dtype=l.dtype)
                      .reshape(l.shape) + 1, pool.arena)
    pool.write_slots(torch.tensor([1, 3]), new)
    for l, n in zip(TR.leaves(pool.arena), TR.leaves(new)):
        assert torch.equal(l[:, [1, 3]], n[:, [1, 3]])
        assert float(l[:, [0, 2]].abs().sum()) == 0


def test_pool_rejects_bad_arena():
    with pytest.raises(ValueError):
        KVSlotPool({"kv": torch.zeros((2, 3, 4))}, max_slots=5)
    with pytest.raises(ValueError):
        KVSlotPool({}, max_slots=2)
    with pytest.raises(ValueError):
        KVSlotPool.create(REG.get_smoke_config("mamba2-780m"), 0, 8)


@pytest.mark.parametrize("arch,window_override", [
    ("h2o-danube-1.8b", None), ("h2o-danube-1.8b", 16), ("mamba2-780m", None)])
def test_create_builds_the_jax_arena(arch, window_override):
    jp = JPool.create(JREG.get_smoke_config(arch), 3, 48, window_override)
    pool = KVSlotPool.create(REG.get_smoke_config(arch), 3, 48,
                             window_override)
    assert SLOT_AXIS == 1 and pool.max_slots == jp.max_slots == 3
    assert TR.tree_map(lambda a: (tuple(a.shape),
                                  str(a.dtype).replace("torch.", "")),
                       pool.arena) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), jp.arena)
    assert pool.n_free == 3 and list(pool.positions) == [0, 0, 0]


def random_ops_check(ops, n):
    """Random alloc/free sequences: free+used always partition the slot
    ids, alloc always returns the lowest free id, exhaustion always raises
    instead of corrupting state."""
    pool = tiny_pool(n)
    used = set()
    for op in ops:
        if op % 2 == 0:                          # alloc
            if len(used) == n:
                with pytest.raises(PoolExhausted):
                    pool.alloc()
            else:
                expect = min(set(range(n)) - used)
                slot = pool.alloc()
                assert slot == expect
                assert pool.positions[slot] == 0
                used.add(slot)
        elif used:                               # free a deterministic pick
            victim = sorted(used)[op % len(used)]
            pool.free(victim)
            used.remove(victim)
        assert pool.n_used == len(used)
        assert pool.n_free == n - len(used)
        assert pool.n_used + pool.n_free == pool.max_slots


@pytest.mark.parametrize("seed", range(4))
def test_pool_free_list_invariants_seeded(seed):
    r = np.random.default_rng(seed)
    random_ops_check(r.integers(0, 5, 40).tolist(), int(r.integers(1, 5)))


if hypothesis is not None:
    @hypothesis.given(ops=st.lists(st.integers(0, 4), max_size=40),
                      n=st.integers(1, 4))
    @hypothesis.settings(max_examples=25, deadline=None)
    def test_pool_free_list_invariants(ops, n):
        random_ops_check(ops, n)
