"""The port's flat import surfaces against the JAX package's: every name a
JAX subpackage exports (its ``__all__``, or the public names its
``__init__`` imports where it has none) is in the port's ``__all__`` and
resolves there, a module to a module; the constants' values agree; and
the module-default metrics sink of ``repro_torch.obs`` behaves as
``repro.obs``'s (``tests/test_obs.py::test_memory_sink_and_default_record``).
"""
import importlib
import types

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

#: the JAX subpackages with a flat surface, by name under ``repro`` and
#: ``repro_torch``
PACKAGES = ("core", "obs", "optim")


def exported(mod) -> set:
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {k for k, v in vars(mod).items() if not k.startswith("_")
            and not (isinstance(v, types.ModuleType)
                     and v.__name__ == f"{mod.__name__}.{k}")}


@pytest.mark.parametrize("name", PACKAGES)
def test_port_exports_every_name_of_the_jax_surface(name):
    jax_mod = importlib.import_module(f"repro.{name}")
    port = importlib.import_module(f"repro_torch.{name}")
    want = exported(jax_mod)
    assert want, name
    if hasattr(jax_mod, "__all__"):
        assert set(port.__all__) == want
    else:
        assert want <= set(port.__all__)
    for k in want:
        assert hasattr(port, k), f"repro_torch.{name}.{k}"
        ref, got = getattr(jax_mod, k), getattr(port, k)
        assert isinstance(got, types.ModuleType) == isinstance(
            ref, types.ModuleType), k
        if isinstance(got, types.ModuleType):
            assert got.__name__ == f"repro_torch.{name}.{k}"


def test_core_constants_equal_the_jax_ones():
    from repro import core as J
    from repro_torch import core as P

    assert sorted(P.OPTIMIZERS) == sorted(J.OPTIMIZERS)
    assert tuple(P.FAULT_COUNTER_NAMES) == tuple(J.FAULT_COUNTER_NAMES)


def test_memory_sink_and_default_record():
    from repro_torch import obs as M

    sink = M.MemorySink()
    prev = M.set_sink(sink)
    try:
        M.record("bench.mix", 12.5, step=3, arch="h2o")
        assert M.get_sink() is sink
    finally:
        M.set_sink(prev)
    assert sink.records == [
        {"name": "bench.mix", "value": 12.5, "step": 3, "arch": "h2o"}]
    # after restore, record() goes to the previous (Null) sink: no error
    M.record("dropped", 0.0)
    assert isinstance(M.get_sink(), M.NullSink)
    # an explicit sink wins over the default
    other = M.MemorySink()
    M.record("x", 1, sink=other)
    assert other.records == [{"name": "x", "value": 1}]
