"""The port's configs (src/repro_torch/configs/) and token pipeline
(data/synthetic.py) against the JAX package's: every architecture's config
and smoke config equal field by field, the registry's helpers equal, and
TokenPipeline / augment_modalities bit-equal."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import base as JB  # noqa: E402
from repro.configs import registry as JREG  # noqa: E402
from repro.data import synthetic as JD  # noqa: E402
from repro_torch.configs import base as B  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.data import synthetic as D  # noqa: E402


def _as_dict(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", JREG.ARCH_IDS)
def test_configs_equal_the_jax_package(arch):
    assert REG.ARCH_IDS == JREG.ARCH_IDS
    for get in ("get_config", "get_smoke_config"):
        mine, ref = getattr(REG, get)(arch), getattr(JREG, get)(arch)
        assert _as_dict(mine) == _as_dict(ref), (arch, get)
        if ref.n_heads:                  # an SSM has no attention heads
            assert mine.hd() == ref.hd()
    full = REG.get_config(arch)
    assert full.source and full.arch_id == arch
    for shape in JB.INPUT_SHAPES.values():
        mshape = B.INPUT_SHAPES[shape.name]
        assert dataclasses.asdict(mshape) == dataclasses.asdict(shape)
        assert REG.shape_supported(full, mshape) == \
            JREG.shape_supported(JREG.get_config(arch), shape)
        assert REG.decode_window(full, mshape) == \
            JREG.decode_window(JREG.get_config(arch), shape)
    for k in (1, 3):
        assert _as_dict(REG.reduced_layers(full, k)) == _as_dict(
            JREG.reduced_layers(JREG.get_config(arch), k))
    assert REG.scan_trip_count(full) == \
        JREG.scan_trip_count(JREG.get_config(arch))


def test_h2o_danube_widths():
    cfg = REG.get_config("h2o-danube-1.8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.hd(), cfg.d_ff, cfg.vocab, cfg.window) == (
        24, 2560, 32, 8, 80, 6912, 32000, 4096)
    assert cfg.source == "arXiv:2401.16818" and cfg.param_dtype == "bfloat16"


@pytest.mark.parametrize("agents,vocab", [(1, 64), (2, 512), (3, 100)])
def test_token_pipeline_is_bit_equal(agents, vocab):
    kw = dict(vocab=vocab, seq_len=16, batch_per_agent=2, n_agents=agents,
              seed=5)
    mine, ref = D.TokenPipeline(**kw), JD.TokenPipeline(**kw)
    for _ in range(3):
        a, b = next(mine), next(ref)
        assert a.keys() == b.keys() == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["tokens"][..., 1:],
                                      a["labels"][..., :-1])


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "whisper-tiny",
                                  "phi-3-vision-4.2b"])
def test_augment_modalities_is_bit_equal(arch):
    cfg, jcfg = REG.get_smoke_config(arch), JREG.get_smoke_config(arch)
    kw = dict(vocab=cfg.vocab, seq_len=8, batch_per_agent=1, n_agents=2,
              seed=1)
    mine = D.augment_modalities(iter(D.TokenPipeline(**kw)), cfg, seed=3)
    ref = JD.augment_modalities(iter(JD.TokenPipeline(**kw)), jcfg, seed=3)
    for _ in range(2):
        a, b = next(mine), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
