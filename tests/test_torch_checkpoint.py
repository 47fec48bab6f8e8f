"""The port's training/checkpoint.py shares the JAX package's npz format: a
checkpoint the JAX package writes (agent-stacked bf16 h2o-danube smoke
params) restores into the port bit for bit, and one the port writes
restores into the JAX package bit for bit; the trainer's cadence writes
one."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.training import checkpoint as JC  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.training import checkpoint as C  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

ARCH = "h2o-danube-1.8b"


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.fixture(scope="module")
def jax_params():
    cfg = JREG.get_smoke_config(ARCH)
    return JTS.init_train_state(jax.random.key(0), cfg, JTS.TrainConfig(),
                                2).params


def test_jax_checkpoint_restores_bit_equal(tmp_path, jax_params):
    path = str(tmp_path / "j" / "step3.npz")
    JC.save(path, jax_params, {"step": 3})
    like = TS.init_train_state(torch.Generator().manual_seed(1),
                               REG.get_smoke_config(ARCH), TS.TrainConfig(),
                               2).params
    got = C.restore(path, like)
    ref = params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu")
    assert len(TR.leaves(got)) == len(TR.leaves(ref)) == 12
    for a, b in zip(TR.leaves(got), TR.leaves(ref)):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(_bits(a), _bits(b))
    with np.load(path) as z:
        assert "['blocks']['mlp']['up']['w']" in z.files


def test_port_checkpoint_restores_into_jax(tmp_path, jax_params):
    mine = params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu")
    path = str(tmp_path / "p.npz")
    C.save(path, mine, {"step": 1})
    assert open(path + ".meta.json").read().strip().startswith("{")
    back = JC.restore(path, jax_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax_params)):
        np.testing.assert_array_equal(np.asarray(a).view(np.int16),
                                      np.asarray(b).view(np.int16))
    with pytest.raises(ValueError, match="shape"):
        C.restore(path, {**mine, "ln_f": {"scale": torch.zeros(3)}})


def test_trainer_writes_checkpoints(tmp_path):
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.training.trainer import Trainer
    cfg = REG.get_smoke_config(ARCH)
    t = Trainer(cfg, TS.TrainConfig(T=4, remat=False), 2, ckpt_every=1,
                ckpt_dir=str(tmp_path), device="cpu")
    data = iter(TokenPipeline(vocab=cfg.vocab, seq_len=8, batch_per_agent=1,
                              n_agents=2))
    state = t.run(t.init(0), data, 1)
    got = C.restore(str(tmp_path / "step1.npz"), state.params)
    for a, b in zip(TR.leaves(got), TR.leaves(state.params)):
        assert torch.equal(_bits(a), _bits(b))
    assert t.history[-1]["step"] == 0
