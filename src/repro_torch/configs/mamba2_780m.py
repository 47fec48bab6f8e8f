"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.
Source: arXiv:2405.21060."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-780m", family="ssm",
    source="arXiv:2405.21060",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, tie_embeddings=True,
    vocab=50304,   # padded from 50280 for 16-way TP divisibility
    ssm=SSMConfig(d_state=128, head_dim=64, n_groups=1, conv_width=4,
                  chunk=256, expand=2),
    agent_axes_single=("data",), agent_axes_multi=("pod", "data"),
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, vocab=512,
                          ssm=SSMConfig(d_state=16, head_dim=16, n_groups=1,
                                        conv_width=4, chunk=32, expand=2))
