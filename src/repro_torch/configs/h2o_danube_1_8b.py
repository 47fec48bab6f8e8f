"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.
Source: arXiv:2401.16818."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-1.8b", family="dense",
    source="arXiv:2401.16818",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000, attn_type="swa", window=4096,
    activation="silu", gated_mlp=True,
    agent_axes_single=("data",), agent_axes_multi=("pod", "data"),
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                          d_ff=512, vocab=512, window=64)
