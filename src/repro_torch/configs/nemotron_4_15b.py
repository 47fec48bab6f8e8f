"""nemotron-4-15b [dense] — GQA kv=8, squared-ReLU MLP (no gate).
Source: arXiv:2402.16819."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="nemotron-4-15b", family="dense",
    source="arXiv:2402.16819",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=24576, vocab=256000, rope_fraction=0.5,
    activation="relu2", gated_mlp=False,
    agent_axes_single=(), agent_axes_multi=("pod",), fsdp=True,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                          d_ff=512, vocab=512)
