"""qwen3-32b [dense] — GQA kv=8, qk-norm. Source: hf:Qwen/Qwen3-8B family
card scaled per assignment (64L, d=5120, 64H, ff=25600, v=151936)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-32b", family="dense",
    source="hf:Qwen/Qwen3-8B (assignment: 32B scaling)",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab=151936, qk_norm=True, rope_theta=1e6,
    activation="silu", gated_mlp=True,
    agent_axes_single=(), agent_axes_multi=("pod",), fsdp=True,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                          head_dim=32, d_ff=512, vocab=512)
