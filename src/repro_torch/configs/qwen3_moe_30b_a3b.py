"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, GQA kv=4.
Source: hf:Qwen/Qwen3-30B-A3B."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-30b-a3b", family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936, qk_norm=True, rope_theta=1e6,
    activation="silu", gated_mlp=True,
    moe=MoEConfig(n_experts=128, top_k=8, expert_d_ff=768,
                  capacity_factor=1.25, router_aux_weight=0.001),
    agent_axes_single=(), agent_axes_multi=("pod",), fsdp=True,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          head_dim=32, d_ff=128, vocab=512,
                          moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=128,
                                        capacity_factor=1.5))
