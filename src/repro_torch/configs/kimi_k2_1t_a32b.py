"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8 + 1 shared,
first layer dense.  Assignment specifies GQA kv=8 (real K2 uses MLA; we follow
the assignment spec — deviation noted in DESIGN.md).
Source: arXiv:2501.kimi2 (paper-table entry)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b", family="moe",
    source="arXiv:2501.kimi2",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, vocab=163840, rope_theta=5e6,
    activation="silu", gated_mlp=True,
    moe=MoEConfig(n_experts=384, top_k=8, expert_d_ff=2048,
                  n_shared_experts=1, shared_d_ff=2048,
                  capacity_factor=1.25, router_aux_weight=0.001,
                  n_dense_layers=1),
    agent_axes_single=(), agent_axes_multi=("pod",), fsdp=True,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=128, n_heads=4, n_kv_heads=2,
                          head_dim=32, d_ff=256, vocab=512,
                          moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=64,
                                        n_shared_experts=1, shared_d_ff=64,
                                        capacity_factor=1.5,
                                        n_dense_layers=1))
