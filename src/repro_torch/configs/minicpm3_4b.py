"""minicpm3-4b [dense] — MLA (multi-head latent attention).
Source: hf:openbmb/MiniCPM3-4B."""
from repro_torch.configs.base import ModelConfig, MLAConfig

CONFIG = ModelConfig(
    arch_id="minicpm3-4b", family="dense",
    source="hf:openbmb/MiniCPM3-4B",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, attn_type="mla",
    vocab=73472,   # padded from 73448 for 16-way TP divisibility
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64),
    activation="silu", gated_mlp=True,
    agent_axes_single=("data",), agent_axes_multi=("pod", "data"),
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                          d_ff=512, vocab=512,
                          mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                        qk_nope_dim=16, qk_rope_dim=8,
                                        v_head_dim=16))
