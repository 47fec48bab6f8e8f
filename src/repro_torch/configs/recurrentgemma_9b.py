"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 rec.
Source: arXiv:2402.19427 (Griffin / RecurrentGemma)."""
from repro_torch.configs.base import ModelConfig, HybridConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b", family="hybrid",
    source="arXiv:2402.19427",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000, logit_softcap=30.0, tie_embeddings=True,
    activation="gelu", gated_mlp=True,
    hybrid=HybridConfig(pattern=("rec", "rec", "attn"), d_rnn=4096,
                        conv_width=4, local_window=2048),
    agent_axes_single=(), agent_axes_multi=("pod",), fsdp=True,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=5, d_model=128, n_heads=4, n_kv_heads=1,
                          head_dim=32, d_ff=256, vocab=512,
                          hybrid=HybridConfig(pattern=("rec", "rec", "attn"),
                                              d_rnn=128, conv_width=4,
                                              local_window=32))
