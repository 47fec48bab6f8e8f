"""whisper-tiny [audio] — enc-dec transformer backbone, conv frontend stubbed.
Source: arXiv:2212.04356 (Whisper), tiny variant."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny", family="audio",
    source="arXiv:2212.04356",
    n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, activation="gelu", gated_mlp=False,
    vocab=51872,   # padded from 51865 for 16-way TP divisibility
    attn_type="full", rope_fraction=0.0,   # absolute sinusoidal positions
    enc_dec=True, n_frames=1500,
    agent_axes_single=("data",), agent_axes_multi=("pod", "data"),
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, n_enc_layers=2, d_model=128, n_heads=4,
                          n_kv_heads=4, d_ff=256, vocab=512, n_frames=64)
