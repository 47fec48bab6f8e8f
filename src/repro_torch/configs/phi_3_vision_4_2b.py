"""phi-3-vision-4.2b [vlm] — phi3-mini LM backbone + stubbed CLIP frontend.
Source: hf:microsoft/Phi-3-vision-128k-instruct."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi-3-vision-4.2b", family="vlm",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064, rope_theta=1e4,
    activation="silu", gated_mlp=True, n_img_tokens=576,
    agent_axes_single=("data",), agent_axes_multi=("pod", "data"),
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                          d_ff=512, vocab=512, n_img_tokens=16)
