"""Architecture registry: the JAX package's ``repro.configs.registry``
without its ``input_specs`` (``jax.ShapeDtypeStruct`` stand-ins for the
dry-run, which is not ported yet)."""
from __future__ import annotations

import importlib
from typing import Optional

from repro_torch.configs.base import InputShape, ModelConfig

_MODULES = {
    "whisper-tiny": "whisper_tiny",
    "qwen3-32b": "qwen3_32b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "minicpm3-4b": "minicpm3_4b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-780m": "mamba2_780m",
    "nemotron-4-15b": "nemotron_4_15b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.smoke_config()


# ------------------------------------------------------------ shape skips

def shape_supported(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """(supported, reason-if-not)."""
    if shape.name == "long_500k" and cfg.family == "audio":
        return False, ("enc-dec ASR decoder has a ~448-token context; "
                       "a 500k decoder cache is meaningless for the family")
    return True, ""


def decode_window(cfg: ModelConfig, shape: InputShape) -> Optional[int]:
    """Window override for decode shapes: full-attention archs serve
    long_500k through the sliding-window variant."""
    if shape.name != "long_500k":
        return None
    if cfg.family in ("ssm", "hybrid"):
        return None                         # native sub-quadratic
    if cfg.window > 0:
        return None                         # native SWA (h2o-danube)
    return cfg.long_context_window


def reduced_layers(cfg: ModelConfig, k: int) -> ModelConfig:
    """Same family/body with the scanned layer count set so the dominant
    scan has trip count k."""
    if cfg.family == "hybrid":
        period = len(cfg.hybrid.pattern)
        tail = cfg.n_layers % period
        return cfg.replace(n_layers=period * k + tail)
    if cfg.family == "moe" and cfg.moe and cfg.moe.n_dense_layers:
        return cfg.replace(n_layers=cfg.moe.n_dense_layers + k)
    if cfg.family == "audio":
        return cfg.replace(n_layers=k, n_enc_layers=k)
    return cfg.replace(n_layers=k)


def scan_trip_count(cfg: ModelConfig) -> int:
    """Trip count of the dominant layer scan."""
    if cfg.family == "hybrid":
        return cfg.n_layers // len(cfg.hybrid.pattern)
    if cfg.family == "moe" and cfg.moe and cfg.moe.n_dense_layers:
        return cfg.n_layers - cfg.moe.n_dense_layers
    return cfg.n_layers
