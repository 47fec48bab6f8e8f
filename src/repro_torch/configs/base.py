"""Model / run configuration: a copy of the JAX package's
``repro.configs.base``.

One dataclass covers every assigned architecture; family-specific fields are
ignored where not applicable.  Each ``repro_torch/configs/<arch>.py``
exports ``CONFIG`` (the exact assigned full-size config, with source
citation) and ``smoke_config()`` (a reduced same-family variant for CPU
tests).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    n_dense_layers: int = 0          # leading dense (non-MoE) layers
    dispatch_groups: int = 1         # shard-local dispatch groups (perf)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64               # P
    n_groups: int = 1                # B/C groups
    conv_width: int = 4
    chunk: int = 256
    expand: int = 2                  # d_inner = expand * d_model


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")   # RG 1:2 ratio
    d_rnn: int = 0                   # RG-LRU width (0 -> d_model)
    conv_width: int = 4
    local_window: int = 2048


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str = "generic"
    family: str = "dense"            # dense|moe|ssm|hybrid|vlm|audio
    source: str = ""                 # citation for the assigned config

    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0                # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024

    # attention
    attn_type: str = "full"          # full|swa|mla
    window: int = 0                  # sliding window (swa / local attn)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0       # fraction of head_dim that rotates
    attn_chunk: int = 2048           # blockwise-attention chunk (long seq)
    attn_direct_max: int = 2048      # direct attention at/below this seq len
    long_context_window: int = 8192  # SWA override for long_500k serving mode

    # mlp
    activation: str = "silu"         # silu|gelu|relu2
    gated_mlp: bool = True

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None

    # enc-dec (audio family)
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_frames: int = 1500             # stubbed encoder frame count

    # vlm
    n_img_tokens: int = 0            # stubbed patch-embedding count

    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    unroll_scan: bool = False        # python-loop layers (dry-run cost probes)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # distribution defaults (overridable by the launcher)
    agent_axes_single: Tuple[str, ...] = ("data",)
    agent_axes_multi: Tuple[str, ...] = ("pod", "data")
    fsdp: bool = False               # shard each agent's params over leftover data axes

    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train|prefill|decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
