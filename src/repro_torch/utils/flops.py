"""Analytic FLOP / byte accounting per (arch x input shape): the port of
the JAX package's ``repro.utils.flops``.

The port runs eagerly, so there is no compiled program whose cost a tool
could read: the dry-run's compute term, the roofline and the trainers'
``mfu`` all divide by these closed-form counts.  The JAX package uses them
for another reason (XLA's HloCostAnalysis visits each while-loop body once
and undercounts scanned layer stacks), and its formulas are carried over
unchanged, so both packages give the same numbers for the same config.
Parameter counts come from the leaves of ``transformer.init_params`` on
the ``meta`` device (shapes only, no storage), in place of
``jax.eval_shape``; leaf names are the tree's ``a/b/c`` paths, so the
``"embed"`` and ``"experts"`` tests below see the same keys.

Conventions:
* matmul flops = 2 * m * n * k;
* train exec flops = fwd + 2x bwd (+1x fwd recompute under full remat);
* MODEL_FLOPS (the "useful" 6ND number) = 6 * N_active * D with N_active
  excluding the embedding gather but including the LM head;
* attention scores/outputs counted exactly (causal block-skip halving when
  the blockwise kernel path is taken).
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer as T


def _paths(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


@functools.lru_cache(maxsize=16)
def meta_params(cfg: ModelConfig) -> Dict:
    """``cfg``'s parameter tree on the ``meta`` device (shapes and dtypes,
    no storage), cached per config so that a sweep over shapes builds each
    tree once.  Shared between callers: read it, do not change it."""
    return T.init_params(torch.Generator(), cfg, (), device="meta")


@functools.lru_cache(maxsize=64)
def _leaf_items(cfg: ModelConfig) -> Tuple[Tuple[str, int], ...]:
    """(name, element count) of every parameter leaf, in flatten order."""
    return tuple((k, int(np.prod(t.shape)))
                 for k, t in _paths(meta_params(cfg)))


def _leaf_params(cfg: ModelConfig) -> Dict[str, int]:
    return dict(_leaf_items(cfg))


def param_counts(cfg: ModelConfig) -> Dict[str, float]:
    """total, active (MoE top-k weighted), embed (gather-only)."""
    leaves = _leaf_params(cfg)
    total = float(sum(leaves.values()))
    embed = float(sum(v for k, v in leaves.items() if "embed" in k))
    active = 0.0
    for k, v in leaves.items():
        if "embed" in k:
            continue
        if "experts" in k and cfg.moe:
            active += v * cfg.moe.top_k / cfg.moe.n_experts
        else:
            active += v
    return {"total": total, "active": active, "embed": embed}


def _attn_flops_per_layer(cfg: ModelConfig, S: int, B: int,
                          window: int) -> float:
    """Score+output matmul flops, fwd, one layer (GQA or MLA expanded)."""
    hd = cfg.hd() if cfg.attn_type != "mla" else (
        cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim)
    vd = cfg.hd() if cfg.attn_type != "mla" else cfg.mla.v_head_dim
    H = cfg.n_heads
    if window and 0 < window < S:
        eff = S * window  # each query sees <= window keys
    else:
        eff = S * (S + 1) / 2 if S > cfg.attn_direct_max else S * S
        # blockwise path skips upper-triangle blocks; direct path computes SxS
    return 2.0 * B * H * eff * (hd + vd)


def train_flops(cfg: ModelConfig, shape: InputShape,
                remat: bool = True) -> Dict[str, float]:
    B, S = shape.global_batch, shape.seq_len
    D = B * S
    pc = param_counts(cfg)
    fwd_matmul = 2.0 * pc["active"] * D
    attn = 0.0
    if cfg.family in ("dense", "vlm", "moe"):
        w = cfg.window
        attn = cfg.n_layers * _attn_flops_per_layer(cfg, S, B, w)
    elif cfg.family == "hybrid":
        n_attn = sum(k == "attn" for k in cfg.hybrid.pattern) * \
            (cfg.n_layers // len(cfg.hybrid.pattern))
        attn = n_attn * _attn_flops_per_layer(cfg, S, B,
                                              cfg.hybrid.local_window)
    elif cfg.family == "ssm":
        s = cfg.ssm
        di = s.expand * cfg.d_model
        H = di // s.head_dim
        Q = min(s.chunk, S)
        nc = S // Q
        # intra-chunk (QxQ) + state build/apply per chunk
        intra = 2.0 * B * H * nc * Q * Q * (s.head_dim + s.d_state)
        states = 4.0 * B * H * nc * Q * s.head_dim * s.d_state
        attn = cfg.n_layers * (intra + states)
    elif cfg.family == "audio":
        attn = (cfg.n_enc_layers *
                _attn_flops_per_layer(cfg, cfg.n_frames, B, 0)
                + cfg.n_layers * _attn_flops_per_layer(cfg, S, B, 0)
                + cfg.n_layers * 2.0 * B * cfg.n_heads * S * cfg.n_frames
                * 2 * cfg.hd())
    fwd = fwd_matmul + attn
    # fwd + 2x bwd (+1x fwd recompute under full remat; dots policies save
    # matmul outputs so only cheap elementwise ops recompute)
    if remat in (True, "nothing"):
        factor = 4.0
    elif remat:
        factor = 3.1                        # dots-saveable: ~no dot recompute
    else:
        factor = 3.0
    model_flops = 6.0 * pc["active"] * D
    return {"exec_flops": factor * fwd, "fwd_flops": fwd,
            "model_flops": model_flops, "attn_flops": attn,
            "tokens": float(D), **pc}


def prefill_flops(cfg: ModelConfig, shape: InputShape) -> Dict[str, float]:
    t = train_flops(cfg, shape, remat=False)
    return {"exec_flops": t["fwd_flops"], "fwd_flops": t["fwd_flops"],
            "model_flops": 2.0 * t["active"] * t["tokens"],
            "attn_flops": t["attn_flops"], "tokens": t["tokens"],
            "total": t["total"], "active": t["active"], "embed": t["embed"]}


def decode_flops(cfg: ModelConfig, shape: InputShape,
                 window: int = 0) -> Dict[str, float]:
    """One serve_step: B tokens, attention against a seq_len cache."""
    B, S = shape.global_batch, shape.seq_len
    pc = param_counts(cfg)
    fwd = 2.0 * pc["active"] * B
    eff = min(window, S) if window else S
    attn = 0.0
    if cfg.family in ("dense", "vlm", "moe"):
        hd = cfg.hd() if cfg.attn_type != "mla" else (
            cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim)
        vd = cfg.hd() if cfg.attn_type != "mla" else cfg.mla.kv_lora_rank
        attn = cfg.n_layers * 2.0 * B * cfg.n_heads * eff * (hd + vd)
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // len(cfg.hybrid.pattern)
        lw = min(cfg.hybrid.local_window, S)
        attn = n_attn * 2.0 * B * cfg.n_heads * lw * 2 * cfg.hd()
        di = cfg.hybrid.d_rnn or cfg.d_model
        attn += (cfg.n_layers - n_attn) * 10.0 * B * di
    elif cfg.family == "ssm":
        s = cfg.ssm
        di = s.expand * cfg.d_model
        H = di // s.head_dim
        attn = cfg.n_layers * 4.0 * B * H * s.head_dim * s.d_state
    elif cfg.family == "audio":
        attn = cfg.n_layers * 2.0 * B * cfg.n_heads * (
            min(S, eff) + cfg.n_frames) * 2 * cfg.hd()
    fwd += attn
    return {"exec_flops": fwd, "fwd_flops": fwd,
            "model_flops": 2.0 * pc["active"] * B, "attn_flops": attn,
            "tokens": float(B), **pc}


def analytic(cfg: ModelConfig, shape: InputShape, kind: str,
             window: int = 0, remat: bool = True) -> Dict[str, float]:
    if kind == "train":
        return train_flops(cfg, shape, remat)
    if kind == "prefill":
        return prefill_flops(cfg, shape)
    return decode_flops(cfg, shape, window)


# -------------------------------------------------------------- HBM bytes

def hbm_bytes(cfg: ModelConfig, shape: InputShape, kind: str,
              n_agents: int = 1, K: int = 8, window: int = 0) -> float:
    """Leading-order HBM traffic per step (global, all chips): params read
    (+grad/opt write for train), KV cache read (decode), activations ~2x
    model bytes heuristic for train."""
    pc = param_counts(cfg)
    pbytes = pc["total"] * 2.0                      # bf16 weights
    if kind == "train":
        D = shape.global_batch * shape.seq_len
        act = 2.0 * D * cfg.d_model * 2.0 * max(cfg.n_layers, 1) * 4
        opt = pc["total"] * 4.0 * K * 2.0           # acc read+write fp32
        return n_agents * (3.0 * pbytes) + opt + act
    if kind == "prefill":
        D = shape.global_batch * shape.seq_len
        return pbytes + 2.0 * D * cfg.d_model * 2.0 * cfg.n_layers
    # decode: params + cache read
    B, S = shape.global_batch, shape.seq_len
    eff = min(window, S) if window else S
    if cfg.family == "ssm":
        s = cfg.ssm
        di = s.expand * cfg.d_model
        cache = cfg.n_layers * B * (di // s.head_dim) * s.head_dim * \
            s.d_state * 4.0
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // len(cfg.hybrid.pattern)
        cache = n_attn * B * min(cfg.hybrid.local_window, S) * \
            cfg.n_kv_heads * cfg.hd() * 2 * 2.0
        cache += (cfg.n_layers - n_attn) * B * \
            (cfg.hybrid.d_rnn or cfg.d_model) * 4.0
    elif cfg.attn_type == "mla":
        cache = cfg.n_layers * B * S * (cfg.mla.kv_lora_rank +
                                        cfg.mla.qk_rope_dim) * 2.0
    else:
        cache = cfg.n_layers * B * eff * cfg.n_kv_heads * cfg.hd() * 2 * 2.0
    return pbytes + cache
