"""Attention, GQA half: the port of the JAX package's
``repro.models.attention`` (grouped-query attention with qk-norm, RoPE and a
sliding window; direct attention, and blockwise attention for long
sequences).

Blockwise ("memory-efficient") attention is an online-softmax loop over KV
chunks, used when the sequence exceeds ``cfg.attn_direct_max``, so a long
sequence never materialises an S x S score matrix; each KV step goes through
``torch.utils.checkpoint``, as the JAX code wraps it in ``jax.checkpoint``.
Both paths keep the JAX package's einsum formulation, so the tests compare
like with like.  KV-cache decode and MLA are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

NEG_INF = -1e30


def gqa_init(gen, cfg: ModelConfig, lead: tuple = (), device=None) -> dict:
    dt = L.dtype_of(cfg.param_dtype)
    d, H, G, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    kw = dict(dtype=dt, lead=lead, device=device)
    p = {"wq": {"w": L.dense_init(gen, d, H, hd, **kw)},
         "wk": {"w": L.dense_init(gen, d, G, hd, **kw)},
         "wv": {"w": L.dense_init(gen, d, G, hd, **kw)},
         "wo": {"w": L.dense_init(gen, H, hd, d, **kw)}}
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(hd, dt, lead, device)
        p["k_norm"] = L.rmsnorm_init(hd, dt, lead, device)
    return p


def _project_qkv(params, x, positions, cfg: ModelConfig, rope: bool = True):
    q = torch.einsum("...d,dhk->...hk", x, params["wq"]["w"])
    k = torch.einsum("...d,dgk->...gk", x, params["wk"]["w"])
    v = torch.einsum("...d,dgk->...gk", x, params["wv"]["w"])
    if cfg.qk_norm:
        q = L.rmsnorm_nd(params["q_norm"]["scale"], q, cfg.norm_eps)
        k = L.rmsnorm_nd(params["k_norm"]["scale"], k, cfg.norm_eps)
    if rope:
        q = L.apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = L.apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def _mask_bias(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    """(…, Sq, Sk) additive bias from absolute positions."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window > 0:
        ok &= d < window
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _direct_attn(q, k, v, bias):
    """q:(B,Sq,H,hd) k:(B,Sk,G,hd) v:(B,Sk,G,vd) bias:(B|1,1,Sq,Sk)
    -> (B,Sq,H,vd)."""
    B, Sq, H, hd = q.shape
    G, vd = k.shape[2], v.shape[-1]
    qg = q.reshape(B, Sq, G, H // G, hd)
    s = torch.einsum("bsgrh,btgh->bgrst", qg, k).float()
    s = s / np.sqrt(hd) + bias[:, :, None]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bgrst,btgh->bsgrh", p, v)
    return o.reshape(B, Sq, H, vd)


def _kv_step(m, l, acc, qb, kb, vb, qpb, kpb, causal, window, scale):
    """One online-softmax step of a Q chunk over one KV chunk."""
    s = torch.einsum("bshk,bthk->bhst", qb, kb).float() * scale
    s = s + _mask_bias(qpb, kpb, causal, window)[None, None]
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhst,bthk->bhsk", p, vb.float())
    return m_new, l_new, acc_new


def _blockwise_attn(q, k, v, q_pos, k_pos, causal, window, chunk,
                    block_skip: bool = True):
    """Flash-style online-softmax attention, looping KV chunks per Q chunk.

    GQA KV heads are broadcast to the full H head dim before the loop, as
    in the JAX code.  ``block_skip`` skips fully-masked KV chunks (the upper
    triangle under causal masking, chunks outside the sliding window).  The
    decision is taken on the host from the chunks' position ranges: one
    small device-to-host copy per call.
    """
    B, Sq, H, hd = q.shape
    Sk, G, vd = k.shape[1], k.shape[2], v.shape[-1]
    if G != H:
        k = torch.repeat_interleave(k, H // G, dim=2)
        v = torch.repeat_interleave(v, H // G, dim=2)
    cq = min(chunk, Sq)
    ck = min(chunk, Sk)
    nq, nk = Sq // cq, Sk // ck
    if Sq % cq or Sk % ck:
        raise ValueError(f"seq ({Sq}, {Sk}) must divide attn chunk {chunk}")
    qg = q.reshape(B, nq, cq, H, hd)
    kc = k.reshape(B, nk, ck, H, hd)
    vc = v.reshape(B, nk, ck, H, vd)
    qp = q_pos.reshape(nq, cq)
    kp = k_pos.reshape(nk, ck)
    scale = 1.0 / np.sqrt(hd)
    skip = block_skip and (causal or window > 0)
    if skip:
        ranges = torch.cat([qp.amin(1), qp.amax(1), kp.amin(1),
                            kp.amax(1)]).tolist()
        qmin, qmax = ranges[:nq], ranges[nq:2 * nq]
        kmin, kmax = ranges[2 * nq:2 * nq + nk], ranges[2 * nq + nk:]

    outs = []
    for qi in range(nq):
        qb, qpb = qg[:, qi], qp[qi]
        m = torch.full((B, H, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, cq, vd), dtype=torch.float32,
                          device=q.device)
        for kj in range(nk):
            if skip:
                reachable = kmin[kj] <= qmax[qi]
                if window > 0:
                    reachable &= kmax[kj] > qmin[qi] - window
                if not reachable:
                    continue
            m, l, acc = checkpoint(_kv_step, m, l, acc, qb, kc[:, kj],
                                   vc[:, kj], qpb, kp[kj], causal, window,
                                   scale, use_reentrant=False)
        out = acc / torch.clamp(l, min=1e-30)[..., None]     # (B,H,cq,vd)
        outs.append(out.transpose(1, 2))                     # (B,cq,H,vd)
    out = torch.stack(outs, dim=1).reshape(B, Sq, H, vd)
    return out.to(v.dtype)


def self_attention(params, x, positions, cfg: ModelConfig,
                   causal: bool = True, window: int = 0) -> torch.Tensor:
    """Full-sequence self-attention (train / prefill)."""
    q, k, v = _project_qkv(params, x, positions, cfg)
    S = x.shape[-2]
    if S <= cfg.attn_direct_max:
        bias = _mask_bias(positions, positions, causal, window)
        while bias.dim() < 4:
            bias = bias[None]
        o = _direct_attn(q, k, v, bias)
    else:
        pos1d = (positions.reshape(-1)[-S:] if positions.dim() > 1
                 else positions)
        o = _blockwise_attn(q, k, v, pos1d, pos1d, causal, window,
                            cfg.attn_chunk)
    return torch.einsum("...hk,hkd->...d", o, params["wo"]["w"])
