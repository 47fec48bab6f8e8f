"""Attention, GQA half: the port of the JAX package's
``repro.models.attention`` (grouped-query attention with qk-norm, RoPE and a
sliding window; direct attention, and blockwise attention for long
sequences).

Blockwise ("memory-efficient") attention is an online-softmax loop over KV
chunks, used when the sequence exceeds ``cfg.attn_direct_max``, so a long
sequence never materialises an S x S score matrix; each KV step goes through
``torch.utils.checkpoint``, as the JAX code wraps it in ``jax.checkpoint``.
Both paths keep the JAX package's einsum formulation, so the tests compare
like with like.  One-token decode reads and writes a KV cache, a ring buffer
of window size under a sliding window; it takes one position per row, so
rows at different depths (continuous batching) share one call.

Tensor-parallel over the "model" axis (``distributed.sharding
.model_axis``), GQA runs on local heads: q over "heads", k and v over
"kv_heads" (or whole, where the axis does not divide the kv heads: each
local q head then takes kv group ``h // (H/G)`` of its global index h),
and the output projection's partial sums all-reduced
(``layers.row_parallel``).  Decode under
``serve_rules`` holds the cache split over its sequence slots ("kv_seq"),
every kv head on each rank: q and the new k and v are gathered for all
heads, each rank attends to its own span of slots, and the partial
softmaxes are combined by all-reduces of (max, sum, weighted values).

MLA (multi-head latent attention, minicpm3) trains in the naive form, the
latent expanded into per-head K and V, and decodes in the absorbed form
against a cache of the latent alone; the two round differently in bf16.
Tensor-parallel, MLA follows the JAX rules' layout: ``q_down``/``kv_down``
split on their columns, ``q_up``/``kv_up`` on their latent rows (heads
whole), ``wo_mla`` on its output.  The q latent stays split (its RMS norm
over every rank's squares); ``kv_down``'s contiguous column blocks may
straddle the latent and the rope part, so its output is gathered whole;
the up projections' partial products are summed over the axis; attention
runs on local heads where the axis divides them (else replicated); the
output's heads and ``wo_mla``'s columns are gathered.  Decode keeps the
latent cache split over its slots and combines the spans' softmaxes in
latent space.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as SH
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
    if q.is_meta:
        # shapes alone (the dry-run's steps): one chunk, no positions read
        chunk = max(Sq, Sk)
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
    skip = block_skip and (causal or window > 0) and not q.is_meta
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


def _tp_params(params, cfg: ModelConfig):
    """(the model axis, the attention's params with every replicated leaf
    through ``comm.copy_to_model``, whether k/v are whole) when the
    heads are split over the model axis here, else (None, params,
    None)."""
    tp = L.split_axis(params["wq"]["w"].shape[-2], cfg.n_heads)
    if tp is None:
        return None, params, None
    kv_whole = params["wk"]["w"].shape[-2] == cfg.n_kv_heads
    if not kv_whole and (params["wk"]["w"].shape[-2] * tp.size
                         != cfg.n_kv_heads):
        raise ValueError("kv heads split other than over the model axis")
    # a replicated leaf used on split heads: each rank's part of its
    # gradient, summed over the axis
    out = dict(params)
    for name in ("q_norm", "k_norm") + (("wk", "wv") if kv_whole else ()):
        if name in params:
            out[name] = {k: comm.copy_to_model(v, tp.group)
                         for k, v in params[name].items()}
    return tp, out, kv_whole


def _local_kv_groups(k, v, tp: SH.ModelAxis, H_loc: int, cfg: ModelConfig):
    """Whole k/v (…, G, hd) -> the group of each local q head (…, H_loc,
    hd): global head h takes group h // (H/G)."""
    groups = torch.div(tp.rank * H_loc + torch.arange(H_loc,
                                                      device=k.device),
                       cfg.n_heads // cfg.n_kv_heads, rounding_mode="floor")
    return k.index_select(-2, groups), v.index_select(-2, groups)


def self_attention(params, x, positions, cfg: ModelConfig,
                   causal: bool = True, window: int = 0) -> torch.Tensor:
    """Full-sequence self-attention (train / prefill)."""
    tp, params, kv_whole = _tp_params(params, cfg)
    if tp is not None:
        x = comm.copy_to_model(x, tp.group)
    q, k, v = _project_qkv(params, x, positions, cfg)
    if kv_whole:
        k, v = _local_kv_groups(k, v, tp, q.shape[-2], cfg)
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
    if tp is None:
        return torch.einsum("...hk,hkd->...d", o, params["wo"]["w"])
    wo = params["wo"]["w"]
    return L.row_parallel(o.reshape(o.shape[:-2] + (-1,)),
                          wo.reshape(-1, wo.shape[-1]), tp)


# ----------------------------------------------------------------- decode

class KVCache(NamedTuple):
    k: torch.Tensor       # (..., B, Scache, G, hd)
    v: torch.Tensor
    # Scache = window size when windowed (ring buffer), else max seq len.


def init_cache(cfg: ModelConfig, batch: int, max_len: int, window: int,
               dtype, lead: tuple = (), device=None) -> KVCache:
    size = min(window, max_len) if window > 0 else max_len
    shape = tuple(lead) + (batch, size, cfg.n_kv_heads, cfg.hd())
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


class DecodeContext(NamedTuple):
    """What every layer of one decode step shares: the RoPE tables at each
    row's position, the cache slot each row writes, and each row's mask
    over the cache."""
    rope: Optional[tuple]     # (cos, sin), or None when nothing rotates
    rows: torch.Tensor        # (B,) 0..B-1
    slot: torch.Tensor        # (B,) the slot each row writes
    bias: torch.Tensor        # (B, Scache) additive mask, float32


def decode_context(pos: torch.Tensor, cache_len: int, cfg: ModelConfig,
                   window: int = 0) -> DecodeContext:
    p = pos[:, None]                                          # (B, 1)
    # without a window, a position past the cache writes its last slot, as
    # the JAX package's dynamic_update_slice clamps its start
    slot = pos % cache_len if window > 0 else pos.clamp(max=cache_len - 1)
    # absolute position held by each slot, per row
    idx = torch.arange(cache_len, device=pos.device)
    if window > 0:
        # ring buffer: slot s holds the largest q <= pos with q % Sc == s
        k_pos = p - (p - idx) % cache_len
    else:
        k_pos = idx.expand(pos.shape[0], cache_len)
    valid = (k_pos <= p) & (k_pos >= 0)
    if window > 0:
        valid &= k_pos > p - window
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    return DecodeContext(
        L.rope_tables(p, cfg.hd(), cfg.rope_theta, cfg.rope_fraction),
        torch.arange(pos.shape[0], device=pos.device), slot,
        torch.where(valid, zero, torch.full_like(zero, NEG_INF)))


def _tp_decode_attention(params, x, cache: KVCache, cfg: ModelConfig,
                         ctx: DecodeContext, tp: Optional[SH.ModelAxis],
                         seq: Optional[SH.SeqSplit]):
    """``decode_attention`` with the heads split over the model axis (or
    whole where ``tp`` is None: the axis does not divide them) and the
    cache's slots over ``seq`` (every kv head on each rank): q and the new
    k/v are gathered for all heads (one all-reduce of a zero-padded
    buffer), each rank writes the new slot when it holds it and attends to
    its own span, and the partial softmaxes are combined."""
    B, _, d = x.shape
    H, G, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    H_loc, G_loc = params["wq"]["w"].shape[-2], params["wk"]["w"].shape[-2]
    x2 = x.view(B, d)
    q = (x2 @ params["wq"]["w"].reshape(d, H_loc * hd)).view(B, 1, H_loc, hd)
    k_new = (x2 @ params["wk"]["w"].reshape(d, G_loc * hd)).view(
        B, 1, G_loc, hd)
    v_new = (x2 @ params["wv"]["w"].reshape(d, G_loc * hd)).view(
        B, 1, G_loc, hd)
    if cfg.qk_norm:
        q = L.rmsnorm_nd(params["q_norm"]["scale"], q, cfg.norm_eps)
        k_new = L.rmsnorm_nd(params["k_norm"]["scale"], k_new, cfg.norm_eps)
    q = L.apply_rope(q, None, cfg.rope_theta, cfg.rope_fraction, ctx.rope)
    k_new = L.apply_rope(k_new, None, cfg.rope_theta, cfg.rope_fraction,
                         ctx.rope)
    # every head's q, k and v: each rank fills its own heads of a zeroed
    # buffer (k and v only where they are split), summed over the axis
    parts = [] if tp is None else [(q, H)] + (
        [] if G_loc == G else [(k_new, G), (v_new, G)])
    if parts:
        width = sum(n for _, n in parts)
        buf = torch.zeros((B, width, hd), dtype=torch.float32,
                          device=x.device)
        off = 0
        for t, n in parts:
            m = t.shape[2]
            buf[:, off + tp.rank * m:off + (tp.rank + 1) * m] = t[:, 0]
            off += n
        buf = comm.all_reduce_sum(buf, tp.group).to(x.dtype)
        q = buf[:, :H]
    else:
        q = q[:, 0]
    if G_loc != G:
        k_new, v_new = buf[:, H:H + G], buf[:, H + G:]
    else:
        k_new, v_new = k_new[:, 0], v_new[:, 0]
    # the new slot, written by the rank whose span holds it (the others
    # write back what they hold)
    S_loc = cache.k.shape[1]
    lo = 0 if seq is None else seq.index * S_loc
    local = ctx.slot - lo
    own = ((local >= 0) & (local < S_loc))[:, None, None]
    idx = (ctx.rows, local.clamp(0, S_loc - 1))
    k = cache.k.index_put(idx, torch.where(own, k_new.to(cache.k.dtype),
                                           cache.k[idx]))
    v = cache.v.index_put(idx, torch.where(own, v_new.to(cache.v.dtype),
                                           cache.v[idx]))
    qg = q.reshape(B, G, H // G, hd)                         # (b, g, r, h)
    s = torch.matmul(qg, k.permute(0, 2, 3, 1)).float()      # (b, g, r, t)
    s = s / np.sqrt(hd) + ctx.bias[:, None, None, lo:lo + S_loc]
    m = s.amax(dim=-1)                                       # (b, g, r)
    if seq is not None:
        m_all = comm.all_reduce_max(m.clone(), seq.group)
    else:
        m_all = m
    p = torch.exp(s - m[..., None])
    acc = torch.matmul(p.to(v.dtype), v.transpose(1, 2)).float()
    if seq is not None:
        scale = _partial_scale(m, m_all)
        packed = torch.cat([(p.sum(dim=-1) * scale)[..., None],
                            acc * scale[..., None]], dim=-1)
        packed = comm.all_reduce_sum(packed, seq.group)
        l, acc = packed[..., 0], packed[..., 1:]
    else:
        l = p.sum(dim=-1)
    o = (acc / l[..., None]).to(v.dtype).reshape(B, H, hd)
    if tp is None:             # every head here: the whole output
        out = o.reshape(B, H * hd) @ params["wo"]["w"].reshape(H * hd, d)
        return out.view(B, 1, d), KVCache(k, v)
    o = o[:, tp.rank * H_loc:(tp.rank + 1) * H_loc].reshape(B, H_loc * hd)
    out = L.row_parallel(o, params["wo"]["w"].reshape(H_loc * hd, d), tp)
    return out.view(B, 1, d), KVCache(k, v)


def _partial_scale(m: torch.Tensor, m_all: torch.Tensor) -> torch.Tensor:
    """The factor that puts a span's softmax terms, taken against its own
    max ``m``, on the common max ``m_all``."""
    return torch.exp(m - m_all)


def decode_attention(params, x, cache: KVCache, pos: torch.Tensor,
                     cfg: ModelConfig, ctx: DecodeContext):
    """One-token decode.  x: (B,1,d); pos: (B,) the position of each row;
    ``ctx``: ``decode_context(pos, cache length, cfg, window)``, shared by
    a step's layers.  Returns (out (B,1,d), new cache); ``cache`` is not
    written, so a caller can keep the old bytes of rows it does not
    advance."""
    tp = L.split_axis(params["wq"]["w"].shape[-2], cfg.n_heads)
    seq = SH.kv_seq_split() if SH.model_axis() is not None else None
    if tp is not None or seq is not None:
        return _tp_decode_attention(params, x, cache, cfg, ctx, tp, seq)
    # the products as plain matmuls on views: one token a row makes the
    # host's dispatch the step's cost, and an einsum dispatches several
    # reshapes per product
    B, _, d = x.shape
    H, G, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    x2 = x.view(B, d)
    q = (x2 @ params["wq"]["w"].view(d, H * hd)).view(B, 1, H, hd)
    k_new = (x2 @ params["wk"]["w"].view(d, G * hd)).view(B, 1, G, hd)
    v_new = (x2 @ params["wv"]["w"].view(d, G * hd)).view(B, G, hd)
    if cfg.qk_norm:
        q = L.rmsnorm_nd(params["q_norm"]["scale"], q, cfg.norm_eps)
        k_new = L.rmsnorm_nd(params["k_norm"]["scale"], k_new, cfg.norm_eps)
    p = pos[:, None]
    q = L.apply_rope(q, p, cfg.rope_theta, cfg.rope_fraction, ctx.rope)
    k_new = L.apply_rope(k_new, p, cfg.rope_theta, cfg.rope_fraction,
                         ctx.rope)
    idx = (ctx.rows, ctx.slot)
    k = cache.k.index_put(idx, k_new.view(B, G, hd).to(cache.k.dtype))
    v = cache.v.index_put(idx, v_new.to(cache.v.dtype))
    qg = q.view(B, G, H // G, hd)                            # (b, g, r, h)
    s = torch.matmul(qg, k.permute(0, 2, 3, 1)).float()      # (b, g, r, t)
    s = s / np.sqrt(hd) + ctx.bias[:, None, None, :]
    pr = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.matmul(pr, v.transpose(1, 2))                  # (b, g, r, h)
    out = o.reshape(B, H * hd) @ params["wo"]["w"].view(H * hd, d)
    return out.view(B, 1, d), KVCache(k, v)


# ================================================================== MLA

def mla_init(gen, cfg: ModelConfig, lead: tuple = (), device=None) -> dict:
    dt = L.dtype_of(cfg.param_dtype)
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    kw = dict(dtype=dt, lead=lead, device=device)
    return {
        "q_down": {"w": L.dense_init(gen, d, m.q_lora_rank, **kw)},
        "q_norm": L.rmsnorm_init(m.q_lora_rank, dt, lead, device),
        "q_up": {"w": L.dense_init(gen, m.q_lora_rank, H, qk_dim, **kw)},
        "kv_down": {"w": L.dense_init(gen, d, m.kv_lora_rank + m.qk_rope_dim,
                                      **kw)},
        "kv_norm": L.rmsnorm_init(m.kv_lora_rank, dt, lead, device),
        "kv_up": {"w": L.dense_init(gen, m.kv_lora_rank, H,
                                    m.qk_nope_dim + m.v_head_dim, **kw)},
        "wo_mla": {"w": L.dense_init(gen, H, m.v_head_dim, d, **kw)},
    }


def _mla_qkv_latent(params, x, positions, cfg: ModelConfig, tables=None):
    """x: (..., S, d) -> q_nope (..., S, H, nope), q_rope (..., S, H, rope),
    the latent c_kv (..., S, r) and k_rope (..., S, rope): one rotation of
    k_rope, shared by every head.  ``tables``: ``rope_tables`` of
    ``positions`` at the rope dim, computed once for several layers."""
    m = cfg.mla
    H, r = cfg.n_heads, m.kv_lora_rank
    qk = m.qk_nope_dim + m.qk_rope_dim
    cq = L.rmsnorm(params["q_norm"], x @ params["q_down"]["w"], cfg.norm_eps)
    q = (cq @ params["q_up"]["w"].reshape(m.q_lora_rank, H * qk)).reshape(
        x.shape[:-1] + (H, qk))
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta, tables=tables)
    ckv_full = x @ params["kv_down"]["w"]
    c_kv = L.rmsnorm(params["kv_norm"], ckv_full[..., :r], cfg.norm_eps)
    k_rope = L.apply_rope(ckv_full[..., None, r:], positions, cfg.rope_theta,
                          tables=tables)[..., 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mla_axis(params, cfg: ModelConfig) -> Optional[SH.ModelAxis]:
    """The model axis when MLA's latent projections are split over it here
    (``q_down``/``kv_down`` on their columns, ``q_up``/``kv_up`` on their
    latent rows, ``wo_mla`` on its output), else None."""
    m = cfg.mla
    tp = L.split_axis(params["q_down"]["w"].shape[-1], m.q_lora_rank)
    kv = L.split_axis(params["kv_down"]["w"].shape[-1],
                      m.kv_lora_rank + m.qk_rope_dim)
    if (tp is None) != (kv is None):
        raise ValueError("MLA's q and kv latents split differently")
    return tp


def _kv_latent(ckv, tp: SH.ModelAxis, r: int):
    """(the latent (..., r), the rope part (..., rope)) of ``kv_down``'s
    output, of which ``ckv`` is this rank's contiguous block of columns: a
    block may hold latent and rope columns both, so every rank takes the
    whole output (one all-gather)."""
    full = comm.gather_from_model(ckv, -1, tp.group)
    return full[..., :r], full[..., r:]


def _tp_mla_qkv_latent(params, x, positions, cfg: ModelConfig,
                       tp: SH.ModelAxis, tables=None):
    """``_mla_qkv_latent`` on this rank's shards: the q latent stays split
    (its RMS norm over every rank's squares) and ``q_up``'s partial
    products are summed over the axis; the kv latent and ``k_rope`` are
    gathered whole.  Every output is whole on each rank."""
    m = cfg.mla
    H, r = cfg.n_heads, m.kv_lora_rank
    qk = m.qk_nope_dim + m.qk_rope_dim
    x = comm.copy_to_model(x, tp.group)
    cq = L.rmsnorm_split(params["q_norm"], x @ params["q_down"]["w"],
                         cfg.norm_eps)
    w = params["q_up"]["w"]
    q = L.row_parallel(cq, w.reshape(w.shape[0], H * qk), tp).reshape(
        x.shape[:-1] + (H, qk))
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta, tables=tables)
    c_raw, kr_raw = _kv_latent(x @ params["kv_down"]["w"], tp, r)
    c_kv = L.rmsnorm(params["kv_norm"], c_raw, cfg.norm_eps)
    k_rope = L.apply_rope(kr_raw[..., None, :], positions, cfg.rope_theta,
                          tables=tables)[..., 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _latent_rows(c_kv, w, tp: SH.ModelAxis):
    """This rank's rows of the whole latent ``c_kv`` for ``w``, a leaf split
    on its latent rows (``kv_up``)."""
    n = w.shape[0]
    return c_kv[..., tp.rank * n:(tp.rank + 1) * n]


def _tp_mla_attention(params, x, positions, cfg: ModelConfig,
                      tp: SH.ModelAxis) -> torch.Tensor:
    """``mla_attention`` on this rank's shards: ``kv_up``'s partial products
    summed over the axis, attention on the local heads where the axis
    divides them (else on every head, replicated), then the heads of the
    output gathered, ``wo_mla``'s columns of it taken here and gathered."""
    m = cfg.mla
    H, g = cfg.n_heads, tp.group
    q_nope, q_rope, c_kv, k_rope = _tp_mla_qkv_latent(params, x, positions,
                                                      cfg, tp)
    w = params["kv_up"]["w"]
    c_loc = _latent_rows(comm.copy_to_model(c_kv, g), w, tp)
    kv = L.row_parallel(c_loc, w.reshape(w.shape[0], -1), tp).reshape(
        c_kv.shape[:-1] + (H, m.qk_nope_dim + m.v_head_dim))
    split = H % tp.size == 0
    if split:
        h = H // tp.size
        heads = slice(tp.rank * h, (tp.rank + 1) * h)
        q_nope, q_rope, kv = (comm.copy_to_model(t, g)[..., heads, :]
                              for t in (q_nope, q_rope, kv))
        k_rope = comm.copy_to_model(k_rope, g)
    o = _mla_core(q_nope, q_rope, kv, k_rope, positions, cfg, x.shape[-2])
    if split:
        o = comm.gather_from_model(o, -2, g)
    out = torch.einsum("...hk,hkd->...d", comm.copy_to_model(o, g),
                       params["wo_mla"]["w"])
    return comm.gather_from_model(out, -1, g)


def _mla_core(q_nope, q_rope, kv, k_rope, positions, cfg: ModelConfig,
              S: int) -> torch.Tensor:
    """Causal attention of the naive form over the heads of ``q_nope``:
    (…, S, h, v)."""
    m = cfg.mla
    k_nope, v = kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]
    k_rope_h = k_rope[..., None, :].expand(k_rope.shape[:-1]
                                           + (q_nope.shape[-2],
                                              m.qk_rope_dim))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    if S <= cfg.attn_direct_max:
        bias = _mask_bias(positions, positions, True, 0)
        while bias.dim() < 4:
            bias = bias[None]
        return _direct_attn(q, k, v, bias)
    pos1d = positions.reshape(-1)[-S:] if positions.dim() > 1 else positions
    return _blockwise_attn(q, k, v, pos1d, pos1d, True, 0, cfg.attn_chunk)


def mla_attention(params, x, positions, cfg: ModelConfig) -> torch.Tensor:
    """Train/prefill MLA: expand the latent into per-head K/V (the naive
    form).  v's head dim may differ from q/k's; the softmax scale is
    1/sqrt(nope + rope) on both paths."""
    tp = _mla_axis(params, cfg)
    if tp is not None:
        return _tp_mla_attention(params, x, positions, cfg, tp)
    m = cfg.mla
    H = cfg.n_heads
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_latent(params, x, positions, cfg)
    kv = (c_kv @ params["kv_up"]["w"].reshape(m.kv_lora_rank, -1)).reshape(
        c_kv.shape[:-1] + (H, m.qk_nope_dim + m.v_head_dim))
    o = _mla_core(q_nope, q_rope, kv, k_rope, positions, cfg, x.shape[-2])
    return torch.einsum("...hk,hkd->...d", o, params["wo_mla"]["w"])


class MLACache(NamedTuple):
    c_kv: torch.Tensor       # (..., B, S, kv_lora_rank): the latent
    k_rope: torch.Tensor     # (..., B, S, qk_rope_dim)


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   lead: tuple = (), device=None) -> MLACache:
    m = cfg.mla
    shape = tuple(lead) + (batch, max_len)
    return MLACache(
        torch.zeros(shape + (m.kv_lora_rank,), dtype=dtype, device=device),
        torch.zeros(shape + (m.qk_rope_dim,), dtype=dtype, device=device))


def mla_decode_context(pos: torch.Tensor, cache_len: int, cfg: ModelConfig,
                       window: int = 0) -> DecodeContext:
    """``decode_context`` for MLA: RoPE at the rope dim, each row writing
    slot ``pos`` of a cache as long as the sequence (the JAX package's MLA
    cache has no ring), masked past ``pos`` and outside the window."""
    p = pos[:, None]
    idx = torch.arange(cache_len, device=pos.device)
    valid = idx <= p
    if window > 0:
        valid &= idx > p - window
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    return DecodeContext(
        L.rope_tables(p, cfg.mla.qk_rope_dim, cfg.rope_theta),
        torch.arange(pos.shape[0], device=pos.device), pos,
        torch.where(valid, zero, torch.full_like(zero, NEG_INF)))


def mla_decode(params, x, cache: MLACache, pos: torch.Tensor,
               cfg: ModelConfig, ctx: DecodeContext):
    """Absorbed-form MLA decode against the latent cache: W_UK is absorbed
    into q, so scores are taken in the kv_lora_rank space and the cache
    holds rank + rope_dim numbers a token.  x: (B,1,d); pos: (B,);
    ``ctx``: ``mla_decode_context``.  Returns (out (B,1,d), new cache);
    ``cache`` is not written."""
    tp = _mla_axis(params, cfg)
    if tp is not None:
        return _tp_mla_decode(params, x, cache, pos, cfg, ctx, tp,
                              SH.kv_seq_split())
    m = cfg.mla
    B, _, d = x.shape
    H, nope, vd = cfg.n_heads, m.qk_nope_dim, m.v_head_dim
    q_nope, q_rope, c_new, kr_new = _mla_qkv_latent(
        params, x, pos[:, None], cfg, ctx.rope)
    idx = (ctx.rows, ctx.slot)
    c_kv = cache.c_kv.index_put(idx, c_new[:, 0].to(cache.c_kv.dtype))
    k_rope = cache.k_rope.index_put(idx, kr_new[:, 0].to(cache.k_rope.dtype))
    w = params["kv_up"]["w"]                             # (r, H, nope + v)
    w_uk = w[..., :nope].permute(1, 2, 0)                # (H, nope, r)
    w_uv = w[..., nope:].transpose(0, 1)                 # (H, r, v)
    # the absorbed q, (H, B, r) -> (B, H, r)
    q_abs = torch.matmul(q_nope.view(B, H, nope).transpose(0, 1),
                         w_uk).transpose(0, 1)
    s = (torch.matmul(q_abs, c_kv.transpose(1, 2))
         + torch.matmul(q_rope.view(B, H, -1), k_rope.transpose(1, 2))
         ).float()                                        # (B, H, T)
    s = s / np.sqrt(nope + m.qk_rope_dim) + ctx.bias[:, None, :]
    p = torch.softmax(s, dim=-1).to(c_kv.dtype)
    o_lat = torch.matmul(p, c_kv)                        # (B, H, r)
    o = torch.matmul(o_lat.transpose(0, 1), w_uv)        # (H, B, v)
    out = o.transpose(0, 1).reshape(B, H * vd) @ params["wo_mla"]["w"].view(
        H * vd, d)
    return out.view(B, 1, d), MLACache(c_kv, k_rope)


def _tp_mla_decode(params, x, cache: MLACache, pos, cfg: ModelConfig,
                   ctx: DecodeContext, tp: SH.ModelAxis,
                   seq: Optional[SH.SeqSplit]):
    """``mla_decode`` on this rank's shards, the cache's slots split over
    ``seq``: q and the new latent whole on every rank
    (``_tp_mla_qkv_latent``), the new slot written by the rank whose span
    holds it, the absorbed q's latent columns gathered, scores and values
    taken over the local span in latent space and combined as
    ``_tp_decode_attention`` combines them, then ``kv_up``'s value rows
    and ``wo_mla``'s columns as in ``_tp_mla_attention``."""
    m = cfg.mla
    B, _, d = x.shape
    H, nope, g = cfg.n_heads, m.qk_nope_dim, tp.group
    q_nope, q_rope, c_new, kr_new = _tp_mla_qkv_latent(
        params, x, pos[:, None], cfg, tp, ctx.rope)
    S_loc = cache.c_kv.shape[1]
    lo = 0 if seq is None else seq.index * S_loc
    local = ctx.slot - lo
    own = ((local >= 0) & (local < S_loc))[:, None]
    idx = (ctx.rows, local.clamp(0, S_loc - 1))
    c_kv = cache.c_kv.index_put(idx, torch.where(
        own, c_new[:, 0].to(cache.c_kv.dtype), cache.c_kv[idx]))
    k_rope = cache.k_rope.index_put(idx, torch.where(
        own, kr_new[:, 0].to(cache.k_rope.dtype), cache.k_rope[idx]))
    w = params["kv_up"]["w"]                         # (r/m, H, nope + v)
    w_uk = w[..., :nope].permute(1, 2, 0)            # (H, nope, r/m)
    w_uv = w[..., nope:].transpose(0, 1)             # (H, r/m, v)
    q_abs = torch.matmul(q_nope.view(B, H, nope).transpose(0, 1),
                         w_uk).transpose(0, 1)       # (B, H, r/m)
    q_abs = comm.gather_from_model(q_abs, -1, g)     # (B, H, r)
    s_rope = torch.matmul(q_rope.view(B, H, -1), k_rope.transpose(1, 2))
    s = (torch.matmul(q_abs, c_kv.transpose(1, 2))
         + s_rope).float()                           # (B, H, T_loc)
    s = s / np.sqrt(nope + m.qk_rope_dim) + ctx.bias[:, None, lo:lo + S_loc]
    mx = s.amax(dim=-1)
    p = torch.exp(s - mx[..., None])
    acc = torch.matmul(p.to(c_kv.dtype), c_kv).float()   # (B, H, r)
    if seq is not None:
        scale = _partial_scale(mx, comm.all_reduce_max(mx.clone(), seq.group))
        packed = comm.all_reduce_sum(torch.cat(
            [(p.sum(dim=-1) * scale)[..., None], acc * scale[..., None]],
            dim=-1), seq.group)
        l, acc = packed[..., 0], packed[..., 1:]
    else:
        l = p.sum(dim=-1)
    o_lat = (acc / l[..., None]).to(c_kv.dtype)
    # this rank's latent rows of the values, the partial products in f32
    o = comm.reduce_from_model(torch.matmul(
        _latent_rows(o_lat, w, tp).transpose(0, 1).float(), w_uv.float()),
        g).to(o_lat.dtype)                           # (H, B, v)
    o = o.transpose(0, 1).reshape(B, -1)
    out = o @ params["wo_mla"]["w"].reshape(o.shape[-1], -1)
    return (comm.gather_from_model(out, -1, g).view(B, 1, d),
            MLACache(c_kv, k_rope))
