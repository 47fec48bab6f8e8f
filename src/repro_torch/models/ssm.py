"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block: the port of
the JAX package's ``repro.models.ssm``.

Training and the full-sequence forward use the chunked SSD algorithm:
quadratic attention-like computation inside chunks and a linear recurrence
over chunk states (the matrix form of the scan).  Decode is the O(1)
recurrent state update.

Shapes follow the minimal SSD reference: x:(B,S,H,P), dt:(B,S,H), A:(H,),
B/C:(B,S,G,N) with H/G heads per group.  The JAX code contracts three and
four operands in one einsum, whose pairwise order is then up to the
backend (``opt_einsum`` where it is installed, left to right where not);
here each is written as products of two operands in one fixed order, so
the rounding and the intermediates' sizes do not depend on what is
installed.  ``A_log``, ``D`` and ``dt_bias``, the softplus of ``dt``, the
decode conv and the recurrent state stay float32 whatever ``param_dtype``
says.

Under an active mesh whose "model" axis is wider than 1 the mixer runs
tensor-parallel on each rank's local shards, as the JAX package's rules
lay them out: ``in_proj``'s columns and the conv's channels split over
"mlp", each rank's heads (the JAX code shards ``x`` over "mlp" on its head
dim) and their ``d_inner`` channels, and ``out_proj``'s rows.  The three
splits do not line up: a rank's block of the concatenated ``z|x|B|C|dt``
columns straddles the parts, and its block of conv channels is not its
heads' (B and C, which every head reads, sit on the last rank).  So the
projection's output is gathered whole (one exact all-gather), and so is
the conv weight; each rank then takes what its heads read: their z, x and
dt channels and every B and C channel, the conv over those channels, and
its slice of the replicated ``A_log``, ``D``, ``dt_bias`` and conv bias.
Each gathered or replicated tensor of which the ranks read different parts
goes through ``copy_to_model``, so the backward sums the ranks' gradients
before a split leaf takes its slice.  The SSD scan runs on the local heads
alone; the gated norm is taken over the full ``d_inner``
(``layers.rmsnorm_split``) and ``out_proj``'s partial products are summed
(``layers.row_parallel``).  Decode keeps the conv window in the cache's
layout (``cache_specs``: this rank's block of conv channels): each step
gathers the window whole, convolves the channels its heads read, and keeps
its own block of the new window; the SSM state is split over heads.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L


def _d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def _n_heads(cfg: ModelConfig) -> int:
    return _d_inner(cfg) // cfg.ssm.head_dim


def mamba_init(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (),
               device=None) -> dict:
    """Random mixer parameters; ``lead`` prefixes every leaf with stacked
    independent draws (layers, agents)."""
    dt = L.dtype_of(cfg.param_dtype)
    s = cfg.ssm
    d, di = cfg.d_model, _d_inner(cfg)
    H, G, N = _n_heads(cfg), s.n_groups, s.d_state
    conv_ch = di + 2 * G * N
    lead = tuple(lead)
    kw = dict(dtype=dt, lead=lead, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.empty(lead + (H,), **f32).uniform_(
        float(np.log(1e-3)), float(np.log(1e-1)), generator=gen)
    conv_w = torch.randn(lead + (s.conv_width, conv_ch), generator=gen,
                         **f32) * 0.1
    return {
        "in_proj": {"w": L.dense_init(gen, d, 2 * di + 2 * G * N + H, **kw)},
        "conv": {"w": conv_w.to(dt),
                 "b": torch.zeros(lead + (conv_ch,), dtype=dt,
                                  device=device)},
        "A_log": torch.log(torch.arange(1, H + 1, **f32)).expand(
            lead + (H,)).clone(),
        "D": torch.ones(lead + (H,), **f32),
        # softplus^-1 of U[1e-3, 1e-1]
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "norm": L.rmsnorm_init(di, dt, lead, device),
        "out_proj": {"w": L.dense_init(gen, di, d, **kw)},
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq. x:(B,S,C), w:(W,C)."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W))
    return L.silu(out + b)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T) -> (..., T, T) with out[i,j] = sum_{j<k<=i} x[k], -inf
    above the diagonal; exp(segsum) is the 1-semiseparable decay matrix."""
    T = x.shape[-1]
    xx = x[..., :, None].expand(x.shape + (T,))               # xx[i,j]=x[i]
    below = torch.ones((T, T), dtype=torch.bool, device=x.device)
    xx = torch.where(below.tril(-1), xx, 0.0)
    seg = torch.cumsum(xx, dim=-2)                            # sum_{j<r<=i}
    return torch.where(below.tril(), seg, -torch.inf)


def ssd_chunked(x, dA, Bm, Cm, chunk: int):
    """Chunked SSD.  x:(B,S,H,P) (already dt-weighted), dA:(B,S,H) log-decay
    per step, Bm/Cm:(B,S,G,N).  Returns y:(B,S,H,P), final_state:(B,H,P,N),
    both float32."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} must divide the SSD chunk {Q}")
    c = S // Q
    R = H // G
    xg = x.float().reshape(Bsz, c, Q, G, R, P)
    Ab = dA.reshape(Bsz, c, Q, H).permute(0, 3, 1, 2)         # (B,H,c,Q)
    Bb = Bm.float().reshape(Bsz, c, Q, G, N)
    Cb = Cm.float().reshape(Bsz, c, Q, G, N)
    A_cs = torch.cumsum(Ab, dim=-1)                           # (B,H,c,Q)

    # intra-chunk (diagonal blocks): ((C B^T) * L) x
    Lg = torch.exp(_segsum(Ab)).reshape(Bsz, G, R, c, Q, Q)
    CB = torch.einsum("bclgn,bcsgn->bcgls", Cb, Bb)           # (B,c,G,Q,Q)
    CBL = CB[:, :, :, None] * Lg.permute(0, 3, 1, 2, 4, 5)     # (B,c,G,R,Q,Q)
    Y_diag = torch.einsum("bcgrls,bcsgrp->bclgrp", CBL, xg)

    # chunk states: B^T (decay * x)
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)           # (B,H,c,Q)
    dsg = decay_states.reshape(Bsz, G, R, c, Q).permute(0, 3, 4, 1, 2)
    states = torch.einsum("bclgn,bclgrp->bcgrpn", Bb, xg * dsg[..., None])

    # inter-chunk recurrence (1-SS matmul over chunk index)
    chunk_sum = A_cs[..., -1]                                 # (B,H,c)
    decay_chunk = torch.exp(_segsum(F.pad(chunk_sum, (1, 0))))
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    dch = decay_chunk.reshape(Bsz, G, R, c + 1, c + 1)
    new_states = torch.einsum("bgrzc,bcgrpn->bzgrpn", dch, states)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    # inter-chunk output: (C prev_state) * decay
    out_decay = torch.exp(A_cs).reshape(Bsz, G, R, c, Q).permute(
        0, 3, 4, 1, 2)                                        # (B,c,Q,G,R)
    Y_off = torch.einsum("bclgn,bcgrpn->bclgrp", Cb,
                         prev_states) * out_decay[..., None]
    y = (Y_diag + Y_off).reshape(Bsz, S, H, P)
    return y, final_state.reshape(Bsz, H, P, N)


class MambaCache(NamedTuple):
    ssm: torch.Tensor     # (..., B, H, P, N) float32
    conv: torch.Tensor    # (..., B, W-1, conv_channels)


def mamba_init_cache(cfg: ModelConfig, batch: int, dtype, lead: tuple = (),
                     device=None) -> MambaCache:
    s = cfg.ssm
    di = _d_inner(cfg)
    H, G, N = _n_heads(cfg), s.n_groups, s.d_state
    lead = tuple(lead)
    return MambaCache(
        torch.zeros(lead + (batch, H, s.head_dim, N), dtype=torch.float32,
                    device=device),
        torch.zeros(lead + (batch, s.conv_width - 1, di + 2 * G * N),
                    dtype=dtype, device=device))


class _Part(NamedTuple):
    """This rank's part of the mixer: its heads ``[h0, h0 + nh)`` and their
    channels ``[c0, c0 + nc)`` of ``d_inner`` (every head, with ``tp``
    None, off a model axis)."""
    tp: Optional[SH.ModelAxis]
    h0: int
    nh: int
    c0: int
    nc: int


def _part(params, cfg: ModelConfig) -> _Part:
    di, H, P = _d_inner(cfg), _n_heads(cfg), cfg.ssm.head_dim
    tp = L.split_axis(params["out_proj"]["w"].shape[-2], di)
    if tp is None:
        return _Part(None, 0, H, 0, di)
    if H % tp.size or cfg.ssm.n_groups != 1:
        raise ValueError(f"{cfg.arch_id}: tensor-parallel mamba2 splits "
                         f"{H} heads of one B/C group over {tp.size} ranks "
                         f"(n_groups {cfg.ssm.n_groups})")
    nh = H // tp.size
    return _Part(tp, tp.rank * nh, nh, tp.rank * nh * P, nh * P)


def _whole(t: torch.Tensor, full: int, part: _Part) -> torch.Tensor:
    """``t`` with its last dim of ``full`` whole on every rank (gathered
    where it holds this rank's block), through ``copy_to_model``: the
    ranks read different parts of it, so the backward sums their
    gradients before a split leaf takes its slice."""
    if part.tp is None:
        return t
    if t.shape[-1] != full:
        t = comm.gather_from_model(t, -1, part.tp.group)
    return comm.copy_to_model(t, part.tp.group)


def _read(t: torch.Tensor, part: _Part, di: int) -> torch.Tensor:
    """The channels of a whole x|B|C (last dim) that this rank's heads
    read: their x channels and every B and C channel."""
    if part.tp is None:
        return t
    return torch.cat([t[..., part.c0:part.c0 + part.nc], t[..., di:]], -1)


def _heads(t: torch.Tensor, part: _Part) -> torch.Tensor:
    """This rank's heads of a replicated per-head leaf."""
    if part.tp is None:
        return t
    return _whole(t, t.shape[-1], part)[..., part.h0:part.h0 + part.nh]


def _split_proj(params, u, cfg: ModelConfig, part: _Part):
    """(this rank's z, the whole pre-conv x|B|C, this rank's dt)."""
    s = cfg.ssm
    di = _d_inner(cfg)
    G, N = s.n_groups, s.d_state
    w = params["in_proj"]["w"]
    n = 2 * di + 2 * G * N + _n_heads(cfg)
    if part.tp is not None and w.shape[-1] != n:
        # each rank's columns are a part of the work on the same u
        u = comm.copy_to_model(u, part.tp.group)
    zxbcdt = _whole(u @ w, n, part)
    z = zxbcdt[..., part.c0:part.c0 + part.nc]
    xBC = zxbcdt[..., di:di + di + 2 * G * N]
    dt0 = di + di + 2 * G * N + part.h0
    dt_raw = zxbcdt[..., dt0:dt0 + part.nh]
    return z, xBC, dt_raw


def _conv_params(params, cfg: ModelConfig, part: _Part):
    """The conv's weight and bias over the channels this rank reads."""
    di = _d_inner(cfg)
    C = di + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    return tuple(_read(_whole(params["conv"][k], C, part), part, di)
                 for k in ("w", "b"))


def _gated_norm(params, y, z, cfg: ModelConfig):
    """RMSNorm of ``y * silu(z)`` over the full ``d_inner``, of which a
    tensor-parallel rank holds its heads' channels."""
    return L.rmsnorm_split(params["norm"], y * L.silu(z), cfg.norm_eps)


def _out_proj(params, y, part: _Part):
    if part.tp is None:
        return y @ params["out_proj"]["w"]
    return L.row_parallel(y, params["out_proj"]["w"], part.tp)


def mamba_block(params: dict, u: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence mamba2 mixing. u: (B, S, d_model)."""
    s = cfg.ssm
    di = _d_inner(cfg)
    G, N, P = s.n_groups, s.d_state, s.head_dim
    Bsz, S, _ = u.shape
    part = _part(params, cfg)
    nh, nc = part.nh, part.nc
    z, xBC, dt_raw = _split_proj(params, u, cfg, part)
    xBC = _causal_conv(_read(xBC, part, di), *_conv_params(params, cfg, part))
    x = xBC[..., :nc].reshape(Bsz, S, nh, P)
    Bm = xBC[..., nc:nc + G * N].reshape(Bsz, S, G, N)
    Cm = xBC[..., nc + G * N:].reshape(Bsz, S, G, N)
    dt = L.softplus(dt_raw.float() + _heads(params["dt_bias"], part))
    A = -torch.exp(_heads(params["A_log"], part))             # (nh,)
    y, _ = ssd_chunked(x.float() * dt[..., None], dt * A, Bm, Cm, s.chunk)
    y = y + _heads(params["D"], part)[None, None, :, None] * x.float()
    y = y.reshape(Bsz, S, nc).to(u.dtype)
    return _out_proj(params, _gated_norm(params, y, z, cfg), part)


def mamba_decode(params: dict, u: torch.Tensor, cache: MambaCache,
                 cfg: ModelConfig):
    """One-token recurrent step. u: (B,1,d_model).  Returns (out, new
    cache); ``cache`` is not written."""
    s = cfg.ssm
    di = _d_inner(cfg)
    G, N, P = s.n_groups, s.d_state, s.head_dim
    C = di + 2 * G * N
    Bsz = u.shape[0]
    part = _part(params, cfg)
    nh, nc = part.nh, part.nc
    z, xBC, dt_raw = _split_proj(params, u[:, 0], cfg, part)
    # conv over (cached W-1 inputs ++ current), in float32; the cache holds
    # this rank's block of channels where they are split
    Cl = cache.conv.shape[-1]
    seq = torch.cat([_whole(cache.conv, C, part),
                     xBC[:, None].to(cache.conv.dtype)], dim=1)  # (B,W,C)
    w, b = _conv_params(params, cfg, part)
    conv_out = (_read(seq, part, di).float() * w.float()).sum(dim=1)
    xBC = L.silu(conv_out + b.float())
    lo = 0 if Cl == C else part.tp.rank * Cl
    new_conv = seq[:, 1:, lo:lo + Cl]
    x = xBC[..., :nc].reshape(Bsz, nh, P)
    Bm = xBC[..., nc:nc + G * N].reshape(Bsz, G, N)
    Cm = xBC[..., nc + G * N:].reshape(Bsz, G, N)
    dt = L.softplus(dt_raw.float() + _heads(params["dt_bias"], part))
    A = -torch.exp(_heads(params["A_log"], part))
    dA = torch.exp(dt * A)                                    # (B,nh)
    R = nh // G
    # B (x dt) as an outer product, C h as a matmul: the JAX einsums'
    # products without an einsum's reshapes (each one a host dispatch)
    Bx = Bm[:, :, None, None, :] * (x * dt[..., None]).view(
        Bsz, G, R, P, 1)                                      # (b,g,r,p,n)
    h = dA[..., None, None] * cache.ssm + Bx.view(Bsz, nh, P, N)
    y = torch.matmul(h.view(Bsz, G, R * P, N),
                     Cm[..., None]).view(Bsz, nh, P)
    y = y + _heads(params["D"], part)[None, :, None] * x
    y = y.reshape(Bsz, 1, nc).to(u.dtype)
    y = _gated_norm(params, y, z[:, None], cfg)
    return _out_proj(params, y, part), MambaCache(h, new_conv)
