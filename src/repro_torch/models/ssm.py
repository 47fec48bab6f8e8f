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
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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


def _split_proj(params, u, cfg: ModelConfig):
    s = cfg.ssm
    di = _d_inner(cfg)
    G, N = s.n_groups, s.d_state
    zxbcdt = u @ params["in_proj"]["w"]
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * G * N]
    dt_raw = zxbcdt[..., di + di + 2 * G * N:]
    return z, xBC, dt_raw


def mamba_block(params: dict, u: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence mamba2 mixing. u: (B, S, d_model)."""
    s = cfg.ssm
    di = _d_inner(cfg)
    H, G, N, P = _n_heads(cfg), s.n_groups, s.d_state, s.head_dim
    Bsz, S, _ = u.shape
    z, xBC, dt_raw = _split_proj(params, u, cfg)
    xBC = _causal_conv(xBC, params["conv"]["w"], params["conv"]["b"])
    x = xBC[..., :di].reshape(Bsz, S, H, P)
    Bm = xBC[..., di:di + G * N].reshape(Bsz, S, G, N)
    Cm = xBC[..., di + G * N:].reshape(Bsz, S, G, N)
    dt = L.softplus(dt_raw.float() + params["dt_bias"])       # (B,S,H)
    A = -torch.exp(params["A_log"])                           # (H,)
    y, _ = ssd_chunked(x.float() * dt[..., None], dt * A, Bm, Cm, s.chunk)
    y = y + params["D"][None, None, :, None] * x.float()
    y = y.reshape(Bsz, S, di).to(u.dtype)
    y = L.rmsnorm(params["norm"], y * L.silu(z), cfg.norm_eps)
    return y @ params["out_proj"]["w"]


def mamba_decode(params: dict, u: torch.Tensor, cache: MambaCache,
                 cfg: ModelConfig):
    """One-token recurrent step. u: (B,1,d_model).  Returns (out, new
    cache); ``cache`` is not written."""
    s = cfg.ssm
    di = _d_inner(cfg)
    H, G, N, P = _n_heads(cfg), s.n_groups, s.d_state, s.head_dim
    Bsz = u.shape[0]
    z, xBC, dt_raw = _split_proj(params, u[:, 0], cfg)
    # conv over (cached W-1 inputs ++ current), in float32
    seq = torch.cat([cache.conv, xBC[:, None].to(cache.conv.dtype)],
                    dim=1)                                    # (B,W,C)
    conv_out = (seq.float() * params["conv"]["w"].float()).sum(dim=1)
    xBC = L.silu(conv_out + params["conv"]["b"].float())
    new_conv = seq[:, 1:]
    x = xBC[..., :di].reshape(Bsz, H, P)
    Bm = xBC[..., di:di + G * N].reshape(Bsz, G, N)
    Cm = xBC[..., di + G * N:].reshape(Bsz, G, N)
    dt = L.softplus(dt_raw.float() + params["dt_bias"])       # (B,H)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A)                                    # (B,H)
    R = H // G
    # B (x dt) as an outer product, C h as a matmul: the JAX einsums'
    # products without an einsum's reshapes (each one a host dispatch)
    Bx = Bm[:, :, None, None, :] * (x * dt[..., None]).view(
        Bsz, G, R, P, 1)                                      # (b,g,r,p,n)
    h = dA[..., None, None] * cache.ssm + Bx.view(Bsz, H, P, N)
    y = torch.matmul(h.view(Bsz, G, R * P, N),
                     Cm[..., None]).view(Bsz, H, P)
    y = y + params["D"][None, :, None] * x
    y = y.reshape(Bsz, 1, di).to(u.dtype)
    y = L.rmsnorm(params["norm"], y * L.silu(z[:, None]), cfg.norm_eps)
    return y @ params["out_proj"]["w"], MambaCache(h, new_conv)
