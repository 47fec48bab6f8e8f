"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427): the
port of the JAX package's ``repro.models.rglru``.

Recurrence (per channel):
    r_t = sigmoid(W_a x_t)            # recurrence gate
    i_t = sigmoid(W_x x_t)            # input gate
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)

The full residual block is conv1d(width 4) -> RG-LRU between linear in/out
projections, with a GeLU (tanh approximation, as ``jax.nn.gelu``) gate
branch: Griffin's "recurrent block".

Training runs the linear recurrence as a log-depth scan over the sequence:
ceil(log2 S) passes of the JAX package's ``associative_scan`` combine,
each a handful of elementwise ops over the whole (B, S, d_rnn) tensor (the
JAX package leaves this to XLA's ``associative_scan``; there is no Pallas
kernel to port).  Decode is the O(1) step.  ``lambda``, the gates, the scan
and the recurrent state stay float32 whatever ``param_dtype`` says.  The
block's conv runs in the parameter dtype as the JAX code writes it (a sum
of W products, rounded after each term in bf16); the decode's conv runs in
float32, so in bf16 the two paths part by the conv's rounding.

Under an active mesh whose "model" axis is wider than 1 the block runs
tensor-parallel on each rank's local shards, as the JAX package's rules
lay them out: ``in_x``, ``in_gate``, the conv and the gates ``rg_wa``/
``rg_wx`` split on their ``d_rnn`` output channels (the JAX code shards
the post-conv ``xc`` over "mlp"), ``out`` on its rows.  The gates read the
whole ``xc``: it is gathered (one exact all-gather, in float32) through
``copy_to_model``, since each rank's gates read all of it; ``i * x`` takes
the rank's own channels.  The scan is per channel and runs on the local
channels alone, ``lambda`` and the conv bias (replicated) give each rank
its slice, and ``out``'s partial products are summed
(``layers.row_parallel``).  The decode caches (the state and the conv
window) are split over ``d_rnn`` as ``cache_specs`` lays them out, which
is each rank's own channels.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L

_C = 8.0


def _d_rnn(cfg: ModelConfig) -> int:
    return cfg.hybrid.d_rnn or cfg.d_model


def rglru_init(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (),
               device=None) -> dict:
    """Random block parameters; ``lead`` prefixes every leaf with stacked
    independent draws (layers, agents).  ``lambda`` is float32."""
    dt = L.dtype_of(cfg.param_dtype)
    d, dr = cfg.d_model, _d_rnn(cfg)
    W = cfg.hybrid.conv_width
    lead = tuple(lead)
    kw = dict(dtype=dt, lead=lead, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    # Lambda init so a^c in [0.9, 0.999] at r=1 (Griffin appendix)
    u = torch.empty(lead + (dr,), **f32).uniform_(0.9 ** 2, 0.999 ** 2,
                                                  generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / (2 * _C)))  # softplus^-1
    return {
        "in_x": {"w": L.dense_init(gen, d, dr, **kw)},
        "in_gate": {"w": L.dense_init(gen, d, dr, **kw)},
        "conv": {"w": (torch.randn(lead + (W, dr), generator=gen, **f32)
                       * 0.1).to(dt),
                 "b": torch.zeros(lead + (dr,), dtype=dt, device=device)},
        "rg_wa": {"w": L.dense_init(gen, dr, dr, scale=0.5, **kw)},
        "rg_wx": {"w": L.dense_init(gen, dr, dr, scale=0.5, **kw)},
        "lambda": lam,
        "out": {"w": L.dense_init(gen, dr, d, **kw)},
    }


def _local(t: torch.Tensor, tp: Optional[SH.ModelAxis]) -> torch.Tensor:
    """This rank's channels of a replicated per-channel leaf."""
    if tp is None:
        return t
    n = t.shape[-1] // tp.size
    return comm.copy_to_model(t, tp.group)[..., tp.rank * n:(tp.rank + 1) * n]


def _gates(params, x: torch.Tensor, tp: Optional[SH.ModelAxis] = None):
    """x: (..., dr) post-conv branch (this rank's channels where ``tp``
    is given) -> (log_a, gated input), float32, over the same channels."""
    xf = x.float()
    # the gates read every channel of x
    xa = xf if tp is None else comm.copy_to_model(
        comm.gather_from_model(xf, -1, tp.group), tp.group)
    r = torch.sigmoid(xa @ params["rg_wa"]["w"].float())
    i = torch.sigmoid(xa @ params["rg_wx"]["w"].float())
    log_a = -_C * L.softplus(_local(params["lambda"], tp)) * r
    a2 = torch.exp(2 * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * xf)
    return log_a, gated


def _shift(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x`` moved ``d`` positions later along axis 1, zeros in front."""
    return F.pad(x[:, :-d], (0, 0, d, 0))


def _linear_scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 (h_{-1} = 0), a_t = exp(log_a_t):
    a log-depth (Hillis-Steele) scan of the combine ``(la1, b1), (la2, b2)
    -> (la1 + la2, exp(la2) b1 + b2)``, ceil(log2 S) passes.  Before the
    pass at offset d, position t holds the combine of positions
    (t - d, t]; positions t < d already hold their prefix, and the shifted
    zeros leave them as they are."""
    la, h = log_a, b
    d = 1
    while d < h.shape[1]:
        h = h + torch.exp(la) * _shift(h, d)
        la = la + _shift(la, d)
        d *= 2
    return h


class RGLRUCache(NamedTuple):
    h: torch.Tensor       # (..., B, d_rnn) recurrent state, float32
    conv: torch.Tensor    # (..., B, W-1, d_rnn)


def rglru_init_cache(cfg: ModelConfig, batch: int, dtype, lead: tuple = (),
                     device=None) -> RGLRUCache:
    dr, W = _d_rnn(cfg), cfg.hybrid.conv_width
    lead = tuple(lead)
    return RGLRUCache(
        torch.zeros(lead + (batch, dr), dtype=torch.float32, device=device),
        torch.zeros(lead + (batch, W - 1, dr), dtype=dtype, device=device))


def _conv_step(cache_conv, x_t, w, b):
    """The conv at one position, in float32 over the cached W-1 inputs and
    ``x_t``: (out in ``x_t``'s dtype, the new window)."""
    seq = torch.cat([cache_conv, x_t[:, None].to(cache_conv.dtype)], dim=1)
    out = (seq.float() * w.float()).sum(dim=1) + b.float()
    new_conv = seq[:, 1:]
    return out.to(x_t.dtype), new_conv


def _split(params, cfg: ModelConfig) -> Optional[SH.ModelAxis]:
    """The model axis when ``d_rnn`` is split over it here, else None."""
    return L.split_axis(params["in_x"]["w"].shape[-1], _d_rnn(cfg))


def _out(params, y: torch.Tensor, tp: Optional[SH.ModelAxis]):
    if tp is None:
        return y @ params["out"]["w"]
    return L.row_parallel(y, params["out"]["w"], tp)


def rglru_block(params: dict, u: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence recurrent block. u: (B, S, d_model)."""
    tp = _split(params, cfg)
    if tp is not None:
        u = comm.copy_to_model(u, tp.group)
    x = u @ params["in_x"]["w"]
    gate = L._gelu(u @ params["in_gate"]["w"])
    w = params["conv"]["w"]
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    xc = sum(xp[:, i:i + S] * w[i] for i in range(W))
    xc = xc + _local(params["conv"]["b"], tp)
    log_a, b = _gates(params, xc, tp)
    h = _linear_scan(log_a, b)                          # (B,S,dr) fp32
    y = h.to(u.dtype) * gate
    return _out(params, y, tp)


def rglru_decode(params: dict, u: torch.Tensor, cache: RGLRUCache,
                 cfg: ModelConfig):
    """One-token step. u: (B,1,d_model).  Returns (out (B,1,d), new
    cache); ``cache`` is not written."""
    tp = _split(params, cfg)
    u2 = u[:, 0]
    x = u2 @ params["in_x"]["w"]
    gate = L._gelu(u2 @ params["in_gate"]["w"])
    xc, new_conv = _conv_step(cache.conv, x, params["conv"]["w"],
                              _local(params["conv"]["b"], tp))
    log_a, b = _gates(params, xc, tp)
    h = torch.exp(log_a) * cache.h + b
    y = (h.to(u.dtype) * gate)[:, None]
    return _out(params, y, tp), RGLRUCache(h, new_conv)
