"""Shared primitive layers: norms, MLPs, embeddings, RoPE, inits.

The port of the JAX package's ``repro.models.layers``.  Params are plain
nested dicts of tensors; every layer is a pair of functions (init(gen, ...)
-> params, apply(params, x, ...) -> y), with the JAX package's parameter
names and layouts.

Inits draw from a ``torch.Generator``.  They cannot reproduce
``jax.random``'s numbers; tests that compare the two packages carry the JAX
package's initial weights across (``repro_torch.convert``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def dense_init(gen: torch.Generator, d_in: int, *out_dims: int, dtype,
               scale: float = 1.0, lead: tuple = (),
               device=None) -> torch.Tensor:
    """Fan-in scaled truncated-normal init; shape ``lead + (d_in,
    *out_dims)`` (``lead`` stacks independent draws: agents, layers)."""
    shape = tuple(lead) + (d_in,) + out_dims
    std = scale / np.sqrt(d_in)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (w * std).to(dtype)


# ----------------------------------------------------------------- norms

def rmsnorm_init(d: int, dtype, lead: tuple = (), device=None) -> dict:
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def rmsnorm_nd(scale: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim with an explicit scale vector (qk-norm)."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ------------------------------------------------------------ activations

def _relu2(x: torch.Tensor) -> torch.Tensor:     # Nemotron-4 squared ReLU
    return torch.square(F.relu(x))


def _gelu(x: torch.Tensor) -> torch.Tensor:      # jax.nn.gelu's default
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu
    if name == "relu2":
        return _relu2
    raise ValueError(name)


# ------------------------------------------------------------------- MLP

def mlp_init(gen, d_model: int, d_ff: int, gated: bool, dtype,
             lead: tuple = (), device=None) -> dict:
    kw = dict(dtype=dtype, lead=lead, device=device)
    p = {"up": {"w": dense_init(gen, d_model, d_ff, **kw)},
         "down": {"w": dense_init(gen, d_ff, d_model, **kw)}}
    if gated:
        p["gate"] = {"w": dense_init(gen, d_model, d_ff, **kw)}
    return p


def mlp(params: dict, x: torch.Tensor, act_name: str) -> torch.Tensor:
    act = activation(act_name)
    h = x @ params["up"]["w"]
    if "gate" in params:
        h = act(x @ params["gate"]["w"]) * h
    else:
        h = act(h)
    return h @ params["down"]["w"]


# ------------------------------------------------------------- embedding

def embed_init(gen, vocab: int, d_model: int, dtype, lead: tuple = (),
               device=None) -> dict:
    tbl = torch.randn(tuple(lead) + (vocab, d_model), generator=gen,
                      device=device) * 0.02
    return {"table": tbl.to(dtype)}


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, params["table"])


def unembed(params: dict, x: torch.Tensor,
            softcap: float = 0.0) -> torch.Tensor:
    logits = (x @ params["table"].transpose(-1, -2)).float()
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def lm_head_init(gen, d_model: int, vocab: int, dtype, lead: tuple = (),
                 device=None) -> dict:
    return {"w": dense_init(gen, d_model, vocab, dtype=dtype, lead=lead,
                            device=device)}


def lm_head(params: dict, x: torch.Tensor,
            softcap: float = 0.0) -> torch.Tensor:
    logits = (x @ params["w"]).float()
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# --------------------------------------------------------- grad barrier

class _GradDtypeBarrier(torch.autograd.Function):
    """Identity whose backward casts the cotangent to the primal dtype.

    The CE loss computes in fp32; the barrier between the residual stream
    and the (fp32) head keeps the backward of the network in the compute
    dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def grad_dtype_barrier(x: torch.Tensor) -> torch.Tensor:
    return _GradDtypeBarrier.apply(x)


# ------------------------------------------------------------------ RoPE

def rope_freqs(head_dim: int, fraction: float, theta: float) -> np.ndarray:
    rot = int(head_dim * fraction) // 2 * 2
    return 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float64) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    rot = int(hd * fraction) // 2 * 2
    if rot == 0:
        return x
    inv = torch.tensor(rope_freqs(hd, fraction, theta), dtype=torch.float32,
                       device=x.device)
    ang = positions[..., None].float() * inv                # (...,S,rot/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


def sinusoid_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embedding for one position; (d,) fp32."""
    i = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos.float() / (10000.0 ** (2 * i / d))
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(d)


def sinusoidal_positions(n: int, d: int) -> np.ndarray:
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    out = np.zeros((n, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out
