"""Shared primitive layers: norms, MLPs, embeddings, RoPE, inits.

The port of the JAX package's ``repro.models.layers``.  Params are plain
nested dicts of tensors; every layer is a pair of functions (init(gen, ...)
-> params, apply(params, x, ...) -> y), with the JAX package's parameter
names and layouts.

Under an active mesh whose "model" axis is wider than 1
(``distributed.sharding.model_axis``) the MLP, the embedding and the heads
run tensor-parallel on local shards, as the JAX package's ``shard``
annotations lay them out: the MLP's up/gate split over "mlp" (column
parallel) and its down projection's partial sums, each taken in f32,
all-reduced in f32 and rounded once (row parallel), the embedding and the
heads split over "vocab"; an RMS norm over a split width
(``rmsnorm_split``, MLA's q latent) sums every rank's squares.  A layer
reads whether its leaf is split from
the leaf's local size against the full one (a dim the axis does not divide
stays whole, as ``sanitize_specs`` leaves it); with no such axis every
path is the one-device path.

Inits draw from a ``torch.Generator``.  They cannot reproduce
``jax.random``'s numbers; tests that compare the two packages carry the JAX
package's initial weights across (``repro_torch.convert``).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import comm
from repro_torch.distributed import sharding as SH

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


#: the most float32 elements one init draw makes at a time: a larger leaf
#: is drawn slice by slice along its leading (stack) axes into a leaf
#: allocated once in its own dtype, so the f32 temporary stays small (a
#: full-width qwen3-moe's stacked ``experts/gate`` is 9.66 B elements: 38.6
#: GB in f32 beside its 19.3 GB in bf16)
MAX_DRAW_ELEMENTS = 1 << 30


def _draw(shape: tuple, dtype, device, fill) -> torch.Tensor:
    """A leaf of ``shape`` in ``dtype`` whose values ``fill(f32 tensor)``
    draws and returns, at most ``MAX_DRAW_ELEMENTS`` f32 elements a draw.
    A larger leaf is cut, along its flattened leading axes, into blocks of
    whole rows (a row: the fewest trailing axes that fit one draw), each
    block as many rows as fit, rounded down to a multiple of 16 elements
    where a block of 16 or more fits.  The blocks are drawn in storage
    order, one after another from the same generator, so on the CPU the
    cut draw is bit-equal to one draw of the whole leaf (on CUDA each draw
    takes its own Philox offset: seeded and deterministic, but other
    numbers).  A normal draw on the CPU fills 16 numbers at a time, so for
    it this holds when each block is a multiple of 16 elements.  On the
    ``meta`` device there is nothing to draw: the leaf comes back empty,
    at once (a full-size tree's shapes and dtypes, for counting)."""
    if torch.device(device if device is not None else "cpu").type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    n, max_elements = int(np.prod(shape)), MAX_DRAW_ELEMENTS
    if n <= max_elements:
        return fill(torch.empty(shape, dtype=torch.float32,
                                device=device)).to(dtype)
    lead = 0                   # split the fewest leading axes that will do
    while int(np.prod(shape[lead:])) > max_elements and lead < len(shape):
        lead += 1
    row_shape = tuple(shape[lead:])
    row = int(np.prod(row_shape))
    rows = max_elements // row
    step = 16 // math.gcd(row, 16)     # rows a multiple of 16 elements
    if rows >= step:
        rows -= rows % step
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view((-1,) + row_shape)
    for i in range(0, flat.shape[0], rows):
        j = min(i + rows, flat.shape[0])
        flat[i:j] = fill(torch.empty((j - i,) + row_shape,
                                     dtype=torch.float32, device=device))
    return out


def _norm_cdf(x: float) -> float:
    return (1.0 + math.erf(x / math.sqrt(2.0))) / 2.0


def _trunc_normal_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [-3, 3], in place, by the inverse CDF of
    one uniform draw per element (``torch.nn.init.trunc_normal_``'s
    method before it moved to rejection sampling, whose draws depend on
    how the leaf is cut).  Element i takes the i-th number of the stream,
    so a leaf drawn in slices gets the numbers of one whole draw."""
    lo, hi = _norm_cdf(-3.0), _norm_cdf(3.0)
    w.uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
    w.erfinv_()
    w.mul_(math.sqrt(2.0))
    w.add_(0.0)                # the mean: -0.0 becomes 0.0, as there
    return w.clamp_(min=-3.0, max=3.0)


def dense_init(gen: torch.Generator, d_in: int, *out_dims: int, dtype,
               scale: float = 1.0, lead: tuple = (),
               device=None) -> torch.Tensor:
    """Fan-in scaled truncated-normal init; shape ``lead + (d_in,
    *out_dims)`` (``lead`` stacks independent draws: agents, layers,
    experts)."""
    std = scale / np.sqrt(d_in)

    def fill(w):
        return _trunc_normal_(w, gen) * std

    return _draw(tuple(lead) + (d_in,) + out_dims, dtype, device, fill)


# ----------------------------------------------------------------- norms

def rmsnorm_init(d: int, dtype, lead: tuple = (), device=None) -> dict:
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def rmsnorm_split(params: dict, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """``rmsnorm`` over a last dim of which ``x`` may hold this rank's
    contiguous part (the full width is the replicated scale's): the mean
    square is the f32 sum of every rank's squares over the full width, and
    each rank scales by its slice of the scale."""
    scale = params["scale"]
    tp = split_axis(x.shape[-1], scale.shape[-1])
    if tp is None:
        return rmsnorm(params, x, eps)
    n = x.shape[-1]
    scale = comm.copy_to_model(scale, tp.group)[tp.rank * n:(tp.rank + 1) * n]
    xf = x.float()
    # every rank's squares, summed; each rank's use of the sum is a part of
    # the work, so its gradient is summed too
    sq = comm.copy_to_model(comm.reduce_from_model(
        torch.sum(torch.square(xf), dim=-1, keepdim=True), tp.group),
        tp.group)
    y = xf * torch.rsqrt(sq / (n * tp.size) + eps)
    return (y * scale.float()).to(x.dtype)


def rmsnorm_nd(scale: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim with an explicit scale vector (qk-norm)."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ------------------------------------------------------------ activations

def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` as ``jax.nn.silu`` computes it: ``x / (1 +
    exp(-x))`` with each operation rounded to ``x``'s dtype.  In bf16 this
    differs from ``F.silu`` (one rounding) by a bf16 ulp at about a third
    of the elements: enough to flip a greedy token at a near-tie."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                           device=x.device))


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


def split_axis(local: int, full: Optional[int]) -> Optional[SH.ModelAxis]:
    """The model axis when a dim of ``full`` elements is split over it
    here (its local size is smaller), else None."""
    if full is None or local == full:
        return None
    tp = SH.model_axis()
    if tp is None or local * tp.size != full:
        raise ValueError(f"a local dim of {local} of {full} under "
                         f"{'no model axis' if tp is None else tp.size}")
    return tp


class _MatmulF32Out(torch.autograd.Function):
    """``h @ w`` of two 2-D bf16/f16 operands with the GEMM's f32
    accumulator as the result, unrounded (``torch.mm``'s ``out_dtype``,
    which the CUDA and meta backends have and autograd lacks); the
    backward's products in the operands' dtype."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return torch.mm(h, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        return (g @ w.t() if ctx.needs_input_grad[0] else None,
                h.t() @ g if ctx.needs_input_grad[1] else None)


def row_parallel(h: torch.Tensor, w: torch.Tensor,
                 tp: SH.ModelAxis) -> torch.Tensor:
    """``h @ w`` of this rank's part of the contracted (last) dim of
    ``h``, summed over the model axis: each rank's partial product kept
    in f32 (a bf16 GEMM's own f32 accumulator; the CPU, which has no such
    GEMM, multiplies f32 copies), the sum in f32, rounded once to ``h``'s
    dtype."""
    x = h.reshape(-1, h.shape[-1])
    w = w.to(h.dtype)
    if h.dtype == torch.float32:
        part = x @ w
    elif h.device.type == "cpu":
        part = x.float() @ w.float()
    else:
        part = _MatmulF32Out.apply(x, w)
    part = part.reshape(tuple(h.shape[:-1]) + (w.shape[-1],))
    return comm.reduce_from_model(part, tp.group).to(h.dtype)


def mlp(params: dict, x: torch.Tensor, act_name: str,
        d_ff: Optional[int] = None) -> torch.Tensor:
    """``d_ff``: the full hidden width, which tells a split hidden from a
    whole one (None: whole)."""
    act = activation(act_name)
    tp = split_axis(params["up"]["w"].shape[-1], d_ff)
    if tp is not None:
        x = comm.copy_to_model(x, tp.group)
    h = x @ params["up"]["w"]
    if "gate" in params:
        h = act(x @ params["gate"]["w"]) * h
    else:
        h = act(h)
    if tp is None:
        return h @ params["down"]["w"]
    return row_parallel(h, params["down"]["w"], tp)


# ------------------------------------------------------------- embedding

def embed_init(gen, vocab: int, d_model: int, dtype, lead: tuple = (),
               device=None) -> dict:
    def fill(t):
        return t.normal_(generator=gen) * 0.02

    return {"table": _draw(tuple(lead) + (vocab, d_model), dtype, device,
                           fill)}


def embed(params: dict, tokens: torch.Tensor,
          vocab: Optional[int] = None) -> torch.Tensor:
    """``vocab``: the full vocabulary, which tells a vocab-split table from
    a whole one (None: whole).  Split, each rank looks up the tokens its
    rows hold, zeros the others, and the sum over the axis (one nonzero
    term a token) is the lookup."""
    table = params["table"]
    tp = split_axis(table.shape[0], vocab)
    if tp is None:
        return F.embedding(tokens, table)
    n = table.shape[0]
    local = tokens - tp.rank * n
    inside = (local >= 0) & (local < n)
    x = F.embedding(torch.where(inside, local, 0), table)
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    return comm.reduce_from_model(x, tp.group)


def _logits(x: torch.Tensor, w: torch.Tensor, vocab: Optional[int],
            softcap: float) -> torch.Tensor:
    tp = split_axis(w.shape[-1], vocab)
    if tp is not None:
        x = comm.copy_to_model(x, tp.group)
    logits = (x @ w).float()
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def unembed(params: dict, x: torch.Tensor, softcap: float = 0.0,
            vocab: Optional[int] = None) -> torch.Tensor:
    """Tied head.  With a vocab-split table the logits are this rank's
    columns of them."""
    return _logits(x, params["table"].transpose(-1, -2), vocab, softcap)


def vocab_argmax(logits: torch.Tensor,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """``argmax`` over the last dim, the lowest index among ties (as
    ``jnp.argmax``); over every rank's columns when ``logits`` are this
    rank's part of a vocab-split whole (two all-reduce maxes)."""
    tp = split_axis(logits.shape[-1], vocab)
    if tp is None:
        return torch.argmax(logits, dim=-1)
    val, idx = torch.max(logits, dim=-1)
    top = comm.all_reduce_max(val.clone(), tp.group)
    lo = tp.rank * logits.shape[-1]
    # the lowest global index among the ranks holding the max: max of -i
    neg = torch.where(val == top, -(idx + lo),
                      torch.full_like(idx, -(1 << 62)))
    return -comm.all_reduce_max(neg, tp.group)


def lm_head_init(gen, d_model: int, vocab: int, dtype, lead: tuple = (),
                 device=None) -> dict:
    return {"w": dense_init(gen, d_model, vocab, dtype=dtype, lead=lead,
                            device=device)}


def lm_head(params: dict, x: torch.Tensor, softcap: float = 0.0,
            vocab: Optional[int] = None) -> torch.Tensor:
    """With a vocab-split head the logits are this rank's columns."""
    return _logits(x, params["w"], vocab, softcap)


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


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                fraction: float = 1.0):
    """``(cos, sin)`` of RoPE's angles at ``positions`` ((..., S) -> (...,
    S, 1, rot/2), float32), or None when nothing rotates.  A decode step
    computes them once for all its layers."""
    rot = int(head_dim * fraction) // 2 * 2
    if rot == 0:
        return None
    inv = torch.tensor(rope_freqs(head_dim, fraction, theta),
                       dtype=torch.float32, device=positions.device)
    ang = positions[..., None].float() * inv                # (...,S,rot/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0, tables=None) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  ``tables``:
    ``rope_tables`` of the same positions, computed once for several
    calls (``positions`` is then not read)."""
    hd = x.shape[-1]
    if tables is None:
        tables = rope_tables(positions, hd, theta, fraction)
    if tables is None:
        return x
    cos, sin = tables
    rot = 2 * cos.shape[-1]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape).to(x.dtype)
    return yr if rot == hd else torch.cat([yr, xp], dim=-1)


def sinusoid_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embedding at one position, (d,) fp32, or at one position
    per row, ``(B,)`` -> ``(B, d)``: the JAX package's arithmetic in f32
    (``sinusoidal_positions`` computes the same table in float64)."""
    i = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos.float()[..., None] / (10000.0 ** (2 * i / d))
    return torch.stack([torch.sin(ang), torch.cos(ang)],
                       dim=-1).reshape(pos.shape + (d,))


def sinusoidal_positions(n: int, d: int) -> np.ndarray:
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    out = np.zeros((n, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out
