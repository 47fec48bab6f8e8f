"""Single-token decode over a per-layer cache, for every family (dense with
GQA or MLA, vision, MoE, SSM, hybrid, audio): the port of the JAX
package's ``repro.models.decode``.

``init_cache`` builds the cache tree (stacked along the layer dim to match
the stacked params; a MoE model with a dense prefix has a ``dense_blocks``
cache beside ``blocks``) and ``decode_step`` advances one token:

    logits, cache = decode_step(params, cache, tokens(B,1), pos, cfg)

Sliding-window archs (and a ``window_override`` for dense archs) get
ring-buffer KV caches of window size, MLA a latent cache as long as the
sequence, SSM O(1) recurrent state.  The hybrid family (recurrentgemma)
has per group two RG-LRU caches (the float32 state and the conv's last
W-1 inputs) and a local-attention ring of ``min(local_window, max_len)``
slots, and a tail of RG-LRU caches.  The audio family (whisper) has a
decoder self-attention KV cache and each layer's cross-attention K/V of
the encoder output, which ``encode_for_decode`` writes once per sequence
and every step reads unchanged.  The vision family decodes text tokens
through the dense branch.

``pos`` is one int for every row, as in the JAX package's
``decode_step``, or one position per row, ``(B,)``: the JAX package
``vmap``s its one-position step over the slots for ragged decode
(``decode_step_ragged``); here per-row RoPE positions, sinusoids, cache
write indices and masks do the same in one batched call.  A MoE layer
routes the B rows of a step together.  At one shared position it takes the
JAX package's expert capacity for B tokens, so rows past the capacity drop
where the reference drops them.  With one position per row the reference
routes each row alone, where a token's k distinct experts always fit, so
the capacity is raised to at least B and no row drops.  Every function
returns a new cache and leaves the one it was given as it was.

Under ``serve_rules`` on a mesh with a "model" axis wider than 1, every
family decodes tensor-parallel (``attention.decode_attention``,
``attention.mla_decode``, ``moe.moe_mlp``, ``transformer.cross_attend``,
``ssm.mamba_decode``, ``rglru.rglru_decode``) on each rank's local
shards: the cache split as ``cache_specs`` lays it out (the
self-attention, local-attention and latent caches' slots over "kv_seq",
the cross K/V over "kv_heads", the SSM state over heads, the conv windows
and the RG-LRU state over their channels), the logits this rank's vocab
columns.  Under ``serve_rules(..., weights_fsdp=True)`` ``_scan_over``
gathers each layer's fsdp leaves over the data axes at use
(``transformer.layer_gather``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch import tree as TR
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

Position = Union[int, torch.Tensor]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               window_override: Optional[int] = None,
               device=None) -> Dict[str, Any]:
    """The zeroed cache of ``batch`` sequences, every leaf ``(n_layers,
    batch, ...)``, in the compute dtype (the SSM and RG-LRU states in
    float32)."""
    dt = L.dtype_of(cfg.compute_dtype)
    window = cfg.window if window_override is None else window_override
    if cfg.family == "hybrid":
        hy = cfg.hybrid
        n_groups, tail = divmod(cfg.n_layers, len(hy.pattern))
        lw = min(hy.local_window, max_len)
        rec = (n_groups,)
        cache = {"groups": {
            "rec1": R.rglru_init_cache(cfg, batch, dt, rec, device),
            "rec2": R.rglru_init_cache(cfg, batch, dt, rec, device),
            "attn": A.init_cache(cfg, batch, max_len, lw, dt, rec, device)}}
        if tail:
            cache["tail_blocks"] = R.rglru_init_cache(cfg, batch, dt,
                                                      (tail,), device)
        return cache
    if cfg.family == "ssm":
        return {"blocks": S.mamba_init_cache(cfg, batch, dt,
                                             (cfg.n_layers,), device)}
    if cfg.family == "audio":
        n = cfg.n_layers
        cross = (n, batch, cfg.n_frames, cfg.n_kv_heads, cfg.hd())
        return {"blocks": {
            "self": A.init_cache(cfg, batch, max_len, window, dt, (n,),
                                 device),
            "cross_k": torch.zeros(cross, dtype=dt, device=device),
            "cross_v": torch.zeros(cross, dtype=dt, device=device)}}

    def make(n):
        if cfg.attn_type == "mla":
            return A.mla_init_cache(cfg, batch, max_len, dt, (n,), device)
        return A.init_cache(cfg, batch, max_len, window, dt, (n,), device)

    nd = cfg.moe.n_dense_layers if cfg.family == "moe" else 0
    cache = {"blocks": make(cfg.n_layers - nd)}
    if nd:
        cache["dense_blocks"] = make(nd)
    return cache


def encode_for_decode(params, cache, frames: torch.Tensor,
                      cfg: ModelConfig):
    """Audio: run the encoder over ``frames`` (B, n_frames, d_model) and
    return a new cache holding every decoder layer's cross-attention K/V
    of its output (the self-attention cache as it was)."""
    enc = T.encode(params, frames, cfg)
    xa = params["blocks"]["xattn"]
    g = T.layer_gather(cfg, "blocks")
    if g is None:
        def g(layer, prefix):
            return layer
    kv = [T.cross_kv(g(TR.tree_map(lambda t: t[i], xa), "xattn/"), enc)
          for i in range(cfg.n_layers)]
    blocks = dict(cache["blocks"])
    for j, name in enumerate(("cross_k", "cross_v")):
        blocks[name] = torch.stack([l[j] for l in kv]).to(
            blocks[name].dtype)
    return {**cache, "blocks": blocks}


# ------------------------------------------------------------ block steps

def _dense_decode_block(bp, c, x, pos, cfg, ctx, per_row: bool):
    h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
    if cfg.attn_type == "mla":
        h, c = A.mla_decode(bp["attn"], h, c, pos, cfg, ctx)
    else:
        h, c = A.decode_attention(bp["attn"], h, c, pos, cfg, ctx)
    x = x + h
    h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
    if "moe" in bp:
        # one position per row: each row routes as if alone, so none drops
        h, _ = MOE.moe_mlp(bp["moe"], h, cfg,
                           min_capacity=x.shape[0] if per_row else 0,
                           with_aux=False)
        return x + h, c
    return x + L.mlp(bp["mlp"], h, cfg.activation, cfg.d_ff), c


def _audio_decode_block(bp, c, x, pos, cfg, ctx):
    """``bp``: the layer's params under ``"p"`` and its cross K/V, which
    pass through unchanged; ``c``: its self-attention cache."""
    p = bp["p"]
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    h, c = A.decode_attention(p["attn"], h, c, pos, cfg, ctx)
    x = x + h
    h = L.rmsnorm(p["ln_x"], x, cfg.norm_eps)
    q = torch.einsum("...d,dhk->...hk", h, p["xattn"]["wq"]["w"])
    x = x + T.cross_attend(p["xattn"], q, bp["cross_k"], bp["cross_v"], cfg)
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], h, cfg.activation, cfg.d_ff), c


def _ssm_step(bp, c, h, cfg):
    hh = L.rmsnorm(bp["ln1"], h, cfg.norm_eps)
    out, c = S.mamba_decode(bp["mix"], hh, c, cfg)
    return h + out, c


def _hybrid_sub_step(sp, c, x, kind, pos, cfg, ctx):
    """One hybrid sub-layer: (x, its new cache)."""
    h = L.rmsnorm(sp["ln1"], x, cfg.norm_eps)
    if kind == "rec":
        h, c = R.rglru_decode(sp["mix"], h, c, cfg)
    else:
        h, c = A.decode_attention(sp["mix"], h, c, pos, cfg, ctx)
    x = x + h
    h = L.rmsnorm(sp["ln2"], x, cfg.norm_eps)
    return x + L.mlp(sp["mlp"], h, cfg.activation, cfg.d_ff), c


def _hybrid_decode(params, cache, x, pos, cfg: ModelConfig):
    """The groups, then the rec tail, of one hybrid step: (x, new cache).
    The local attention rings over the config's local window."""
    ring = _cache_len(cache["groups"]["attn"].k.shape[2])
    ctx = A.decode_context(pos, ring, cfg, cfg.hybrid.local_window)

    def group(bp, c, h):
        new = {}
        for kind, name in zip(cfg.hybrid.pattern, T.HYBRID_SUBS):
            h, new[name] = _hybrid_sub_step(bp[name], c[name], h, kind, pos,
                                            cfg, ctx)
        return h, new

    new_cache = dict(cache)
    x, new_cache["groups"] = _scan_over(params["groups"], cache["groups"],
                                        group, x,
                                        T.layer_gather(cfg, "groups"))
    if "tail_blocks" in params:
        x, new_cache["tail_blocks"] = _scan_over(
            params["tail_blocks"], cache["tail_blocks"],
            lambda bp, c, h: _hybrid_sub_step(bp, c, h, "rec", pos, cfg,
                                              ctx), x,
            T.layer_gather(cfg, "tail_blocks"))
    return x, new_cache


def _scan_over(stacked_p, stacked_c, fn, x, gather=None):
    """``fn(layer_params, layer_cache, x) -> (x, layer_cache)`` over the
    layer stack; the new layer caches are stacked into a new tree (an
    empty stack is returned as it was).  ``gather``
    (``transformer.layer_gather``'s) puts each layer's fsdp leaves
    together at use."""
    if gather is not None:
        inner = fn

        def fn(bp, c, h):
            return inner(gather(bp), c, h)
    flat_p, td_p = TR.flatten(stacked_p)
    flat_c, td_c = TR.flatten(stacked_c)
    if flat_p[0].shape[0] == 0:
        return x, stacked_c
    layers_p = [t.unbind(0) for t in flat_p]
    layers_c = [t.unbind(0) for t in flat_c]
    outs = []
    for i in range(flat_p[0].shape[0]):
        bp = TR.unflatten(td_p, [ls[i] for ls in layers_p])
        c = TR.unflatten(td_c, [ls[i] for ls in layers_c])
        x, c = fn(bp, c, x)
        outs.append(TR.leaves(c))
    return x, TR.unflatten(td_c, [torch.stack(ls) for ls in zip(*outs)])


def _cache_len(local: int) -> int:
    """The whole cache's slots, of which this rank holds ``local``: its
    span of them when the active rules split them over a model axis."""
    seq = SH.kv_seq_split() if SH.model_axis() else None
    return local if seq is None else local * seq.n


def _row_positions(pos: Position, batch: int, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        if pos.shape[0] != batch:
            raise ValueError(f"pos {tuple(pos.shape)} for {batch} rows")
        return pos.to(device=device, dtype=torch.int64)
    return torch.full((batch,), int(pos), dtype=torch.int64, device=device)


# --------------------------------------------------------------- the step

def _audio_decode(params, cb, x, pos, cfg: ModelConfig, window: int):
    """The decoder stack of one audio step: (x, new ``blocks`` cache)."""
    ctx = A.decode_context(pos, _cache_len(cb["self"].k.shape[2]), cfg,
                           window)
    x = x + L.sinusoid_at(pos, cfg.d_model)[:, None].to(x.dtype)
    g = T.layer_gather(cfg, "blocks")
    x, new_self = _scan_over(
        {"p": params["blocks"], "cross_k": cb["cross_k"],
         "cross_v": cb["cross_v"]}, cb["self"],
        lambda bp, c, h: _audio_decode_block(
            bp if g is None else {**bp, "p": g(bp["p"])}, c, h, pos, cfg,
            ctx), x)
    return x, {**cb, "self": new_self}


def decode_step(params, cache, tokens: torch.Tensor, pos: Position,
                cfg: ModelConfig, window_override: Optional[int] = None):
    """tokens: (B, 1) int; pos: the current position, an int for every row
    or one per row (B,).  Returns (logits (B,1,V) float32, new cache)."""
    window = cfg.window if window_override is None else window_override
    per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
    pos = _row_positions(pos, tokens.shape[0], tokens.device)
    x = L.embed(params["embed"], tokens, cfg.vocab)
    new_cache = dict(cache)
    if cfg.family == "audio":
        x, new_cache["blocks"] = _audio_decode(params, cache["blocks"], x,
                                               pos, cfg, window)
    elif cfg.family == "hybrid":
        x, new_cache = _hybrid_decode(params, cache, x, pos, cfg)
    else:
        if cfg.family == "ssm":
            def fn(bp, c, h):
                return _ssm_step(bp, c, h, cfg)
        else:
            cache_len = _cache_len(TR.leaves(cache["blocks"])[0].shape[2])
            ctx = (A.mla_decode_context if cfg.attn_type == "mla"
                   else A.decode_context)(pos, cache_len, cfg, window)

            def fn(bp, c, h):
                return _dense_decode_block(bp, c, h, pos, cfg, ctx, per_row)
        for name in ("dense_blocks", "blocks"):     # the dense prefix first
            if name in params:
                x, new_cache[name] = _scan_over(params[name], cache[name],
                                                fn, x,
                                                T.layer_gather(cfg, name))
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return T.head(params, x, cfg), new_cache


# ----------------------------------------------------- prefill + ragged decode

def prefill_cache(params, cache, tokens: torch.Tensor, pos0: int,
                  cfg: ModelConfig, window_override: Optional[int] = None,
                  all_logits: bool = False):
    """Cache-writing prefill: ``decode_step`` over a token chunk, one token
    at a time, so the cache it writes is bit-equal to stepwise decode.

    ``tokens``: (B, C) int; ``pos0``: the chunk's start position (0 for a
    fresh prompt, the running offset for chunked prefill).  Returns
    ``(last_logits (B, V), cache)``: the logits of the final chunk token,
    the distribution of the first token after the chunk.  With
    ``all_logits`` the first element is every position's logits, (B, C, V).
    """
    C = tokens.shape[1]
    seen = []
    for t in range(C):
        logits, cache = decode_step(params, cache, tokens[:, t:t + 1],
                                    pos0 + t, cfg, window_override)
        seen.append(logits[:, -1])
    if all_logits:
        return torch.stack(seen, dim=1), cache
    return seen[-1], cache


def decode_step_ragged(params, cache, tokens: torch.Tensor,
                       pos: torch.Tensor, cfg: ModelConfig,
                       window_override: Optional[int] = None):
    """``decode_step`` with a per-sequence position vector, the unit of
    continuous batching, where every cache slot sits at a different depth.

    ``tokens``: (B, 1) int; ``pos``: (B,) int.  Returns ``(logits (B, 1, V),
    new cache)``.  Each row's computation reads only its own cache row, so
    a slot's result does not depend on what the other slots hold; with the
    batch held at a fixed size (the whole arena), a request's tokens are
    then bit-equal whether it ran alone or packed."""
    if not isinstance(pos, torch.Tensor) or pos.dim() != 1:
        raise ValueError("decode_step_ragged takes one position per row")
    return decode_step(params, cache, tokens, pos, cfg, window_override)
