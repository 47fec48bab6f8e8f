"""The language model: the port of the JAX package's
``repro.models.transformer`` for ``[attn + mlp] x L`` stacks (h2o-danube;
MLA attention: minicpm3; the vision family, phi-3-vision, which scatters
precomputed patch embeddings into the token embeddings first),
``[attn + moe] x L`` stacks with an optional dense prefix (qwen3-moe,
kimi-k2), ``[mamba2] x L`` stacks (mamba2-780m), the hybrid family's
``(rec, rec, local-attn)`` groups, each sub-layer with its own gated MLP,
plus a tail of ``n_layers % 3`` rec layers (recurrentgemma-9b: RG-LRU
blocks and local attention over ``cfg.hybrid.local_window``), and the
whisper-style encoder-decoder of the audio family (whisper-tiny: a
non-causal encoder over precomputed frame embeddings, a decoder with
sinusoidal positions and cross attention).

The parameter tree is the JAX package's exactly: nested dicts whose layer
stack is one leading dimension of each leaf (``blocks/mlp/up/w`` is
``(L, d, ff)``, and ``(A, L, d, ff)`` once stacked over agents).  The model
is plain functions over that tree, not one ``nn.Module`` per layer, so the
optimizer, the clip and the consensus act leaf by leaf on whole stacks.
``_scan_blocks`` is a Python loop over the layers; with ``remat`` each layer
runs under ``torch.utils.checkpoint`` (a hybrid group, as in the JAX
package, is one checkpointed unit).

Under an active mesh with a "model" axis wider than 1 every family runs
tensor-parallel on each rank's local shards: the residual stream
("embed") replicated, attention (self and cross), the MLP, the mamba2
mixer and the RG-LRU block split over the axis, MoE's experts over
"expert", the embedding and the head over "vocab" (``forward`` then
returns this rank's columns of the logits); the patch scatter writes the
replicated stream.  Under an fsdp rule over data axes wider than 1 (the
JAX ``build_rules`` of an fsdp config, ``serve_rules(...,
weights_fsdp=True)``) each rank holds its block of every layer's fsdp
leaves and ``_scan_blocks`` gathers a layer's whole (model-axis) shards at
use (``layer_gather``); the rows of the batch are the rank's own.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tree as TR
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as SH
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S

Params = Dict[str, Any]

#: the sub-layers of a hybrid group, in order; their kinds are
#: ``cfg.hybrid.pattern``
HYBRID_SUBS = ("rec1", "rec2", "attn")


# ------------------------------------------------------------------- init

def _dense_block_init(gen, cfg: ModelConfig, lead: tuple, device,
                      use_moe: bool = False) -> Params:
    dt = L.dtype_of(cfg.param_dtype)
    p = {"ln1": L.rmsnorm_init(cfg.d_model, dt, lead, device),
         "ln2": L.rmsnorm_init(cfg.d_model, dt, lead, device),
         "attn": (A.mla_init(gen, cfg, lead, device)
                  if cfg.attn_type == "mla"
                  else A.gqa_init(gen, cfg, lead, device))}
    if use_moe:
        p["moe"] = MOE.moe_init(gen, cfg, lead, device)
    else:
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dt,
                              lead, device)
    return p


def _hybrid_sub_init(gen, cfg: ModelConfig, kind: str, lead: tuple,
                     device) -> Params:
    """One hybrid sub-layer: its mixer (an RG-LRU block or local attention)
    and a gated MLP, each behind an RMSNorm."""
    dt = L.dtype_of(cfg.param_dtype)
    return {"ln1": L.rmsnorm_init(cfg.d_model, dt, lead, device),
            "ln2": L.rmsnorm_init(cfg.d_model, dt, lead, device),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, True, dt, lead,
                              device),
            "mix": (R.rglru_init(gen, cfg, lead, device) if kind == "rec"
                    else A.gqa_init(gen, cfg, lead, device))}


def init_params(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (),
                device=None) -> Params:
    """Random parameters of every family.  ``lead`` prefixes
    every leaf with stacked independent draws: ``(n_agents,)`` gives the
    agent-stacked tree.  ``gen`` must live on ``device``."""
    dt = L.dtype_of(cfg.param_dtype)
    lead = tuple(lead)
    p: Params = {"embed": L.embed_init(gen, cfg.vocab, cfg.d_model, dt, lead,
                                       device),
                 "ln_f": L.rmsnorm_init(cfg.d_model, dt, lead, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.lm_head_init(gen, cfg.d_model, cfg.vocab, dt, lead,
                                      device)
    stack = lead + (cfg.n_layers,)
    if cfg.family == "ssm":
        p["blocks"] = {"ln1": L.rmsnorm_init(cfg.d_model, dt, stack, device),
                       "mix": S.mamba_init(gen, cfg, stack, device)}
    elif cfg.family == "moe":
        nd = cfg.moe.n_dense_layers
        if nd:
            p["dense_blocks"] = _dense_block_init(gen, cfg, lead + (nd,),
                                                  device)
        p["blocks"] = _dense_block_init(gen, cfg, lead + (cfg.n_layers - nd,),
                                        device, use_moe=True)
    elif cfg.family == "audio":
        p["enc_blocks"] = _dense_block_init(gen, cfg,
                                            lead + (cfg.n_enc_layers,), device)
        p["enc_ln_f"] = L.rmsnorm_init(cfg.d_model, dt, lead, device)
        p["blocks"] = _dense_block_init(gen, cfg, stack, device)
        p["blocks"]["ln_x"] = L.rmsnorm_init(cfg.d_model, dt, stack, device)
        p["blocks"]["xattn"] = A.gqa_init(gen, cfg, stack, device)
    elif cfg.family == "hybrid":
        n_groups, tail = divmod(cfg.n_layers, len(cfg.hybrid.pattern))
        groups = lead + (n_groups,)
        p["groups"] = {name: _hybrid_sub_init(gen, cfg, kind, groups, device)
                       for name, kind in zip(HYBRID_SUBS,
                                             ("rec", "rec", "attn"))}
        if tail:
            p["tail_blocks"] = _hybrid_sub_init(gen, cfg, "rec",
                                                lead + (tail,), device)
    elif cfg.family in ("dense", "vlm"):
        p["blocks"] = _dense_block_init(gen, cfg, stack, device)
    else:
        raise ValueError(f"family {cfg.family!r} ({cfg.arch_id})")
    return p


# ---------------------------------------------------------------- forward

def _dense_block(bp, x, positions, cfg: ModelConfig, window: int,
                 causal: bool = True):
    h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
    if cfg.attn_type == "mla":
        h = A.mla_attention(bp["attn"], h, positions, cfg)
    else:
        h = A.self_attention(bp["attn"], h, positions, cfg, causal, window)
    x = x + h
    h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
    if "moe" in bp:
        h, aux = MOE.moe_mlp(bp["moe"], h, cfg)
        return x + h, aux
    return x + L.mlp(bp["mlp"], h, cfg.activation, cfg.d_ff), 0.0


def _ssm_block(bp, x, cfg: ModelConfig):
    h = S.mamba_block(bp["mix"], L.rmsnorm(bp["ln1"], x, cfg.norm_eps), cfg)
    return x + h, 0.0


def _hybrid_sub(sp, x, positions, cfg: ModelConfig, kind: str):
    h = L.rmsnorm(sp["ln1"], x, cfg.norm_eps)
    if kind == "rec":
        h = R.rglru_block(sp["mix"], h, cfg)
    else:
        h = A.self_attention(sp["mix"], h, positions, cfg, True,
                             cfg.hybrid.local_window)
    x = x + h
    h = L.rmsnorm(sp["ln2"], x, cfg.norm_eps)
    return x + L.mlp(sp["mlp"], h, cfg.activation, cfg.d_ff)


def _hybrid_group(bp, x, positions, cfg: ModelConfig):
    for kind, name in zip(cfg.hybrid.pattern, HYBRID_SUBS):
        x = _hybrid_sub(bp[name], x, positions, cfg, kind)
    return x, 0.0


_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BMM = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
#: remat policies of the JAX package: which products a layer keeps for the
#: backward (everything else is recomputed)
_REMAT_SAVE = {"nothing": (), "dots": _MM + _BMM, "dots_no_batch": _MM}


def _remat_context(remat) -> Optional[functools.partial]:
    save = _REMAT_SAVE[remat if isinstance(remat, str) else "nothing"]
    if not save:
        return None

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in save
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


@functools.lru_cache(maxsize=16)
def _whole_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Every parameter leaf's whole shape (no agent dim), by path: a
    ``meta`` init."""
    return {k: tuple(v.shape) for k, v in SH.flatten_with_paths(
        init_params(torch.Generator(), cfg, (), "meta")).items()}


def layer_gather(cfg: ModelConfig, stack: str):
    """Under an active fsdp rule that splits leaves of the layer stack
    ``params[stack]`` over data axes wider than 1: ``gather(layer_params,
    prefix="")``, which returns one layer's tree (its leaves at
    ``prefix`` + their path inside the layer) with each such leaf
    gathered over those axes (``comm.gather_from_data``).  The gathered
    leaf is this rank's model-axis shard, which the tensor-parallel code
    takes as it is.  Else None.  Every fsdp-split leaf lies in a layer
    stack (``sharding.fsdp_dims``)."""
    fs = SH.data_axes("fsdp")
    if fs is None:
        return None
    head = stack + "/"
    dims = {k[len(head):]: d for k, d in SH.fsdp_dims(
        _whole_shapes(cfg), SH.current_rules(),
        SH.mesh_axis_sizes(SH.current_mesh())).items()
        if k.startswith(head)}
    if not dims:
        return None

    def gather(bp, prefix: str = ""):
        flat = SH.flatten_with_paths(bp)
        for k, t in flat.items():
            d = dims.get(prefix + k)
            if d is not None:
                flat[k] = comm.gather_from_data(t, d, fs.group)
        return SH.unflatten_with_paths(flat)
    return gather


def _scan_blocks(stacked, fn, x, remat, gather=None):
    """Apply ``fn(layer_params, x) -> (x, aux)`` over the layer stack;
    with ``gather`` (``layer_gather``'s) each layer's fsdp leaves are
    gathered inside the checkpointed unit, so the backward's recompute
    gathers them again and one layer's whole weights are live at a
    time."""
    flat, treedef = TR.flatten(stacked)
    layers = [t.unbind(0) for t in flat]
    ctx = _remat_context(remat) if remat else None
    if gather is not None:
        inner = fn

        def fn(bp, h):
            return inner(gather(bp), h)
    fn = SH.bound(fn) if remat else fn
    aux = 0.0
    for i in range(flat[0].shape[0]):
        bp = TR.unflatten(treedef, [ls[i] for ls in layers])
        if remat:
            kw = {"context_fn": ctx} if ctx is not None else {}
            x, a = checkpoint(fn, bp, x, use_reentrant=False, **kw)
        else:
            x, a = fn(bp, x)
        aux = aux + a
    return x, aux


def _sinusoids(n: int, x: torch.Tensor) -> torch.Tensor:
    """The (n, d) sinusoidal position table in ``x``'s dtype and device
    (its shape alone on ``meta``)."""
    if x.is_meta:
        return x.new_empty((n, x.shape[-1]))
    return torch.from_numpy(L.sinusoidal_positions(n, x.shape[-1])).to(
        device=x.device, dtype=x.dtype)


def forward_features(params: Params, batch: Dict[str, torch.Tensor],
                     cfg: ModelConfig, remat=False,
                     window_override: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Any]:
    """Backbone only: returns (normalized features (B,S,d), aux_loss) —
    the head is applied by ``forward`` or by the chunked-CE loss."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[-1], device=tokens.device)
    window = cfg.window if window_override is None else window_override
    x = L.embed(params["embed"], tokens, cfg.vocab)
    if cfg.family == "audio":
        # whisper's decoder takes absolute (sinusoidal) positions, no rope
        x = x + _sinusoids(tokens.shape[-1], x)[None]
    if cfg.family == "vlm" and "img_embeds" in batch:
        rows = torch.arange(tokens.shape[0], device=x.device)[:, None]
        x = x.index_put((rows, batch["img_pos"].long()),
                        batch["img_embeds"].to(x.dtype))

    def block(bp, h):
        if cfg.family == "ssm":
            return _ssm_block(bp, h, cfg)
        return _dense_block(bp, h, positions, cfg, window)

    aux = 0.0
    if cfg.family == "audio":
        enc = encode(params, batch["frames"], cfg, remat)
        x, aux = _decoder_forward(params, x, enc, positions, cfg, remat)
    elif cfg.family == "hybrid":
        x, _ = _scan_blocks(
            params["groups"],
            lambda bp, h: _hybrid_group(bp, h, positions, cfg), x, remat,
            layer_gather(cfg, "groups"))
        if "tail_blocks" in params:
            x, _ = _scan_blocks(
                params["tail_blocks"],
                lambda bp, h: (_hybrid_sub(bp, h, positions, cfg, "rec"),
                               0.0), x, remat,
                layer_gather(cfg, "tail_blocks"))
    else:
        if "dense_blocks" in params:
            x, aux = _scan_blocks(params["dense_blocks"], block, x, remat,
                                  layer_gather(cfg, "dense_blocks"))
        x, a = _scan_blocks(params["blocks"], block, x, remat,
                            layer_gather(cfg, "blocks"))
        aux = aux + a
    x = L.grad_dtype_barrier(x)          # keep backward in compute dtype
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return x, aux


def head_weight(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """(d, V) head matrix (transposed embedding when tied)."""
    if cfg.tie_embeddings:
        return params["embed"]["table"].transpose(-1, -2)
    return params["lm_head"]["w"]


def forward(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, remat=False,
            window_override: Optional[int] = None
            ) -> Tuple[torch.Tensor, Any]:
    """Full-sequence forward.  batch: tokens (B,S) [+ img_embeds (B,n,d) and
    img_pos (B,n) | frames (B,n_frames,d)].  Returns (logits (B,S,V) fp32,
    aux_loss)."""
    x, aux = forward_features(params, batch, cfg, remat, window_override)
    return head(params, x, cfg), aux


def head(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The logits of features ``x``, float32 (this rank's columns of them
    when the head is vocab-split)."""
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x, cfg.logit_softcap, cfg.vocab)
    return L.lm_head(params["lm_head"], x, cfg.logit_softcap, cfg.vocab)


# ------------------------------------------------------ audio (whisper)

def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig,
           remat=False) -> torch.Tensor:
    """frames: (B, n_frames, d_model), the stubbed conv frontend's output.
    The encoder's self-attention is not causal."""
    frames = frames.to(L.dtype_of(cfg.param_dtype))
    x = frames + _sinusoids(frames.shape[-2], frames)[None]
    positions = torch.arange(frames.shape[-2], device=frames.device)
    x, _ = _scan_blocks(
        params["enc_blocks"],
        lambda bp, h: _dense_block(bp, h, positions, cfg, 0, causal=False),
        x, remat, layer_gather(cfg, "enc_blocks"))
    return L.rmsnorm(params["enc_ln_f"], x, cfg.norm_eps)


def _decoder_forward(params, x, enc, positions, cfg: ModelConfig, remat):
    def dec_block(bp, h):
        hh = L.rmsnorm(bp["ln1"], h, cfg.norm_eps)
        h = h + A.self_attention(bp["attn"], hh, positions, cfg, causal=True)
        hh = L.rmsnorm(bp["ln_x"], h, cfg.norm_eps)
        h = h + _cross_attention(bp["xattn"], hh, enc, cfg)
        hh = L.rmsnorm(bp["ln2"], h, cfg.norm_eps)
        return h + L.mlp(bp["mlp"], hh, cfg.activation, cfg.d_ff), 0.0

    return _scan_blocks(params["blocks"], dec_block, x, remat,
                        layer_gather(cfg, "blocks"))


def cross_kv(p, enc):
    """Cross attention's K and V of the encoder output: (..., n_frames, G,
    hd) each (this rank's kv heads where ``wk``/``wv`` are split)."""
    return (torch.einsum("...d,dgk->...gk", enc, p["wk"]["w"]),
            torch.einsum("...d,dgk->...gk", enc, p["wv"]["w"]))


def cross_attend(p, q, k, v, cfg: ModelConfig) -> torch.Tensor:
    """Direct attention of every query over every frame (a zero bias:
    nothing is masked), then the output projection: q (..., S, h, hd), k/v
    (..., F, g, hd) for ``p``'s local heads.  Split over the model axis,
    whole kv heads serve each local q head its group, and ``wo``'s partial
    sums over the local heads are all-reduced."""
    tp = L.split_axis(p["wq"]["w"].shape[-2], cfg.n_heads)
    if tp is not None and k.shape[-2] == cfg.n_kv_heads:
        k, v = A._local_kv_groups(k, v, tp, q.shape[-2], cfg)
    bias = torch.zeros((1, 1, q.shape[-3], k.shape[-3]),
                       dtype=torch.float32, device=q.device)
    o = A._direct_attn(q, k, v, bias)
    if tp is None:
        return torch.einsum("...hk,hkd->...d", o, p["wo"]["w"])
    wo = p["wo"]["w"]
    return L.row_parallel(o.reshape(o.shape[:-2] + (-1,)),
                          wo.reshape(-1, wo.shape[-1]), tp)


def _cross_attention(p, x, enc, cfg: ModelConfig):
    """Every decoder position over every frame; on the local heads where
    the heads are split over the model axis (the decoder stream and the
    encoder output replicated)."""
    tp, p, _ = A._tp_params(p, cfg)
    if tp is not None:
        x = comm.copy_to_model(x, tp.group)
        enc = comm.copy_to_model(enc, tp.group)
    q = torch.einsum("...d,dhk->...hk", x, p["wq"]["w"])
    k, v = cross_kv(p, enc)
    return cross_attend(p, q, k, v, cfg)
