"""The language model, dense family: the port of the JAX package's
``repro.models.transformer`` for ``[attn + mlp] x L`` stacks (h2o-danube).

The parameter tree is the JAX package's exactly: nested dicts whose layer
stack is one leading dimension of each leaf (``blocks/mlp/up/w`` is
``(L, d, ff)``, and ``(A, L, d, ff)`` once stacked over agents).  The model
is plain functions over that tree, not one ``nn.Module`` per layer, so the
optimizer, the clip and the consensus act leaf by leaf on whole stacks.
``_scan_blocks`` is a Python loop over the layers; with ``remat`` each layer
runs under ``torch.utils.checkpoint``.

Other families (MoE, SSM, hybrid, audio, vision) and MLA attention raise
``NotImplementedError``: they are queued in ROADMAP.md.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tree as TR
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L

Params = Dict[str, Any]


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.arch_id}) is not ported yet: the "
            "port has the dense family only (ROADMAP.md, queue 1, item 3)")
    if cfg.attn_type == "mla":
        raise NotImplementedError(
            f"MLA attention ({cfg.arch_id}) is not ported yet (ROADMAP.md, "
            "queue 1, item 3)")


# ------------------------------------------------------------------- init

def _dense_block_init(gen, cfg: ModelConfig, lead: tuple, device) -> Params:
    dt = L.dtype_of(cfg.param_dtype)
    return {"ln1": L.rmsnorm_init(cfg.d_model, dt, lead, device),
            "ln2": L.rmsnorm_init(cfg.d_model, dt, lead, device),
            "attn": A.gqa_init(gen, cfg, lead, device),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dt,
                              lead, device)}


def init_params(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (),
                device=None) -> Params:
    """Random parameters (dense family).  ``lead`` prefixes every leaf with
    stacked independent draws: ``(n_agents,)`` gives the agent-stacked
    tree.  ``gen`` must live on ``device``."""
    _require_dense(cfg)
    dt = L.dtype_of(cfg.param_dtype)
    lead = tuple(lead)
    p: Params = {"embed": L.embed_init(gen, cfg.vocab, cfg.d_model, dt, lead,
                                       device),
                 "ln_f": L.rmsnorm_init(cfg.d_model, dt, lead, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.lm_head_init(gen, cfg.d_model, cfg.vocab, dt, lead,
                                      device)
    p["blocks"] = _dense_block_init(gen, cfg, lead + (cfg.n_layers,), device)
    return p


# ---------------------------------------------------------------- forward

def _dense_block(bp, x, positions, cfg: ModelConfig, window: int):
    h = L.rmsnorm(bp["ln1"], x, cfg.norm_eps)
    h = A.self_attention(bp["attn"], h, positions, cfg, True, window)
    x = x + h
    h = L.rmsnorm(bp["ln2"], x, cfg.norm_eps)
    return x + L.mlp(bp["mlp"], h, cfg.activation), 0.0


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


def _scan_blocks(stacked, fn, x, remat):
    """Apply ``fn(layer_params, x) -> (x, aux)`` over the layer stack."""
    flat, treedef = TR.flatten(stacked)
    layers = [t.unbind(0) for t in flat]
    ctx = _remat_context(remat) if remat else None
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


def forward_features(params: Params, batch: Dict[str, torch.Tensor],
                     cfg: ModelConfig, remat=False,
                     window_override: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Any]:
    """Backbone only: returns (normalized features (B,S,d), aux_loss) —
    the head is applied by ``forward`` or by the chunked-CE loss."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    S = tokens.shape[-1]
    positions = torch.arange(S, device=tokens.device)
    window = cfg.window if window_override is None else window_override
    x = L.embed(params["embed"], tokens)
    x, aux = _scan_blocks(
        params["blocks"],
        lambda bp, h: _dense_block(bp, h, positions, cfg, window), x, remat)
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
    """Full-sequence forward.  batch: tokens (B,S).  Returns (logits
    (B,S,V) fp32, aux_loss)."""
    x, aux = forward_features(params, batch, cfg, remat, window_override)
    logits = (L.unembed(params["embed"], x, cfg.logit_softcap)
              if cfg.tie_embeddings
              else L.lm_head(params["lm_head"], x, cfg.logit_softcap))
    return logits, aux
