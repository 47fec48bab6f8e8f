"""One-card dry-run: per (arch x shape), the argument bytes of each step
function at the shape's full size, whether they fit one 80 GB H100, the
analytic FLOPs and HBM bytes, and (``--probe``) a real step on the card.
The port of the JAX package's ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cuda \\
        --arch h2o-danube-1.8b --shape train_4k --probe

The JAX dry-run lowers and compiles every step on 512 placeholder TPU
devices and reads XLA's memory and cost analysis.  There is no CUDA
counterpart of lowering without running, so here:

* ``memory`` is counted exactly from ``meta``-device trees (shapes and
  dtypes, no storage) at the shape's full size: for a train shape the
  agent-stacked parameters, their gradients and the FrODO state of
  ``TrainConfig`` (exact memory: T history slots in the parameter dtype;
  exp-sum: K accumulators in ``acc_dtype``) plus the batch of
  ``registry.input_specs``; for prefill the parameters and the batch; for
  decode the parameters and the cache of ``decode.init_cache`` under
  ``registry.decode_window``, plus the tokens.  Activations are not in it.
* ``analytic`` is ``utils.flops.analytic`` with ``hbm_bytes``.
* ``--probe`` is the counterpart of the JAX affine cost probes: it runs one
  real step at scan trip counts 2 and 3 (``registry.reduced_layers``) on
  the device, at the shape's sequence length and a global batch cut to
  what fits (``PROBE_BATCH``, listed under ``reduced``), measures the peak
  device memory (``max_memory_allocated``) and the step's device ms (CUDA
  events around it, after a warm-up step), and extrapolates both affine in
  L to ``registry.scan_trip_count(cfg)``.  On the CPU a probe records the
  host ms instead, and no device number.

``--multi-pod`` (the 2x16x16 ("pod", "data", "model") mesh) and
``--both-meshes`` (16x16 ("data", "model") and 2x16x16) write the
production-mesh records instead of the one-card one, as the JAX flags
choose meshes: each mesh is built with ``launch.mesh.make_production_mesh``
on a ``fake`` process group of its size in one process (with
``--both-meshes`` the 2x16x16 one in a second process beside this one),
and each
record holds ``n_agents`` (``train_step.n_agents_for``), the ``rules``
(``build_rules`` for train, ``serve_rules`` for prefill and decode; each
value as its ``str``) and ``memory``: the per-device argument bytes, each
leaf's local shard under the sanitized specs of the JAX dry-run's
``in_shardings`` (train state and batch; parameters and batch; parameters,
cache and tokens), summed by part, and ``analytic`` as in the one-card
record.

The collective record: rank 0's step of the shape's unit
(``make_train_step``, ``make_prefill``, ``make_serve_step``) runs on
``meta`` tensors (its local shards under the specs) under the rules and
the mesh, and ``distributed.comm`` counts each collective it would issue
(``bytes_by_kind``, ``counts`` and ``effective_bytes_per_device`` under
the JAX dry-run's HLO kind names and its ring factors ``COLL_FACTOR``), as
the JAX dry-run reads them from XLA's partitioned HLO.  The train unit is
``TRAIN_CONFIG``, at the JAX dry-run's ``TrainConfig(microbatches=8)``,
with the update's plain version (a kernel takes no meta tensor; it issues
no collective).

* A prefill or decode record (and a train record at one microbatch):
  ``collectives`` is the count of the step at full depth, and
  ``extrapolated.collective_bytes_by_kind`` and
  ``collective_effective_bytes_per_device`` its counts at scan trip
  counts 2 and 3, extrapolated affine in L.
* A train record at M = ``microbatches`` > 1 (every production one, M =
  8): the step is counted at trip counts 2 and 3 and at the two
  microbatch counts of ``COUNT_MICROBATCHES`` (2 and 4: at one
  microbatch a step exchanges no rows), and ``collectives`` (bytes,
  counts and effective bytes) is those four counts extrapolated bilinear
  in (L, M) to the model's trip count and M; ``extrapolated`` holds the
  same bytes with ``trip_count`` and ``microbatches``.  Each layer's
  collectives (under fsdp its gathers, their reduce-scatters) repeat with
  every microbatch; the rows' exchange, the sums over the batch axes, the
  clip and the consensus are the part constant in M.  The extrapolation
  is exact where each microbatch's bytes are affine in M.  A MoE's expert
  buffers are not quite: their capacity ``moe._capacity`` is rounded up
  to a multiple of 8 per microbatch, so M·C(M) moves with M where it does
  not divide evenly.  qwen3-moe-30b-a3b's does (exact); kimi-k2-1t-a32b's
  capacity-sized bytes are 27,360 / 27,328 of the true count on 16x16
  (2^20 tokens an agent: M·C = 27,312, 27,328, 27,328 at M = 2, 4, 8;
  +0.12%) and 13,664 / 13,696 on 2x16x16 (-0.23%).

Each train record states ``microbatches``; a ``--probe`` runs at the
most microbatches its cut batch splits into, listed under ``reduced``.
Records are JSON files in ``--out`` (``experiments/dryrun_torch``), read
by ``repro_torch.experiments.roofline``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Sequence, Union

import torch

from repro_torch import convert as CV
from repro_torch import tree as TR
from repro_torch.configs import registry as REG
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.data.synthetic import TokenPipeline, augment_modalities
from repro_torch.device import Device, resolve_device, set_full_precision
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as ML
from repro_torch.models import decode as D
from repro_torch.models import transformer as T
from repro_torch.serving import engine as E
from repro_torch.training import train_step as TS
from repro_torch.utils import flops as FL

MESH = "1xH100"
HBM_PER_CARD = 80e9                 # bytes, one H100 SXM5
N_AGENTS = 2                        # the trainer's default (launch.train)
#: the probes' global batch by kind: two agents x two sequences for train
#: (the card trainer's shape), one sequence otherwise
PROBE_BATCH = {"train": 4, "prefill": 1, "decode": 1}


#: the trainer's defaults (exp-sum, K = 8, f32 accumulators, remat) at the
#: JAX dry-run's eight microbatches (``TrainConfig(microbatches=8)``), with
#: the FrODO update through the kernels (their plain versions on the CPU)
TRAIN_CONFIG = TS.TrainConfig(microbatches=8, use_kernel=True)


# ------------------------------------------------------------ argument bytes

def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in TR.leaves(tree)
               if isinstance(t, torch.Tensor))


def argument_bytes(cfg: ModelConfig, shape: InputShape,
                   tc: TS.TrainConfig, n_agents: int,
                   window: Optional[int]) -> Dict[str, int]:
    """The step's inputs at full size, from meta trees, by part."""
    params = FL.meta_params(cfg)
    p = tree_bytes(params)
    if shape.kind == "train":
        stacked = TR.tree_map(lambda t: t.expand((n_agents,) + t.shape),
                              params)
        opt_state = TS.build_optimizer(tc).init(stacked)
        mem = {"params_bytes": n_agents * p, "grads_bytes": n_agents * p,
               "opt_state_bytes": tree_bytes(opt_state),
               "batch_bytes": tree_bytes(REG.input_specs(cfg, shape,
                                                         n_agents))}
    elif shape.kind == "prefill":
        mem = {"params_bytes": p,
               "batch_bytes": tree_bytes(REG.input_specs(cfg, shape))}
    else:
        cache = D.init_cache(cfg, shape.global_batch, shape.seq_len, window,
                             device="meta")
        mem = {"params_bytes": p, "cache_bytes": tree_bytes(cache),
               "batch_bytes": tree_bytes(REG.input_specs(cfg, shape))}
    mem["argument_size_in_bytes"] = sum(mem.values())
    return mem


# ------------------------------------------------- production-mesh records

MESHES = {False: "16x16", True: "2x16x16"}


def shard_bytes(tree, specs, mesh) -> int:
    """Bytes of one device's shard of every tensor leaf of ``tree`` under
    ``specs`` (sanitized: each named axis divides its dim)."""
    sizes = SH.mesh_axis_sizes(mesh)
    total = 0
    for leaf, spec in zip(TR.leaves(tree), TR.leaves(specs)):
        if not isinstance(leaf, torch.Tensor):
            continue                       # a host integer (a step count)
        n = leaf.element_size()
        for dim, p in zip(leaf.shape, tuple(spec) + (None,) * leaf.dim()):
            for a in (() if p is None else
                      p if isinstance(p, tuple) else (p,)):
                dim //= sizes[a]
            n *= dim
        total += n
    return total


def mesh_memory(cfg: ModelConfig, shape: InputShape, mesh, multi_pod: bool,
                tc: TS.TrainConfig) -> Dict[str, Any]:
    """``n_agents``, ``rules`` and the per-device argument bytes of one
    (arch, shape) on a production mesh, by part."""
    out: Dict[str, Any] = {}
    if shape.kind == "train":
        n_agents = TS.n_agents_for(cfg, mesh, multi_pod)
        rules = TS.build_rules(cfg, multi_pod)
        state = TS.abstract_train_state(cfg, tc, n_agents)
        specs = TS.train_state_specs(state, cfg, rules, mesh)
        batch = REG.input_specs(cfg, shape, n_agents)
        out["n_agents"] = n_agents
        out["microbatches"] = tc.microbatches
        mem = {"params_bytes": shard_bytes(state.params, specs.params, mesh),
               "opt_state_bytes": shard_bytes(state.opt_state,
                                              specs.opt_state, mesh)}
        b_specs = TS.batch_specs(batch, rules, mesh)
    else:
        rules = TS.serve_rules(cfg, multi_pod, shape.global_batch, mesh)
        params = FL.meta_params(cfg)
        mem = {"params_bytes": shard_bytes(
            params, TS.param_specs(params, rules, mesh, agent_stacked=False),
            mesh)}
        batch = REG.input_specs(cfg, shape)
        b_specs = TS.batch_specs_serve(batch, rules, mesh)
        if shape.kind == "decode":
            window = REG.decode_window(cfg, shape)
            cache = D.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 window, device="meta")
            mem["cache_bytes"] = shard_bytes(
                cache, TS.cache_specs(cache, rules, mesh), mesh)
            out["window_override"] = window
            b_specs = {"tokens": SH.P()}    # the JAX step's replicated token
    mem["batch_bytes"] = shard_bytes(batch, b_specs, mesh)
    mem["argument_size_in_bytes"] = sum(mem.values())
    out["rules"] = {k: str(v) for k, v in rules.items()}
    out["memory"] = mem
    return out


#: effective bytes moved per participating device, as a multiple of an
#: op's per-device bytes: the JAX dry-run's ring model
COLL_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}


def run_unit(cfg: ModelConfig, shape: InputShape, mesh, multi_pod: bool,
             tc: TS.TrainConfig, device, weights_fsdp: bool = False) -> None:
    """One step of ``shape``'s unit on this rank's local shards at the
    shape's full size, under its rules on ``mesh``: random parameters and
    zero tokens on ``device``, or shapes alone on ``meta``.  Every rank of
    the mesh calls it (on ``meta`` in a ``fake`` world only rank 0 runs).
    ``weights_fsdp``: a decode unit's weights split over the data axes too
    (``serve_rules``'), as the JAX ``lower_decode`` takes it."""
    gen = (torch.Generator(device=device).manual_seed(0)
           if torch.device(device).type != "meta" else torch.Generator())

    def local_batch(batch, specs):
        return CV.shard_tree(TR.tree_map(lambda t: torch.zeros(
            t.shape, dtype=t.dtype, device=device), batch), specs, mesh,
            device)

    if shape.kind == "train":
        n_agents = TS.n_agents_for(cfg, mesh, multi_pod)
        rules = TS.build_rules(cfg, multi_pod)
        full = TS.init_train_state(gen, cfg, tc, n_agents, device)
        specs = TS.train_state_specs(full, cfg, rules, mesh)
        state = TS.TrainState(
            CV.shard_tree(full.params, specs.params, mesh, device),
            CV.shard_tree(full.opt_state, specs.opt_state, mesh, device), 0)
        del full
        batch = REG.input_specs(cfg, shape, n_agents)
        batch = local_batch(batch, TS.batch_specs(batch, rules, mesh))
        with SH.use_rules(rules, mesh):
            TS.make_train_step(cfg, tc, n_agents)(state, batch)
        return
    rules = TS.serve_rules(cfg, multi_pod, shape.global_batch, mesh,
                           weights_fsdp and shape.kind == "decode")
    full = T.init_params(gen, cfg, (), device)
    params = CV.shard_tree(full, TS.param_specs(full, rules, mesh,
                                                agent_stacked=False),
                           mesh, device)
    del full
    batch = REG.input_specs(cfg, shape)
    batch = local_batch(batch, TS.batch_specs_serve(batch, rules, mesh))
    with torch.no_grad(), SH.use_rules(rules, mesh):
        if shape.kind == "prefill":
            E.make_prefill(cfg)(params, batch)
            return
        window = REG.decode_window(cfg, shape)
        cache = D.init_cache(cfg, shape.global_batch, shape.seq_len, window,
                             device=device)
        cache = CV.shard_tree(cache, TS.cache_specs(cache, rules, mesh),
                              mesh, device)
        E.make_serve_step(cfg, window)(params, cache, batch["tokens"],
                                       shape.seq_len - 1)


def count_collectives(cfg: ModelConfig, shape: InputShape, mesh,
                      multi_pod: bool, tc: TS.TrainConfig,
                      device="meta", weights_fsdp: bool = False
                      ) -> Dict[str, Any]:
    """``run_unit``'s collectives on this rank: ``{"bytes_by_kind",
    "counts", "effective_bytes_per_device"}`` (the JAX dry-run's record)."""
    comm.reset_counts()
    run_unit(cfg, shape, mesh, multi_pod, tc, device, weights_fsdp)
    got = comm.hlo_counts()
    per_kind = {k: float(v["bytes"]) for k, v in got.items()}
    return {"bytes_by_kind": per_kind,
            "counts": {k: int(v["calls"]) for k, v in got.items()},
            "effective_bytes_per_device": sum(
                COLL_FACTOR[k] * v for k, v in per_kind.items())}


def _affine_collectives(c2: Dict[str, Any], c3: Dict[str, Any],
                        L: int) -> Dict[str, Any]:
    """The JAX dry-run's ``extrapolated.collective_*``: bytes by kind at
    trip counts 2 and 3, affine in L."""
    coll = {}
    for k in set(c2["bytes_by_kind"]) | set(c3["bytes_by_kind"]):
        f2 = c2["bytes_by_kind"].get(k, 0.0)
        b = c3["bytes_by_kind"].get(k, 0.0) - f2
        coll[k] = max(f2 - 2 * b + b * L, 0.0)
    return {"collective_bytes_by_kind": coll,
            "collective_effective_bytes_per_device": sum(
                COLL_FACTOR[k] * v for k, v in coll.items())}


#: the microbatch counts of a microbatched train record's meta counts (at
#: one microbatch a step exchanges no rows: ``train_step.microbatch_rows``)
COUNT_MICROBATCHES = (2, 4)


def _bilinear_collectives(c: Dict[tuple, Dict[str, Any]], L: int,
                          M: int) -> Dict[str, Any]:
    """A ``count_collectives`` record at trip count L and M microbatches,
    from the counts ``c[(l, m)]`` at trip counts 2 and 3 and at the two
    microbatch counts of ``COUNT_MICROBATCHES``, bilinear in (L, M): a
    layer's collectives repeat with each microbatch; the once-a-step ones
    (the rows' exchange, the sums over the batch axes, the clip, the
    metrics, the consensus) are the part constant in M.  Exact where a
    microbatch's bytes are affine in M (not a MoE's expert buffers whose
    rounded capacity makes M·C(M) move: the module's docstring)."""
    m1, m2 = COUNT_MICROBATCHES

    def at(field: str, kind: str) -> float:
        f = {lm: r[field].get(kind, 0) for lm, r in c.items()}
        per_m = {lv: (f[(lv, m2)] - f[(lv, m1)]) / (m2 - m1) for lv in (2, 3)}
        at_m = {lv: f[(lv, m1)] + per_m[lv] * (M - m1) for lv in (2, 3)}
        return max(at_m[2] + (at_m[3] - at_m[2]) * (L - 2), 0)

    kinds = sorted({k for r in c.values() for k in r["counts"]})
    per_kind = {k: at("bytes_by_kind", k) for k in kinds}
    return {"bytes_by_kind": per_kind,
            "counts": {k: int(round(at("counts", k))) for k in kinds},
            "effective_bytes_per_device": sum(
                COLL_FACTOR[k] * v for k, v in per_kind.items())}


def collective_record(cfg: ModelConfig, shape: InputShape, mesh,
                      multi_pod: bool, tc: TS.TrainConfig) -> Dict[str, Any]:
    """``collectives`` and ``extrapolated`` of one record (see the module
    docstring)."""
    tc = dataclasses.replace(tc, use_kernel=False)
    L = REG.scan_trip_count(cfg)
    M = tc.microbatches if shape.kind == "train" else 1
    if M == 1:
        probes = {k: count_collectives(REG.reduced_layers(cfg, k), shape,
                                       mesh, multi_pod, tc) for k in (2, 3)}
        return {"collectives": count_collectives(cfg, shape, mesh,
                                                 multi_pod, tc),
                "extrapolated": {"trip_count": L, **_affine_collectives(
                    probes[2], probes[3], L)}}
    probes = {(k, m): count_collectives(
        REG.reduced_layers(cfg, k), shape, mesh, multi_pod,
        dataclasses.replace(tc, microbatches=m))
        for k in (2, 3) for m in COUNT_MICROBATCHES}
    coll = _bilinear_collectives(probes, L, M)
    return {"collectives": coll,
            "extrapolated": {
                "trip_count": L, "microbatches": M,
                "collective_bytes_by_kind": coll["bytes_by_kind"],
                "collective_effective_bytes_per_device":
                    coll["effective_bytes_per_device"]}}


def run_mesh(archs: Sequence[str], shapes: Sequence[str], multi_pod: bool,
             out_dir: Optional[str] = None,
             tc: Optional[TS.TrainConfig] = None) -> list:
    """The production-mesh records of every (arch, shape), on one mesh."""
    tc = tc or TRAIN_CONFIG
    mesh_name = MESHES[multi_pod]
    recs = []
    with ML.fake_world(512 if multi_pod else 256):
        mesh = ML.make_production_mesh(multi_pod=multi_pod)
        for arch in archs:
            cfg = REG.get_config(arch)
            for name in shapes:
                shape = INPUT_SHAPES[name]
                rec: Dict[str, Any] = {"arch": arch, "shape": name,
                                       "mesh": mesh_name, "kind": shape.kind,
                                       "devices": mesh.size()}
                ok, reason = REG.shape_supported(cfg, shape)
                if not ok:
                    rec.update(status="skipped", reason=reason)
                else:
                    try:
                        t0 = time.time()
                        rec.update(mesh_memory(cfg, shape, mesh, multi_pod,
                                               tc))
                        rec["count_s"] = round(time.time() - t0, 3)
                        window = REG.decode_window(cfg, shape) or 0
                        rec["analytic"] = FL.analytic(cfg, shape, shape.kind,
                                                      window, remat=tc.remat)
                        rec["analytic"]["hbm_bytes"] = FL.hbm_bytes(
                            cfg, shape, shape.kind,
                            n_agents=rec.get("n_agents", 1), K=tc.K,
                            window=window)
                        t1 = time.time()
                        rec.update(collective_record(cfg, shape, mesh,
                                                     multi_pod, tc))
                        rec["collectives_s"] = round(time.time() - t1, 3)
                        rec["status"] = "ok"
                    except Exception as e:  # noqa: BLE001 — keep sweeping
                        rec["status"] = "error"
                        rec["error"] = f"{type(e).__name__}: {e}"
                        rec["traceback"] = traceback.format_exc()[-2000:]
                _emit(rec, out_dir)
                recs.append(rec)
    return recs


# ------------------------------------------------------------------- probes

def _probe_batch(cfg: ModelConfig, shape: InputShape, batch: int,
                 n_agents: int, dev) -> Dict[str, torch.Tensor]:
    """A seeded batch on ``dev`` in the layout of ``input_specs``."""
    if shape.kind == "train":
        b = next(augment_modalities(iter(TokenPipeline(
            vocab=cfg.vocab, seq_len=shape.seq_len,
            batch_per_agent=batch // n_agents, n_agents=n_agents)), cfg))
    else:
        S = shape.seq_len if shape.kind == "prefill" else 1
        b = next(augment_modalities(iter(TokenPipeline(
            vocab=cfg.vocab, seq_len=S, batch_per_agent=batch,
            n_agents=1)), cfg))
        b = {k: v[0] for k, v in b.items() if k != "labels"}
    return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}


def _probe_step(cfg: ModelConfig, shape: InputShape, tc: TS.TrainConfig,
                n_agents: int, window: Optional[int], batch: int,
                dev) -> Dict[str, Any]:
    """One warm-up and one measured step of ``cfg`` on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(0)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    if shape.kind == "train":
        state = TS.init_train_state(gen, cfg, tc, n_agents, dev)
        step = TS.make_train_step(cfg, tc, n_agents)
        b = _probe_batch(cfg, shape, batch, n_agents, dev)

        def run():
            nonlocal state
            state, _ = step(state, b)
    else:
        params = T.init_params(gen, cfg, (), dev)
        b = _probe_batch(cfg, shape, batch, n_agents, dev)
        if shape.kind == "prefill":
            def run():
                with torch.no_grad():
                    T.forward(params, b, cfg)
        else:
            cache = D.init_cache(cfg, batch, shape.seq_len, window,
                                 device=dev)

            def run():
                with torch.no_grad():
                    D.decode_step(params, cache, b["tokens"],
                                  shape.seq_len - 1, cfg, window)
    run()                                          # warm-up
    if not on_card:
        t0 = time.perf_counter()
        run()
        return {"host_ms": (time.perf_counter() - t0) * 1e3}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(dev)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize(dev)
    return {"device_ms": start.elapsed_time(end),
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}


def _affine_extrapolate(p2: Dict[str, Any], p3: Dict[str, Any],
                        L: int) -> Dict[str, Any]:
    """f(L) = a + b*L from probes at trip counts 2 and 3."""
    out: Dict[str, Any] = {"trip_count": L}
    for key in sorted(set(p2) & set(p3)):
        b = p3[key] - p2[key]
        out[key] = (p2[key] - 2 * b) + b * L
    return out


def probe(cfg: ModelConfig, shape: InputShape, tc: TS.TrainConfig,
          n_agents: int, window: Optional[int], dev) -> Dict[str, Any]:
    """The probes of one record; a train probe at ``tc.microbatches``, or
    at the most microbatches its cut rows an agent split into."""
    batch = PROBE_BATCH[shape.kind]
    L = REG.scan_trip_count(cfg)
    reduced = {"global_batch": f"{shape.global_batch} -> {batch}",
               "n_layers": f"{cfg.n_layers} -> scan trip counts 2 and 3, "
                           f"extrapolated affine in L to {L}"}
    out: Dict[str, Any] = {"global_batch": batch}
    if shape.kind == "train":
        rows = batch // n_agents
        M = max(m for m in range(1, tc.microbatches + 1) if rows % m == 0)
        if M < tc.microbatches:
            reduced["microbatches"] = (f"{tc.microbatches} -> {M} (the "
                                       f"probe's {rows} rows an agent)")
            tc = dataclasses.replace(tc, microbatches=M)
        out["microbatches"] = M
    trips = {k: _probe_step(REG.reduced_layers(cfg, k), shape, tc, n_agents,
                            window, batch, dev) for k in (2, 3)}
    return {"probe": {"trip_counts": {str(k): v for k, v in trips.items()},
                      **out, "reduced": reduced},
            "extrapolated": _affine_extrapolate(trips[2], trips[3], L)}


# --------------------------------------------------------------------- runs

def run_one(arch: str, shape: Union[str, InputShape],
            out_dir: Optional[str] = None, probes: bool = False,
            cfg_override=None, device: Device = None) -> Dict[str, Any]:
    """One record; ``shape`` is a name of ``INPUT_SHAPES`` or a shape."""
    dev = resolve_device(device)
    cfg = cfg_override or REG.get_config(arch)
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    ok, reason = REG.shape_supported(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape.name, "mesh": MESH,
                           "kind": shape.kind}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        _emit(rec, out_dir)
        return rec
    tc = TRAIN_CONFIG
    window = REG.decode_window(cfg, shape) if shape.kind == "decode" else None
    n_agents = N_AGENTS if shape.kind == "train" else 1
    try:
        t0 = time.time()
        if shape.kind == "train":
            rec["n_agents"] = n_agents
            rec["microbatches"] = tc.microbatches
        if shape.kind == "decode":
            rec["window_override"] = window
        rec["memory"] = argument_bytes(cfg, shape, tc, n_agents, window)
        rec["fits"] = (rec["memory"]["argument_size_in_bytes"]
                       <= HBM_PER_CARD)
        rec["count_s"] = round(time.time() - t0, 3)
        rec["analytic"] = FL.analytic(cfg, shape, shape.kind, window or 0,
                                      remat=tc.remat)
        rec["analytic"]["hbm_bytes"] = FL.hbm_bytes(
            cfg, shape, shape.kind, n_agents=n_agents, K=tc.K,
            window=window or 0)
        if probes:
            set_full_precision()
            t1 = time.time()
            rec["device"] = (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else str(dev))
            rec.update(probe(cfg, shape, tc, n_agents, window, dev))
            rec["probe_s"] = round(time.time() - t1, 1)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record it, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    _emit(rec, out_dir)
    return rec


def _emit(rec: Dict[str, Any], out_dir: Optional[str]):
    line = (f"[{rec['status']:7s}] {rec['arch']:22s} {rec['shape']:12s} "
            f"{rec['mesh']:8s}")
    if rec["status"] == "ok" and "devices" in rec:
        mem = rec["memory"]["argument_size_in_bytes"]
        line += f" args/device={mem / 2 ** 30:.3f}GiB"
        coll = rec.get("collectives")
        line += (f" coll/dev={coll['effective_bytes_per_device'] / 2 ** 30:.3f}"
                 f"GiB" if coll else " coll=null")
    elif rec["status"] == "ok":
        mem = rec["memory"]["argument_size_in_bytes"]
        line += (f" exec_flops={rec['analytic']['exec_flops']:.3e}"
                 f" args={mem / 2 ** 30:.2f}GiB"
                 f" fits={'y' if rec['fits'] else 'N'}")
        ext = rec.get("extrapolated")
        if ext:
            line += " probe: " + " ".join(
                f"{k}={v:.4g}" for k, v in ext.items() if k != "trip_count")
    elif rec["status"] == "error":
        line += " " + rec["error"][:160]
    else:
        line += " " + rec.get("reason", "")[:100]
    print(line, flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json"
        rec = dict(rec)
        rec.pop("traceback", None)
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)


def _mesh_records(archs, shapes, multi_pod: bool, out_dir) -> int:
    """``run_mesh``'s records; 1 if one is an error."""
    recs = run_mesh(archs, shapes, multi_pod, out_dir)
    return 1 if any(r["status"] == "error" for r in recs) else 0


def _mesh_child(*args) -> None:
    """``_mesh_records`` as a process's exit code."""
    raise SystemExit(_mesh_records(*args))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=REG.ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape (as with neither --arch nor "
                         "--shape)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--probe", action="store_true",
                    help="also run steps at trip counts 2 and 3 on the "
                         "device and extrapolate peak memory and ms")
    ap.add_argument("--multi-pod", action="store_true",
                    help="records on the 2x16x16 production mesh instead "
                         "of the one-card record")
    ap.add_argument("--both-meshes", action="store_true",
                    help="records on the 16x16 and 2x16x16 production "
                         "meshes instead of the one-card record")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    archs = list(REG.ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = (list(INPUT_SHAPES) if args.all or not args.shape
              else [args.shape])
    if args.multi_pod or args.both_meshes:
        child = None
        if args.both_meshes:
            # the 2x16x16 records in a process of their own, side by side
            import multiprocessing as mp

            child = mp.get_context("spawn").Process(
                target=_mesh_child, args=(archs, shapes, True,
                                            args.out or None))
            child.start()
        try:
            rc = _mesh_records(archs, shapes, not args.both_meshes,
                               args.out or None)
        finally:
            if child is not None:
                child.join()
        return int(rc or (child is not None and child.exitcode != 0))
    n_bad = 0
    for arch in archs:
        for shape in shapes:
            rec = run_one(arch, shape, args.out or None, probes=args.probe,
                          device=args.device)
            n_bad += rec["status"] == "error"
    return 1 if n_bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
