"""The collectives the distributed consensus and the agent-sharded step use,
on ``torch.distributed``, with a count of calls, bytes and (when asked)
milliseconds per op.

Backends are the caller's choice: ``nccl`` where each rank has its own
card, ``gloo`` for CPU ranks and for ranks that share one card.  Gloo runs
``all_reduce`` on CUDA tensors itself (through host memory inside gloo);
it has no ``all_gather``, ``reduce_scatter`` or point-to-point ops for
CUDA tensors, so on a gloo group those stage a CUDA tensor through host
memory here,
explicitly (``staged`` in the counts).  No op falls back to another
backend.

A ``group`` argument is a ``ProcessGroup``, ``None`` (the default group)
or a ``(DeviceMesh, dim name)`` pair, which names the mesh dimension's
group.

Tensor parallelism over the ``model`` axis uses two autograd functions:
``copy_to_model`` (forward identity, backward the gradient's all-reduce)
at the entry of a region whose work is split over the group, and on every
replicated parameter used inside it; ``reduce_from_model`` (forward an
all-reduce in f32, rounded once to the input's dtype; backward identity)
at its exit.  ``all_reduce_max`` serves the vocab-split log-sum-exp and
argmax.  ``gather_from_model`` (forward an all-gather along one dim,
backward this rank's slice of the gradient) puts a split activation back
together where a replicated consumer needs all of it (MLA's latent and its
output columns).

The fsdp rule splits a weight over the data axes: ``gather_from_data``
(forward an all-gather along the split dim, backward the gradient's
``reduce_scatter``: each rank's rows give a part of every element's
gradient, summed over the group in f32, and each rank keeps its block)
puts a layer's weight together at use.

On the ``meta`` device (the dry-run's shape-only steps) an op is counted
and not issued: its result has the right shape and no values.
"""
from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

OPS = ("all_reduce", "all_gather", "reduce_scatter", "send_recv")
#: each op's kind in the JAX package's partitioned HLO (the dry-run's names)
HLO_KIND = {"all_reduce": "all-reduce", "all_gather": "all-gather",
            "reduce_scatter": "reduce-scatter",
            "send_recv": "collective-permute"}

#: per op: calls, bytes (each rank's input), ms (host clock, only while
#: ``timed()`` is active: a device sync before and after each call) and
#: the calls staged through host memory
COUNTS: Dict[str, Dict[str, float]] = {}
#: the same per group: ``{label: {op: {calls, bytes, ms}}}``, the label
#: the mesh dimension's name of a ``(DeviceMesh, name)`` group, "world"
#: for the default group, else "group"
GROUP_COUNTS: Dict[str, Dict[str, Dict[str, float]]] = {}
_timing = [False]


def reset_counts() -> None:
    COUNTS.clear()
    COUNTS.update({op: {"calls": 0, "bytes": 0, "ms": 0.0, "staged": 0}
                   for op in OPS})
    GROUP_COUNTS.clear()


def hlo_counts() -> Dict[str, Dict[str, float]]:
    """``COUNTS`` of the ops called at least once, by HLO kind:
    ``{kind: {"calls", "bytes"}}``."""
    return {HLO_KIND[op]: {"calls": c["calls"], "bytes": c["bytes"]}
            for op, c in COUNTS.items() if c["calls"]}


reset_counts()


@contextlib.contextmanager
def timed():
    """Time every collective on the host clock, between device syncs."""
    prev, _timing[0] = _timing[0], True
    try:
        yield
    finally:
        _timing[0] = prev


def _label(group: Any) -> str:
    if isinstance(group, tuple):
        return group[1]
    return "world" if group is None else "group"


@contextlib.contextmanager
def _counted(op: str, t: torch.Tensor, staged: bool, label: str = "group"):
    c = COUNTS[op]
    g = GROUP_COUNTS.setdefault(label, {}).setdefault(
        op, {"calls": 0, "bytes": 0, "ms": 0.0})
    n = t.numel() * t.element_size()
    for d in (c, g):
        d["calls"] += 1
        d["bytes"] += n
    c["staged"] += int(staged)
    if not _timing[0]:
        yield
        return
    sync = t.is_cuda
    if sync:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    yield
    if sync:
        torch.cuda.synchronize(t.device)
    ms = (time.perf_counter() - t0) * 1e3
    c["ms"] += ms
    g["ms"] += ms


def resolve_group(group: Any):
    """A ``ProcessGroup`` for ``group`` (see the module docstring)."""
    if isinstance(group, tuple):
        mesh, name = group
        return mesh.get_group(name)
    return group if group is not None else dist.group.WORLD


def world_size(group: Any) -> int:
    return dist.get_world_size(resolve_group(group))


def rank(group: Any) -> int:
    return dist.get_rank(resolve_group(group))


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(t: torch.Tensor, group: Any, op) -> torch.Tensor:
    label, group = _label(group), resolve_group(group)
    with _counted("all_reduce", t, False, label):
        if not t.is_meta:
            dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_sum(t: torch.Tensor, group: Any = None) -> torch.Tensor:
    """Sum ``t`` over the group's ranks, in place; returns it."""
    return _all_reduce(t, group, dist.ReduceOp.SUM)


def all_reduce_max(t: torch.Tensor, group: Any = None) -> torch.Tensor:
    """The elementwise max of ``t`` over the group's ranks, in place;
    returns it."""
    return _all_reduce(t, group, dist.ReduceOp.MAX)


def _sum_f32(t: torch.Tensor, group: Any) -> torch.Tensor:
    """``t`` summed over the group in f32 (into a new tensor), rounded
    once to ``t``'s dtype."""
    return all_reduce_sum(t.to(torch.float32, copy=True), group).to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over the group (in
    f32): the entry of a region whose ranks each take a part of the work
    on the same ``x``, or a replicated parameter used inside one."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of every rank's ``x`` over the group, in f32 and rounded
    once to ``x``'s dtype; the backward passes the gradient through (every
    rank holds all of it)."""
    return _ReduceFromModel.apply(x, group)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.rank, ctx.n = rank(group), x.shape[dim]
        parts = all_gather(x.contiguous(), group)       # (world, ...)
        return parts.movedim(0, dim).flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def gather_from_model(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (one
    all-gather, exact); the backward takes this rank's slice of the
    gradient, which every rank holds whole."""
    return _GatherFromModel.apply(x, dim % x.dim(), group)


def all_gather(t: torch.Tensor, group: Any = None) -> torch.Tensor:
    """Every rank's ``t``, stacked in rank order: ``(world,) + t.shape``."""
    label, group = _label(group), resolve_group(group)
    if t.is_meta:
        with _counted("all_gather", t, False, label):
            return t.new_empty((dist.get_world_size(group),)
                               + tuple(t.shape))
    staged = _staged(group, t)
    with _counted("all_gather", t, staged, label):
        # gloo has no all_gather for CUDA tensors: through host memory
        src = t.detach().cpu() if staged else t.detach().contiguous()
        out = src.new_empty((dist.get_world_size(group),) + tuple(t.shape))
        dist.all_gather(list(out.unbind(0)), src, group=group)
    return out.to(t.device) if staged else out


def reduce_scatter(t: torch.Tensor, dim: int, group: Any = None
                   ) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``t``
    over the group (``dim`` split into world blocks in rank order),
    summed in f32 and rounded once to ``t``'s dtype, as ``_sum_f32``
    does.  The count is of the f32 input."""
    label, group = _label(group), resolve_group(group)
    w = dist.get_world_size(group)
    dim %= t.dim()
    if t.shape[dim] % w:
        raise ValueError(f"a dim of {t.shape[dim]} over {w} ranks")
    n = t.shape[dim] // w
    f = t.to(torch.float32)
    if f.is_meta:
        with _counted("reduce_scatter", f, False, label):
            return t.new_empty(t.shape[:dim] + (n,) + t.shape[dim + 1:])
    staged = _staged(group, t)
    with _counted("reduce_scatter", f, staged, label):
        # gloo has no reduce_scatter for CUDA tensors: through host memory
        src = f.detach().cpu() if staged else f.detach()
        parts = [p.contiguous() for p in src.movedim(dim, 0).chunk(w)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=group)
    out = out.movedim(0, dim)
    return (out.to(t.device) if staged else out).to(t.dtype)


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        parts = all_gather(x.contiguous(), group)       # (world, ...)
        return parts.movedim(0, dim).flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


def gather_from_data(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (one
    all-gather, exact): an fsdp-split weight put together at use.  The
    backward reduce-scatters the gradient: each rank's rows give a part of
    every element's gradient, and the sum over the group (in f32) of this
    rank's block is its shard's gradient."""
    return _GatherFromData.apply(x, dim % x.dim(), group)


def shift(t: torch.Tensor, k: int, group: Any = None) -> torch.Tensor:
    """Rank ``(r - k) % world``'s ``t``: every rank sends its own to rank
    ``(r + k) % world`` (one ``batch_isend_irecv``; the counterpart of a
    ``ppermute`` by k)."""
    label, group = _label(group), resolve_group(group)
    w, r = dist.get_world_size(group), dist.get_rank(group)
    if t.is_meta:
        with _counted("send_recv", t, False, label):
            return torch.empty_like(t)
    staged = _staged(group, t)
    with _counted("send_recv", t, staged, label):
        # gloo has no send/recv for CUDA tensors: through host memory
        src = t.detach().cpu() if staged else t.detach().contiguous()
        out = torch.empty_like(src)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src,
                       dist.get_global_rank(group, (r + k) % w), group),
            dist.P2POp(dist.irecv, out,
                       dist.get_global_rank(group, (r - k) % w), group)])
        for req in reqs:
            req.wait()
    return out.to(t.device) if staged else out


# ------------------------------------------------------------------ ranks

#: respawns of a whole world after a rank's ``init_process_group`` lost
#: a connection in gloo's rendezvous
INIT_RETRIES = 2
#: the texts of that failure ("Gloo connectFullMesh failed ... Connection
#: closed by peer"); any other failure to join is raised at once
RENDEZVOUS_ERRORS = ("connectFullMesh", "Connection closed by peer")
#: seconds a rank waits for every rank to join before it gives up
JOIN_TIMEOUT_S = 600.0


def _mark(path: str, text: str = "") -> None:
    with open(path, "w") as f:
        f.write(text)


def _rank_entry(rank: int, world: int, store_path: str, backend: str,
                threads: int, fn: Callable, args: tuple) -> None:
    """Join the group, wait until every rank has joined, then run ``fn``.
    Beside the store it leaves ``init_failed.<rank>`` (holding the error)
    if joining failed and ``ran.<rank>`` before ``fn`` runs, which
    :func:`rendezvous_failed` reads."""
    torch.set_num_threads(threads)
    marks = os.path.dirname(store_path)
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        # no rank runs fn before every rank's transport is up, so a world
        # whose init failed has run nothing of fn
        store.add("joined", 1)
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        while store.add("joined", 0) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank {rank}: not every rank of {world} "
                                   f"joined within {JOIN_TIMEOUT_S} s")
            time.sleep(0.01)
    except BaseException as e:
        _mark(os.path.join(marks, f"init_failed.{rank}"),
              f"{type(e).__name__}: {e}")
        raise
    _mark(os.path.join(marks, f"ran.{rank}"))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def rendezvous_failed(marks_dir: str) -> Optional[str]:
    """The error of a rank of the world whose store is in ``marks_dir``
    that lost a connection in gloo's rendezvous (one of
    RENDEZVOUS_ERRORS), where no rank had started ``fn``; else None."""
    names = os.listdir(marks_dir)
    if any(m.startswith("ran.") for m in names):
        return None
    for m in sorted(names):
        if m.startswith("init_failed."):
            with open(os.path.join(marks_dir, m)) as f:
                text = f.read()
            if any(r in text for r in RENDEZVOUS_ERRORS):
                return text
    return None


def spawn(fn: Callable, world: int, *args, backend: str = "gloo",
          store_dir: Optional[str] = None, threads: Optional[int] = None,
          join: bool = True, retries: int = INIT_RETRIES):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes, each
    a rank of a default ``backend`` group on a ``FileStore`` in
    ``store_dir`` (a temp dir unless given), with ``threads`` intra-op
    threads (this process's split over the ranks unless given).  ``fn`` and
    ``args`` are pickled: ``fn`` must be importable by name.  Raises if a
    rank raises.  With ``join=False`` it returns at once with the
    processes' ``ProcessContext`` (``while not ctx.join(): pass`` waits
    for them); ``store_dir`` is then required.

    A rank runs ``fn`` only after every rank has joined the group.  With
    ``join=True``, a world in which a rank lost a connection in gloo's
    rendezvous ("Gloo connectFullMesh failed ... Connection closed by
    peer", seen on loaded hosts; its cause is not known) is spawned again
    on a fresh store, at most ``retries`` times, each retry said on
    stderr.  Any other failure to join, and any failure once ``fn`` has
    started, is raised at once.  (A caller that joins a ``join=False``
    world itself reads :func:`rendezvous_failed` on ``store_dir``.)"""
    import torch.multiprocessing as mp

    threads = threads or max(1, torch.get_num_threads() // world)
    if not join:
        if store_dir is None:
            raise ValueError("spawn(join=False) needs a store_dir")
        return mp.spawn(_rank_entry, args=(
            world, os.path.join(store_dir, "store"), backend, threads, fn,
            args), nprocs=world, join=False)
    for attempt in range(retries + 1):
        with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_",
                                         dir=store_dir) as d:
            try:
                mp.spawn(_rank_entry, args=(world, os.path.join(d, "store"),
                                            backend, threads, fn, args),
                         nprocs=world, join=True)
                return
            except Exception:
                why = rendezvous_failed(d)
                if attempt == retries or why is None:
                    raise
                print(f"comm.spawn: a rank of {world} lost a connection in "
                      f"the {backend} rendezvous before any ran "
                      f"{fn.__name__} ({why.strip()[-300:]}); respawning "
                      f"the world on a fresh store (retry {attempt + 1} of "
                      f"{retries})", file=sys.stderr, flush=True)
