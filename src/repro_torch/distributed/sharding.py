"""Logical-axis sharding: the port of the JAX package's
``repro.distributed.sharding``.

Models name the dims of their parameters and activations with logical axes
("heads", "mlp", ...); a rule table maps each logical axis to mesh axes.
Outside a rules+mesh context ``shard`` is a no-op, so the same code runs on
one device and on a mesh.

``PartitionSpec`` is the port's own: a tuple of mesh-axis names, tuples of
names or ``None``, one entry per dim from the left, equal as a tuple to the
JAX package's ``PartitionSpec`` of the same placement.  ``to_placements``
turns one into ``torch.distributed`` DTensor placements on a
``DeviceMesh``.
"""
from __future__ import annotations

import contextlib
import functools
import re
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

_ctx = threading.local()


class PartitionSpec(tuple):
    """Per-dim mesh axes of one array: a name, a tuple of names (the dim is
    split over their product, major first) or ``None`` (replicated).  Dims
    past the end are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


DEFAULT_RULES: Dict[str, Any] = {
    # logical axis -> mesh axis (or tuple, or None)
    "agent": None,        # set by the launcher to the agent mesh axes
    "batch": "data",      # per-agent batch over leftover data axes
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "kv_seq": None,       # decode KV-cache sequence axis
    "fsdp": None,         # param dim-0 axis for FSDP-within-agent
    "frames": None,
    "state": None,
}


@contextlib.contextmanager
def use_rules(rules: Dict[str, Any], mesh=None):
    prev = getattr(_ctx, "rules", None), getattr(_ctx, "mesh", None)
    _ctx.rules, _ctx.mesh = rules, mesh
    try:
        yield
    finally:
        _ctx.rules, _ctx.mesh = prev


def current_rules() -> Optional[Dict[str, Any]]:
    return getattr(_ctx, "rules", None)


def current_mesh():
    return getattr(_ctx, "mesh", None)


def bound(fn):
    """``fn``, run under the rules and mesh active now wherever it is
    called: a function that ``torch.utils.checkpoint`` recomputes in the
    backward, which autograd runs in a thread of its own on a CUDA device
    (where this thread's context is not set).  ``fn`` itself when none is
    active."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None and mesh is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with use_rules(rules, mesh):
            return fn(*args, **kwargs)
    return run


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``torch.distributed`` ``DeviceMesh`` or of
    any object with ``axis_names`` and ``devices.shape`` (the JAX mesh's
    two attributes, which a stub can carry)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))
    return dict(zip(mesh.axis_names, tuple(mesh.devices.shape)))


def logical_to_spec(axes: Sequence[Optional[str]],
                    rules: Optional[Dict[str, Any]] = None) -> PartitionSpec:
    rules = rules if rules is not None else (current_rules() or {})
    spec: List[Any] = []
    used = set()
    for ax in axes:
        m = rules.get(ax) if ax else None
        # a mesh axis may appear only once in a PartitionSpec
        if m is None:
            spec.append(None)
            continue
        ms = tuple(m) if isinstance(m, (tuple, list)) else (m,)
        ms = tuple(a for a in ms if a not in used)
        used.update(ms)
        spec.append(ms if len(ms) > 1 else (ms[0] if ms else None))
    while spec and spec[-1] is None:
        spec.pop()
    return PartitionSpec(*spec)


def divisible_spec(spec: Sequence[Any], shape: Sequence[int],
                   sizes: Dict[str, int]) -> PartitionSpec:
    """``spec`` over every dim of ``shape``, with the mesh axes dropped from
    the dims they do not divide."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, p in zip(shape, parts):
        if p is None:
            out.append(None)
            continue
        prod = 1
        for a in (p if isinstance(p, tuple) else (p,)):
            prod *= sizes[a]
        out.append(p if (prod and dim % prod == 0) else None)
    return PartitionSpec(*out)


def to_placements(spec: Sequence[Any], mesh) -> tuple:
    """DTensor placements (one per mesh dim) for ``spec`` on a
    ``DeviceMesh``: ``Shard(d)`` on each mesh dim that splits tensor dim
    d, ``Replicate()`` on the others.  A dim split over several mesh axes
    gets ``Shard(d)`` on each of them, major first, as a JAX
    ``NamedSharding`` lays it out."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for d, p in enumerate(spec):
        if p is None:
            continue
        for a in (p if isinstance(p, tuple) else (p,)):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Lay ``x`` out as its logical axes say under the active rules and
    mesh.  A no-op without rules and a mesh, and on a plain tensor; a
    ``DTensor`` is redistributed to the spec, with the mesh axes that do
    not divide a dim dropped from it (that dim is replicated)."""
    rules = current_rules()
    mesh = current_mesh()
    if rules is None or mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = divisible_spec(logical_to_spec(axes, rules), x.shape,
                          mesh_axis_sizes(mesh))
    return x.redistribute(mesh, to_placements(spec, mesh))


# ---------------------------------------------------------------- params

# Param-path regex -> logical axes per dim (matched against "a/b/c" paths).
PARAM_AXIS_PATTERNS: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r".*embed/table$", ("vocab", "embed")),
    (r".*lm_head/w$", ("embed", "vocab")),
    (r".*wq/w$", ("fsdp", "heads", None)),
    (r".*(wk|wv)/w$", ("fsdp", "kv_heads", None)),
    (r".*wo_mla/w$", (None, None, "mlp")),
    (r".*wo/w$", ("heads", None, "fsdp")),
    (r".*(q_down|kv_down)/w$", ("fsdp", "mlp")),
    (r".*(q_up|kv_up)/w$", ("mlp", "heads", None)),
    (r".*(gate|up)/w$", ("fsdp", "mlp")),
    (r".*down/w$", ("mlp", "fsdp")),
    (r".*router/w$", ("fsdp", None)),
    (r".*experts/(gate|up)$", ("expert", "fsdp", "mlp")),
    (r".*experts/down$", ("expert", "mlp", "fsdp")),
    (r".*(in_proj|in_x|in_gate)/w$", ("fsdp", "mlp")),
    (r".*(out_proj|out)/w$", ("mlp", "fsdp")),
    (r".*conv/w$", (None, "mlp")),
    (r".*rg_(wa|wx)/w$", ("fsdp", "mlp")),
)


def param_spec(path: str, ndim: int, has_layer_dim: bool,
               rules: Dict[str, Any]) -> PartitionSpec:
    """PartitionSpec for one param leaf.  Dim 0 is the agent-stack dim
    (added by the trainer); ``has_layer_dim`` marks layer-stacked leaves
    whose next dim is the layer index."""
    logical: Tuple[Optional[str], ...] = ()
    for pat, axes in PARAM_AXIS_PATTERNS:
        if re.match(pat, path):
            logical = axes
            break
    prefix = ("agent",) + ((None,) if has_layer_dim else ())
    want = prefix + logical
    want = (want + (None,) * ndim)[:ndim]          # pad/trim to ndim
    return logical_to_spec(want, rules)


def spec_tree(params: Any, rules: Dict[str, Any],
              agent_stacked: bool = True) -> Any:
    """A PartitionSpec tree for a (possibly agent-stacked) param tree.

    Leaf paths are derived from the dict structure.  Layer-stacked blocks
    live under a key containing 'blocks'/'layers'/'groups' (their dim after
    the agent dim is the layer index)."""
    out = {}
    for path, leaf in flatten_with_paths(params).items():
        has_layer = ("blocks" in path or "layers" in path
                     or "groups" in path)
        nd = len(leaf.shape)
        if not agent_stacked:
            # strip the agent entry by computing with a dummy leading dim
            sp = param_spec(path, nd + 1, has_layer, rules)
            sp = PartitionSpec(*tuple(sp)[1:])
        else:
            sp = param_spec(path, nd, has_layer, rules)
        out[path] = sp
    return unflatten_with_paths(out)


def flatten_with_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` over the nested dicts of ``tree``."""
    flat: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(flatten_with_paths(v, f"{prefix}/{k}" if prefix
                                           else k))
    else:
        flat[prefix] = tree
    return flat


def unflatten_with_paths(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


# ------------------------------------------------- tensor-parallel context
# Under ``use_rules(rules, mesh)`` with a ``DeviceMesh`` whose "model" axis
# is wider than 1, the models run tensor-parallel: every rank holds its
# local shard of each leaf (``local_slice`` of the leaf's spec) and reads
# its place on the mesh here, as the JAX models read ``current_mesh()``.

class ModelAxis(NamedTuple):
    group: Any           # ``(mesh, "model")``: a ``distributed.comm`` group
    size: int
    rank: int            # this rank's coordinate on the axis


def model_axis() -> Optional[ModelAxis]:
    """The active mesh's "model" axis when rules and a mesh are active and
    it is wider than 1, else None (every model runs as on one device)."""
    mesh = current_mesh()
    if current_rules() is None or mesh is None:
        return None
    m = mesh_axis_sizes(mesh).get("model", 1)
    if m == 1:
        return None
    return ModelAxis((mesh, "model"), m, mesh.get_local_rank("model"))


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on each axis of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def axes_of(p: Any) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (a name, a tuple or None)."""
    if p is None:
        return ()
    return tuple(p) if isinstance(p, (tuple, list)) else (p,)


def axes_group(mesh, axes: Sequence[str]):
    """A ``distributed.comm`` group over the ranks that differ only in
    ``axes``: ``(mesh, name)`` for one axis, the default group for every
    axis of a mesh that spans it, a flattened sub-mesh's group otherwise
    (made once per mesh and axes: its ranks in the order of the axes'
    coordinates, major first)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return (mesh, axes[0])
    if set(axes) == set(mesh.mesh_dim_names):
        return None
    made = mesh.__dict__.setdefault("_axes_groups", {})
    if axes not in made:
        made[axes] = mesh[axes]._flatten().get_group()
    return made[axes]


def split_index(p: Any, sizes: Dict[str, int],
                coords: Dict[str, int]) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of a dim whose spec entry
    is ``p``: split over its axes major first, as a JAX ``NamedSharding``
    lays it out."""
    idx, n = 0, 1
    for a in axes_of(p):
        idx = idx * sizes[a] + coords[a]
        n *= sizes[a]
    return idx, n


def local_slice(shape: Sequence[int], spec: Sequence[Any],
                sizes: Dict[str, int], coords: Dict[str, int]) -> tuple:
    """The index (one slice per dim) of the local shard at mesh ``coords``
    of an array of ``shape`` under ``spec`` (sanitized: each entry's axes
    divide their dim); the index JAX's ``NamedSharding(mesh, spec)
    .devices_indices_map(shape)`` gives the device at those coordinates."""
    parts = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, p in zip(shape, parts):
        idx, n = split_index(p, sizes, coords)
        if dim % n:
            raise ValueError(f"{p} ({n} blocks) does not divide a dim of "
                             f"{dim}")
        out.append(slice(idx * dim // n, (idx + 1) * dim // n))
    return tuple(out)


def gather(local: torch.Tensor, spec: Sequence[Any], mesh,
           shape: Sequence[int]) -> torch.Tensor:
    """The whole tensor of ``shape`` from every rank's ``local`` shard
    under ``spec`` (an all-gather over the default group, which the mesh
    spans; for checks, not for a step)."""
    from repro_torch.distributed import comm

    parts = comm.all_gather(local.contiguous(), None)
    sizes = mesh_axis_sizes(mesh)
    ranks = mesh.mesh
    out = local.new_empty(tuple(shape))
    for r in range(parts.shape[0]):
        pos = (ranks == r).nonzero()[0].tolist()
        coords = dict(zip(mesh.mesh_dim_names, pos))
        out[local_slice(shape, spec, sizes, coords)] = parts[r]
    return out


class SeqSplit(NamedTuple):
    group: Any           # a ``distributed.comm`` group over the split
    index: int           # this rank's span, 0..n-1
    n: int


def kv_seq_split() -> Optional[SeqSplit]:
    """How the active rules split a decode cache's sequence slots
    ("kv_seq") over the active mesh, when they do; else None.  A cache
    under them is split so (its length divisible by ``n``)."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None:
        return None
    axes = axes_of(rules.get("kv_seq"))
    sizes = mesh_axis_sizes(mesh)
    idx, n = split_index(axes, sizes, mesh_coords(mesh)) if axes else (0, 1)
    if n == 1:
        return None
    return SeqSplit(axes_group(mesh, axes), idx, n)


# ------------------------------------------------------------ data axes
# The "batch" rule splits an agent's rows over the data axes it names, the
# "fsdp" rule one dim of each layer's weights (``PARAM_AXIS_PATTERNS``'
# "fsdp" entries).  A rank holds its rows and its shards; the models gather
# a layer's shards at use (``transformer.layer_gather``).

class DataAxes(NamedTuple):
    group: Any               # a ``distributed.comm`` group over the axes
    size: int                # the product of their sizes (> 1)
    rank: int                # this rank's block over them, major first


def data_axes(rule: str) -> Optional[DataAxes]:
    """The mesh axes that the active ``rule`` ("batch" or "fsdp") spans,
    when rules and a mesh are active and their product is wider than 1,
    else None."""
    mesh, rules = current_mesh(), current_rules()
    if rules is None or mesh is None:
        return None
    axes = axes_of(rules.get(rule))
    sizes = mesh_axis_sizes(mesh)
    idx, n = split_index(axes, sizes, mesh_coords(mesh)) if axes else (0, 1)
    if n == 1:
        return None
    return DataAxes(axes_group(mesh, axes), n, idx)


def fsdp_dims(shapes: Dict[str, Sequence[int]],
              rules: Dict[str, Any], sizes: Dict[str, int]
              ) -> Dict[str, int]:
    """Per leaf of a whole (unsharded, not agent-stacked) parameter tree,
    ``{path: shape}``: the dim of one layer's leaf (its layer dim dropped)
    that the "fsdp" rule splits, for the leaves whose spec
    (``param_spec`` of ``PARAM_AXIS_PATTERNS``, sanitized against
    ``shape``) splits one; leaves it leaves whole are not listed.  Every
    such leaf lies in a layer stack: the patterns name "fsdp" only on
    attention, MLP, MoE, mamba2 and RG-LRU weights, which live in
    ``blocks``, ``dense_blocks``, ``enc_blocks``, ``groups`` and
    ``tail_blocks``; a split leaf outside one raises."""
    fsdp = set(axes_of(rules.get("fsdp")))
    out: Dict[str, int] = {}
    if not fsdp:
        return out
    for path, shape in shapes.items():
        stacked = "blocks" in path or "layers" in path or "groups" in path
        spec = param_spec(path, len(shape) + 1, stacked, rules)[1:]
        spec = divisible_spec(spec, shape, sizes)
        dims = [d for d, p in enumerate(spec) if fsdp & set(axes_of(p))]
        if not dims:
            continue
        if not stacked:
            raise ValueError(f"{path}: an fsdp-split leaf outside a layer "
                             f"stack")
        out[path] = dims[0] - 1
    return out
