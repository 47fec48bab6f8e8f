"""Composable optimizer transforms over the port's ``core.frodo.Optimizer``:
the port of the JAX package's ``repro.optim.transforms``.

They wrap a base optimizer (FrODO or a baseline) the way optax chains do,
scaling by a schedule and adding decoupled weight decay, without touching
the fractional-memory semantics: the memory always sees the RAW gradients,
as in Algorithm 1; schedule and decay act on the emitted update.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch import tree as TR
from repro_torch.core.frodo import Optimizer


def scale_by_schedule(base: Optimizer, schedule: Callable) -> Optimizer:
    """delta <- schedule(step) * delta.  The step is a host int."""

    def init(params):
        return {"inner": base.init(params), "step": 0}

    def update(grads, state, params=None):
        delta, inner = base.update(grads, state["inner"], params)
        m = schedule(state["step"])
        delta = TR.tree_map(lambda d: (d * m.to(d.device)).to(d.dtype),
                            delta)
        return delta, {"inner": inner, "step": state["step"] + 1}

    return Optimizer(init, update)


def _paths(tree, prefix: str = "") -> list:
    """The JAX key path string (``jax.tree_util.keystr``) of each leaf, in
    flatten order: ``['a']['b']`` for dict keys, ``.name`` for a
    NamedTuple's fields."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [p for k in tree._fields
                for p in _paths(getattr(tree, k), f"{prefix}.{k}")]
    return [prefix]


def add_decoupled_weight_decay(base: Optimizer, wd: float,
                               mask: Optional[Callable] = None) -> Optimizer:
    """AdamW-style decay: delta <- delta - wd * params (after the inner
    update, so the fractional memory never sees the decay).  ``mask(path)``
    may exclude leaves (norm scales, biases); it receives the leaf's JAX
    key path string."""

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("weight decay needs params")
        delta, state = base.update(grads, state, params)
        flat_p, treedef = TR.flatten(params)
        out = []
        for path, p, d in zip(_paths(params), flat_p, TR.leaves(delta)):
            if mask is not None and not mask(path):
                out.append(d)
            else:
                out.append((d - wd * p.to(d.dtype)).to(d.dtype))
        return TR.unflatten(treedef, out), state

    return Optimizer(base.init, update)


def default_decay_mask(path: str) -> bool:
    """Decay matmul weights only (skip norms/scales/biases/1-d leaves)."""
    return not any(t in path for t in ("scale", "bias", "ln", "norm",
                                       "lambda", "dt_bias", "A_log", "D"))


def chain(base: Optimizer, *, schedule: Optional[Callable] = None,
          weight_decay: float = 0.0) -> Optimizer:
    """Weight decay (with ``default_decay_mask``) inside, then the
    schedule over the decayed update."""
    opt = base
    if weight_decay > 0.0:
        opt = add_decoupled_weight_decay(opt, weight_decay,
                                         default_decay_mask)
    if schedule is not None:
        opt = scale_by_schedule(opt, schedule)
    return opt
