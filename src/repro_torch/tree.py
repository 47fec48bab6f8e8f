"""Parameter trees: nested ``dict``s and ``NamedTuple``s of tensors, or a
bare tensor.

The JAX package walks pytrees with ``jax.tree``; the port's parameters,
optimizer states and decode caches are plain dicts (flattened in sorted-key
order, the order ``jax.tree.leaves`` uses for dicts) and NamedTuples (the
cache records ``KVCache`` and ``MambaCache``, flattened in field order, as
``jax.tree`` does), so sums over leaves run in the same order in both
packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Tree = Any


def _is_namedtuple(tree: Tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def flatten(tree: Tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; anything but a dict or a NamedTuple is one
    leaf."""
    if isinstance(tree, dict):
        keys, kind = sorted(tree), dict
        items = [tree[k] for k in keys]
    elif _is_namedtuple(tree):
        keys, items, kind = tree._fields, list(tree), type(tree)
    else:
        return [tree], None
    leaves: List[Any] = []
    defs = []
    for k, item in zip(keys, items):
        sub, d = flatten(item)
        leaves += sub
        defs.append((k, d, len(sub)))
    return leaves, (kind, defs)


def unflatten(treedef: Any, leaves: List[Any]) -> Tree:
    if treedef is None:
        return leaves[0]
    kind, defs = treedef
    out, i = {}, 0
    for k, d, m in defs:
        out[k] = unflatten(d, leaves[i:i + m])
        i += m
    return out if kind is dict else kind(**out)


def leaves(tree: Tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over matching leaves of ``tree`` and ``rest`` (same structure)."""
    flat, td = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(td, [fn(*xs) for xs in zip(flat, *others)])
