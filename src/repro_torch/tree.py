"""Parameter trees: nested ``dict``s of tensors, or a bare tensor.

The JAX package walks pytrees with ``jax.tree``; the port's parameters and
optimizer states are plain dicts, flattened in sorted-key order (the order
``jax.tree.leaves`` uses for dicts), so sums over leaves run in the same
order in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Tree = Any


def flatten(tree: Tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; a non-dict is one leaf."""
    if not isinstance(tree, dict):
        return [tree], None
    leaves: List[Any] = []
    defs = []
    for k in sorted(tree):
        sub, d = flatten(tree[k])
        leaves += sub
        defs.append((k, d, len(sub)))
    return leaves, defs


def unflatten(treedef: Any, leaves: List[Any]) -> Tree:
    if treedef is None:
        return leaves[0]
    out, i = {}, 0
    for k, d, m in treedef:
        out[k] = unflatten(d, leaves[i:i + m])
        i += m
    return out


def leaves(tree: Tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over matching leaves of ``tree`` and ``rest`` (same structure)."""
    flat, td = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(td, [fn(*xs) for xs in zip(flat, *others)])
