"""Minimal pytree helpers for the port's parameter and cache trees.

The JAX package moves parameters, optimizer state and KV caches as
nested dicts / lists / tuples of arrays and walks them with
``jax.tree.*``.  The port keeps the same tree layout with tensors at
the leaves; these helpers walk it in JAX's order (dict keys sorted,
sequences in order), so a flattened leaf list lines up with
``jax.tree.leaves`` of the same tree.  ``None`` is an empty subtree, as
in JAX.
"""
from __future__ import annotations

from typing import Any, Callable

Tree = Any


def _is_node(x: Any) -> bool:
    return isinstance(x, (dict, list, tuple)) or x is None


def _collect(t, is_leaf, out: list) -> None:
    # a module-level walk, not a closure that calls itself: such a
    # closure is a reference cycle holding ``out`` (every leaf) until the
    # garbage collector runs
    if is_leaf is not None and is_leaf(t):
        out.append(t)
    elif t is None:
        return
    elif isinstance(t, dict):
        for k in sorted(t):
            _collect(t[k], is_leaf, out)
    elif isinstance(t, (list, tuple)):
        for v in t:
            _collect(v, is_leaf, out)
    else:
        out.append(t)


def tree_leaves(tree: Tree, is_leaf: Callable[[Any], bool] = None) -> list:
    out: list = []
    _collect(tree, is_leaf, out)
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree,
             is_leaf: Callable[[Any], bool] = None) -> Tree:
    """``jax.tree.map`` over trees of identical structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def tree_unflatten_like(template: Tree, leaves: list,
                        is_leaf: Callable[[Any], bool] = None) -> Tree:
    """Rebuild ``template``'s structure from ``leaves`` (in
    :func:`tree_leaves` order)."""
    return _build(template, iter(leaves), is_leaf)


def _build(t, it, is_leaf):
    # module-level for the reason :func:`_collect` gives
    if is_leaf is not None and is_leaf(t):
        return next(it)
    if t is None:
        return None
    if isinstance(t, dict):
        vals = {k: _build(t[k], it, is_leaf) for k in sorted(t)}
        return {k: vals[k] for k in t}
    if isinstance(t, (list, tuple)):
        out = [_build(v, it, is_leaf) for v in t]
        return tuple(out) if isinstance(t, tuple) else out
    return next(it)
