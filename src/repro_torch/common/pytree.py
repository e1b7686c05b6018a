"""Pytree helpers over nested dicts, lists, tuples and NamedTuples of
tensors (twin of ``repro/common/pytree.py``).

The flattening order is ``jax.tree_util``'s: dict keys sorted at each level,
lists and tuples in order, a NamedTuple's fields in order, ``None`` an empty
node.  Leaf names join the keys with ``/`` as ``named_leaves`` gives them in
the JAX package, so a JAX tree and its port carry the same names (the
checkpoint manager and the sharding rules match on them).
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> list[tuple[Any, Any]] | None:
    """(key, child) pairs of a node in flattening order, or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if node is None:
        return []
    return None


def _rebuild(node, values: list):
    if isinstance(node, dict):
        keys = sorted(node)
        out = dict(zip(keys, values))
        return {k: out[k] for k in node}           # keep the caller's key order
    if _is_namedtuple(node):
        return type(node)(*values)
    if isinstance(node, tuple):
        return tuple(values)
    if isinstance(node, list):
        return list(values)
    return None


def tree_flatten_with_path(tree: Any, is_leaf: Callable[[Any], bool] | None = None):
    """[(path, leaf)] in ``jax.tree_util`` order; a path is a tuple of keys."""
    out: list[tuple[tuple, Any]] = []

    def walk(node, path):
        kids = None if (is_leaf is not None and is_leaf(node)) else _children(node)
        if kids is None:
            out.append((path, node))
            return
        for k, child in kids:
            walk(child, path + (k,))

    walk(tree, ())
    return out


def tree_leaves(tree: Any, is_leaf: Callable[[Any], bool] | None = None) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree, is_leaf)]


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (which share ``tree``'s structure down to its leaves)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = []
    for r in rest:
        rk = _children(r)
        if rk is None or [k for k, _ in rk] != [k for k, _ in kids]:
            raise ValueError(f"tree structures differ: {[k for k, _ in kids]} vs "
                             f"{None if rk is None else [k for k, _ in rk]}")
        others.append([c for _, c in rk])
    vals = [tree_map(fn, c, *(o[i] for o in others), is_leaf=is_leaf)
            for i, (_, c) in enumerate(kids)]
    return _rebuild(tree, vals)


def tree_zeros_like(tree: Any, dtype=None) -> Any:
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype), tree)


def tree_cast(tree: Any, dtype) -> Any:
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def tree_size(tree: Any) -> int:
    """Total number of elements across all leaves."""
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_bytes(tree: Any) -> int:
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


def tree_global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the summed squares of every leaf in fp32, the leaves summed in
    flattening order from Python's ``sum`` (as the JAX twin)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def tree_add(a: Any, b: Any) -> Any:
    return tree_map(torch.add, a, b)


def tree_scale(tree: Any, s) -> Any:
    return tree_map(lambda x: x * s, tree)


def tree_where(pred, a: Any, b: Any) -> Any:
    return tree_map(lambda x, y: torch.where(pred, x, y), a, b)


def _key_str(k) -> str:
    return str(k)


def named_leaves(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """Flatten to (``a/b/c`` name, leaf) pairs, the JAX package's names."""
    return [(prefix + "/".join(_key_str(k) for k in path), leaf)
            for path, leaf in tree_flatten_with_path(tree)]


def tree_map_with_name(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """Map with access to the ``/``-joined leaf name (for sharding-rule
    matching)."""

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            return fn("/".join(_key_str(k) for k in path), node)
        return _rebuild(node, [walk(c, path + (k,)) for k, c in kids])

    return walk(tree, ())


def value_and_grad(fn: Callable[[Any], Any], params: Any, *, has_aux: bool = False):
    """``(fn(params), d fn / d params)`` by autograd, the gradient in
    ``params``' structure (``jax.value_and_grad``): a leaf ``fn`` does not
    reach gets zeros, as JAX gives.  With ``has_aux`` ``fn`` returns
    ``(value, aux)`` and the result is ``((value, aux), grads)``, aux
    detached.  ``params`` is left untouched."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        out = fn(leaves)
        value = out[0] if has_aux else out
        grads = iter(torch.autograd.grad(value, tree_leaves(leaves), allow_unused=True,
                                         materialize_grads=True))
    grads = tree_map(lambda _: next(grads), params)
    if has_aux:
        return (value.detach(), tree_map(torch.Tensor.detach, out[1])), grads
    return value.detach(), grads
