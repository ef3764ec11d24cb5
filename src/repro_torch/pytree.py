"""Nested containers of tensors, walked the way ``jax.tree_util`` walks the
reference's pytrees, so both packages name and order the same leaves.

* a ``dict`` is visited in sorted key order, its key the path segment;
* a ``list`` or ``tuple`` by position;
* a dataclass (the reference registers its states, ``TrainState`` and
  ``AdamWState``, as pytree nodes flattened in field order) by field
  position, the segment its index;
* ``None`` is an empty subtree, with no leaf;
* anything else is a leaf.

A leaf's path is its segments joined by ``/`` (``"layers/attn/wq"``,
``"1/0/embed"``), the string the reference's checkpointer and arrowhead
preconditioner build from ``tree_leaves_with_path``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Tuple

__all__ = ["leaves_with_path", "leaves", "tree_map", "unflatten"]


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(str(i), getattr(node, f.name)) for i, f in enumerate(dataclasses.fields(node))]
    raise TypeError(f"not a container: {type(node)!r}")


def _is_node(node) -> bool:
    return isinstance(node, (dict, list, tuple)) or (
        dataclasses.is_dataclass(node) and not isinstance(node, type))


def _walk(node, prefix: str) -> Iterator[Tuple[str, Any]]:
    if node is None:
        return
    if not _is_node(node):
        yield prefix, node
        return
    for key, child in _children(node):
        yield from _walk(child, f"{prefix}/{key}" if prefix else key)


def leaves_with_path(tree) -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in the reference's order."""
    return list(_walk(tree, ""))


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in _walk(tree, "")]


def _rebuild(node, it: Iterator[Any]):
    if node is None:
        return None
    if not _is_node(node):
        return next(it)
    if isinstance(node, dict):
        out = {k: None for k in node}            # keep the caller's key order
        for k in sorted(node):
            out[k] = _rebuild(node[k], it)
        return out
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(x, it) for x in node)
    return dataclasses.replace(node, **{f.name: _rebuild(getattr(node, f.name), it)
                                        for f in dataclasses.fields(node)})


def unflatten(template, new_leaves) -> Any:
    """A tree shaped like ``template`` holding ``new_leaves`` in the order
    :func:`leaves` gives them."""
    it = iter(new_leaves)
    out = _rebuild(template, it)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf by leaf across trees of one structure."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(x, *ys) for x, *ys in zip(leaves(tree), *others)])
