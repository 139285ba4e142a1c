"""Nested dict / list / NamedTuple trees of tensors, walked in JAX's order.

The port keeps the JAX package's parameter and optimizer layouts (dicts,
lists, ``OptState``), so checkpoints and converters address leaves by the
same paths.  JAX visits a dict's keys sorted, a list or tuple by index
and a NamedTuple by field; ``None`` is an empty subtree.  These helpers
visit in that order, so a leaf's path and position agree across the two
packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> List[Tuple[str, Any]]:
    """(path piece, child) of an inner node, in JAX's order; [] for a
    leaf (anything that is not a dict, list, tuple or None)."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return []


def _is_inner(node) -> bool:
    return node is None or isinstance(node, (dict, list, tuple))


def _walk(node, prefix: str, out: list) -> None:
    if not _is_inner(node):
        out.append((prefix or "root", node))
        return
    for piece, child in _children(node):
        _walk(child, f"{prefix}/{piece}" if prefix else piece, out)


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """[(path, leaf)] with paths joined by ``/`` (``params/layers/0/wq``,
    ``opt/count``); a bare leaf is ``root``."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, "", out)
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def _build(node, it):
    """``node``'s structure over the next leaves of ``it``.  Module-level
    recursion on purpose: a nested recursive closure is a reference
    cycle, and it would keep every leaf it saw (a 6.66 GB gradient) alive
    until the garbage collector ran."""
    if not _is_inner(node):
        return next(it)
    if node is None:
        return None
    if isinstance(node, dict):
        # children in sorted-key order (the order leaves are numbered
        # in), returned with the template's key order
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    kids = [_build(c, it) for _, c in _children(node)]
    if _is_namedtuple(node):
        return type(node)(*kids)
    return type(node)(kids)


def unflatten(template, new_leaves) -> Any:
    """``template``'s structure with its leaves replaced, in order, by
    ``new_leaves``."""
    it = iter(new_leaves)
    out = _build(template, it)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the template holds")
    return out


def map_tree(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf by leaf over ``tree`` and trees of the same
    structure."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])
