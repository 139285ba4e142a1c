"""Nested dict / list / NamedTuple trees of tensors, walked in JAX's order.

The port keeps the JAX package's parameter and optimizer layouts (dicts,
lists, ``OptState``), so checkpoints and converters address leaves by the
same paths.  JAX visits a dict's keys sorted, a list or tuple by index
and a NamedTuple by field; ``None`` is an empty subtree.  A dataclass
registered with :func:`register_dataclass` (JAX's
``jax.tree_util.register_dataclass``) is an inner node whose children
are its data fields in the order given; its other fields ride along.
These helpers visit in that order, so a leaf's path and position agree
across the two packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

#: dataclass type -> its data fields, in the order they are visited
_DATACLASSES: Dict[type, Tuple[str, ...]] = {}


def register_dataclass(cls: type, data_fields: Sequence[str]) -> type:
    """Walk ``cls``'s instances as inner nodes over ``data_fields`` (in
    that order); the other fields are metadata, kept as they are."""
    _DATACLASSES[cls] = tuple(data_fields)
    return cls


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> List[Tuple[str, Any]]:
    """(path piece, child) of an inner node, in JAX's order; [] for a
    leaf (anything that is not a dict, list, tuple, registered dataclass
    or None)."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    fields = _DATACLASSES.get(type(node))
    if fields is not None:
        return [(f, getattr(node, f)) for f in fields]
    return []


def _is_inner(node) -> bool:
    return (node is None or isinstance(node, (dict, list, tuple))
            or type(node) in _DATACLASSES)


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
    if type(node) in _DATACLASSES:
        return dataclasses.replace(node, **dict(zip(
            _DATACLASSES[type(node)], kids)))
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
