"""Nested parameter trees: dicts, lists, tuples and NamedTuples of tensors.

The port keeps the reference's pytrees as plain containers.  Leaves are
visited in ``jax.tree`` order: dict keys sorted, sequences and NamedTuple
fields in order, so that sums over leaves (the global gradient norm) and
checkpoint indices follow the reference's order where the trees agree.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _children(tree) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield str(k), tree[k]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield k, getattr(tree, k)
    else:
        for i, v in enumerate(tree):
            yield str(i), v


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path "a/0/b", leaf)] in leaf order."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for k, v in _children(tree):
        out += leaves_with_paths(v, f"{prefix}/{k}" if prefix else k)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, flat) -> Any:
    """A tree of ``like``'s structure whose leaves are ``flat``, in leaf
    order."""
    it = iter(flat)

    def build(t):
        if not _is_node(t):
            return next(it)
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}          # keep the key order
        vals = [build(v) for v in t]
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*vals)
        return type(t)(vals)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    flats = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(f) != len(flats[0]) for f in flats):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*flats)])


def leaves_up_to(like, tree) -> list:
    """The subtrees of ``tree`` at the places of ``like``'s leaves, in
    leaf order: ``tree`` has ``like``'s structure down to those places
    and anything below them (a spec tuple, say) is taken whole."""
    if not _is_node(like):
        return [tree]
    out = []
    if isinstance(like, dict):
        for k, v in _children(like):
            out += leaves_up_to(v, tree[k])
    elif isinstance(like, tuple) and hasattr(like, "_fields"):
        for k, v in _children(like):
            out += leaves_up_to(v, getattr(tree, k))
    else:
        if len(like) != len(tree):
            raise ValueError("trees differ in their number of leaves")
        for v, t in zip(like, tree):
            out += leaves_up_to(v, t)
    return out
