"""Parameter and state trees: nested dicts, lists, tuples and dataclasses
with tensor leaves (``None`` is an empty subtree, as in a JAX pytree).

The port's counterpart of ``jax.tree``: leaves come in JAX's order (dict
keys sorted, dataclass fields in declaration order), and each leaf's path
is written as ``jax.tree_util.keystr`` writes it (``['embed']``, ``[0]``,
``.params``), so the sharding rules read the reference's paths and the
checkpoint keys read alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Tuple

__all__ = ["tree_leaves", "tree_paths", "tree_map", "tree_flatten"]


def _children(tree) -> List[Tuple[str, Any]]:
    """(path piece, child) pairs of a node, or [] for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return []


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple)) or (
        dataclasses.is_dataclass(tree) and not isinstance(tree, type))


def tree_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) for every leaf of ``tree``, in JAX's order."""
    if tree is None:
        return
    if not _is_node(tree):
        yield prefix, tree
        return
    for piece, child in _children(tree):
        yield from tree_paths(child, prefix + piece)


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def _rebuild(tree, it):
    if tree is None:
        return None
    if not _is_node(tree):
        return next(it)
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}           # the tree's own order
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return dataclasses.replace(tree, **{
        f.name: _rebuild(getattr(tree, f.name), it)
        for f in dataclasses.fields(tree)})


def tree_flatten(tree) -> Tuple[list, Callable[[list], Any]]:
    """(leaves, unflatten): ``unflatten(new_leaves)`` builds a tree of
    ``tree``'s structure from leaves in ``tree_leaves`` order."""
    return tree_leaves(tree), lambda leaves: _rebuild(tree, iter(leaves))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (same structure; ``None`` subtrees stay ``None``)."""
    others = [tree_leaves(r) for r in rest]
    leaves = tree_leaves(tree)
    if any(len(o) != len(leaves) for o in others):
        raise ValueError("trees differ in their number of leaves")
    return _rebuild(tree, iter(fn(*xs) for xs in zip(leaves, *others)))
