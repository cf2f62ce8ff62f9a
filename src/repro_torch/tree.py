"""Nested dicts of tensors as trees: the port's stand-in for ``jax.tree``.

A tree is a dict, nested to any depth, whose non-dict values are its leaves.
Every walk visits keys in sorted order, as ``jax.tree`` flattens a dict, so
a sum over leaves adds in the reference's order and a leaf's path names the
same leaf in both packages (``"/".join`` of its keys: the checkpoint's
object keys).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def leaves_with_path(tree: Any, is_leaf: Optional[Callable] = None,
                     path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """``[(path, leaf)]`` in sorted-key order; ``is_leaf(x)`` true stops the
    walk at ``x`` even where it is a dict."""
    if not isinstance(tree, dict) or (is_leaf is not None and is_leaf(tree)):
        return [(path, tree)]
    out = []
    for k in sorted(tree):
        out.extend(leaves_with_path(tree[k], is_leaf, path + (str(k),)))
    return out


def leaves(tree: Any, is_leaf: Optional[Callable] = None) -> list:
    """The leaves in sorted-key order (``jax.tree.leaves``)."""
    return [leaf for _, leaf in leaves_with_path(tree, is_leaf)]


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable] = None) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of ``rest``,
    which have ``tree``'s structure (``jax.tree.map``)."""
    if not isinstance(tree, dict) or (is_leaf is not None and is_leaf(tree)):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
            for k in sorted(tree)}


def unflatten(like: Any, values) -> Any:
    """The tree of ``like``'s structure, empty dicts kept, with ``values``
    as its leaves in :func:`leaves`' order (``jax.tree.unflatten``)."""
    it = iter(values)
    return tree_map(lambda _leaf: next(it), like)
