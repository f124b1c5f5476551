"""Nested containers of tensors, walked as the reference's pytrees are.

Parameters and optimizer state are nested dicts, lists and tuples of
tensors.  A dict is walked in sorted key order and a list or tuple by
index, as ``jax.tree_util`` flattens them, and a leaf's path is spelled
as ``jax.tree_util.keystr`` spells it (``"['units']['b0'][0]"``), so
a walk here and one over the reference's state visit the same leaves
in the same order under the same names.
"""

from __future__ import annotations

from typing import Callable, Iterator

_NODES = (dict, list, tuple)


def _is_node(t, is_leaf) -> bool:
    return isinstance(t, _NODES) and not (is_leaf is not None
                                          and is_leaf(t))


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable | None = None):
    """``fn`` over the leaves of ``tree``, each called with the matching
    subtrees of ``rest`` (which have ``tree``'s structure at least down
    to its leaves).  Dicts come back with their keys sorted."""
    if not _is_node(tree, is_leaf):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in sorted(tree)}
    return type(tree)(tree_map(fn, t, *(r[i] for r in rest),
                               is_leaf=is_leaf) for i, t in enumerate(tree))


def tree_map_with_keys(fn: Callable, tree,
                       is_leaf: Callable | None = None, keys: tuple = ()):
    """``fn(keys, leaf)`` over the leaves of ``tree`` (``keys`` as
    :func:`leaves_with_keys` gives them), in its structure: the
    reference's ``jax.tree_util.tree_map_with_path``."""
    if not _is_node(tree, is_leaf):
        return fn(keys, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_keys(fn, tree[k], is_leaf, keys + (k,))
                for k in sorted(tree)}
    return type(tree)(tree_map_with_keys(fn, t, is_leaf, keys + (i,))
                      for i, t in enumerate(tree))


def leaves_with_keys(tree, is_leaf: Callable | None = None,
                     keys: tuple = ()) -> Iterator[tuple]:
    """``(keys, leaf)`` for every leaf, in flattening order: ``keys``
    the dict keys and list or tuple indices on the way down; an empty
    container has none."""
    if not _is_node(tree, is_leaf):
        yield keys, tree
        return
    items = ((k, tree[k]) for k in sorted(tree)) \
        if isinstance(tree, dict) else enumerate(tree)
    for k, t in items:
        yield from leaves_with_keys(t, is_leaf, keys + (k,))


def leaves_with_path(tree, is_leaf: Callable | None = None) \
        -> Iterator[tuple]:
    """``(path, leaf)`` for every leaf, in flattening order, the path
    spelled as ``jax.tree_util.keystr`` spells it."""
    for keys, leaf in leaves_with_keys(tree, is_leaf):
        yield "".join(f"[{k!r}]" for k in keys), leaf


def leaves(tree, is_leaf: Callable | None = None) -> list:
    return [leaf for _, leaf in leaves_with_path(tree, is_leaf)]
