"""Path-keyed walks over the port's trees: nested dicts and NamedTuples (such
as ``optim.adamw.OptState``) of tensors.  Anything else is a leaf, a
sharding spec's tuple included.  This module alone knows the reference's
path format.

:func:`walk` and :func:`flatten_with_path` go in ``jax.tree_util``'s order:
dict keys sorted, a NamedTuple's fields in declaration order.
:func:`keystr` writes a path as ``jax.tree_util.keystr`` does: a dict entry
``['key']``, a NamedTuple field ``.name``.  So a leaf's path in a port tree
is the reference's path of the same leaf
(``['opt'].m['blocks']['p0']['attn']['wq']``), which is what the checkpoint
manifests, the weight-decay mask and the sharding reports key on.
:func:`map_leaves` and :func:`map_with_path` keep the tree's own key order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


class Field(str):
    """A NamedTuple field in a path (``keystr`` writes it ``.name``)."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def walk(tree, path: tuple = ()) -> Iterator[Tuple[tuple, Any]]:
    """``(path, leaf)`` for every leaf, in ``jax.tree_util`` order; a path
    is a tuple of dict keys and :class:`Field` names, after ``path``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], path + (k,))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from walk(getattr(tree, name), path + (Field(name),))
    else:
        yield path, tree


def keystr(path) -> str:
    """A :func:`walk` path as the reference's ``jax.tree_util.keystr``
    writes it."""
    return "".join(f".{k}" if isinstance(k, Field) else f"[{k!r}]"
                   for k in path)


def flatten_with_path(tree) -> List[Tuple[str, Any]]:
    """``(keystr, leaf)`` for every leaf, in ``jax.tree_util`` order."""
    return [(keystr(p), leaf) for p, leaf in walk(tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in walk(tree)]


_END = object()


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure with its leaves replaced, in :func:`walk`
    order, by ``new_leaves``."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}  # the caller's key order
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, n)) for n in t._fields))
        return next(it)

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


def map_with_path(fn: Callable, tree, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` for every leaf (paths as in :func:`walk`), the
    structure and key order kept."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, getattr(tree, n),
                                          path + (Field(n),))
                            for n in tree._fields))
    return fn(path, tree)


def map_leaves(fn: Callable, tree) -> Any:
    """``fn`` applied to every leaf, the structure and key order kept."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_leaves(fn, v) for v in tree))
    return fn(tree)
