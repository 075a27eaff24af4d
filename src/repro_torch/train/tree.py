"""Parameter and state trees walked in the JAX package's order.

``jax.tree`` flattens a dict by its sorted keys, a list or tuple by index
and a ``NamedTuple`` by field; ``None`` holds no leaf.  Everything that
sums or numbers leaves in the JAX package follows that order: the f32 sum
of ``global_norm``, Adafactor's per-leaf index and the checkpoint's leaf
files (numbered in the sorted order of the path strings).  The port's
optimizer, norm and checkpoint walk trees through this module only.

A path is a tuple of the JAX package's key strings: a dict key, a list
index (``"0"``) or a ``NamedTuple`` field with a leading dot (``".step"``,
what ``str(jax.tree_util.GetAttrKey)`` gives).
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["leaves_with_path", "leaves", "map", "unflatten", "path_key"]

SEP = "|"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """[(key string, child)] of an inner node in JAX order, or None for a
    leaf (a type that sets ``_tree_leaf``, such as a partition spec, is
    one, as JAX's ``PartitionSpec`` is)."""
    if getattr(type(node), "_tree_leaf", False):
        return None
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if node is None:
        return []
    return None


def leaves_with_path(tree, prefix: tuple = ()) -> list:
    """[(path, leaf)] in JAX order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out += leaves_with_path(v, prefix + (k,))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def path_key(path: tuple) -> str:
    """The checkpoint's key of a path: ``params|group0_dense|attn|wq``."""
    return SEP.join(path)


def _rebuild(node, kids: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), kids))
    if _is_namedtuple(node):
        return type(node)(*kids)
    if isinstance(node, tuple):
        return tuple(kids)
    if isinstance(node, list):
        return list(kids)
    return None


def map(fn: Callable, tree, *rest) -> Any:
    """``fn(leaf, *matching)`` over the leaves of ``tree``, rebuilt in its
    structure.  The trees of ``rest`` are walked only as deep as ``tree``
    (``flatten_up_to``): where ``tree`` has a leaf they may hold a
    subtree, which ``fn`` receives whole."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [[c for _, c in _children(r)] if kids else [] for r in rest]
    return _rebuild(tree, [map(fn, v, *(o[i] for o in others))
                           for i, (_, v) in enumerate(kids)])


def unflatten(template, new_leaves: list) -> Any:
    """``template``'s structure with ``new_leaves`` (in JAX order) in
    place of its leaves."""
    it = iter(new_leaves)
    out = map(lambda _leaf: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
