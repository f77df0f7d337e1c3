"""Trees of tensors: the few ``jax.tree`` functions the training path needs.

A tree is nested dicts, lists and tuples with tensors (or numpy arrays) at
the leaves; a ``QTensor`` is a node whose children are ``q`` and ``scale``;
None is an empty subtree.  Leaves come in ``jax.tree``'s order (dict entries
by sorted key, sequences in order), and a leaf's path names its keys as the
reference's checkpoints do (``opt/m/blocks/0/mamba/in_proj``, a QTensor's
children ``.../0`` and ``.../1``), so the two packages' trees line up leaf
for leaf.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_leaves", "tree_map", "tree_flatten_with_path", "tree_unflatten"]


def _qtensor() -> type:
    # imported at use: repro_torch.optim imports this module
    from repro_torch.optim.quant import QTensor

    return QTensor


def _children(node, qtensor: type) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of an inner node in leaf order, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    if isinstance(node, qtensor):
        return [("0", node.q), ("1", node.scale)]
    return None


def _rebuild(node, children: list, qtensor: type):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if isinstance(node, qtensor):
        return qtensor(q=children[0], scale=children[1], shape=node.shape, pow=node.pow)
    return type(node)(children)


def _walk(node, path: tuple, is_leaf, qtensor: type, out: list) -> None:
    # a module-level function, not a closure: a recursive closure is a
    # reference cycle, and ``out`` (every leaf) would live until the cyclic
    # collector runs, holding gradients and replaced states on the device
    if node is None:
        return
    kids = None if is_leaf is not None and is_leaf(node) else _children(node, qtensor)
    if kids is None:
        out.append(("/".join(path), node))
        return
    for k, c in kids:
        _walk(c, path + (k,), is_leaf, qtensor, out)


def tree_flatten_with_path(tree, is_leaf: Callable | None = None) -> list[tuple[str, Any]]:
    """(path, leaf) pairs in leaf order; ``is_leaf`` may stop the descent
    at a node (the reference's ``is_leaf=`` of ``jax.tree``)."""
    out: list[tuple[str, Any]] = []
    _walk(tree, (), is_leaf, _qtensor(), out)
    return out


def tree_leaves(tree, is_leaf: Callable | None = None) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree, is_leaf)]


def _build(node, it, is_leaf, qtensor: type):
    # module-level for the same reason as ``_walk``
    if node is None:
        return None
    kids = None if is_leaf is not None and is_leaf(node) else _children(node, qtensor)
    if kids is None:
        return next(it)
    return _rebuild(node, [_build(c, it, is_leaf, qtensor) for _, c in kids], qtensor)


def tree_unflatten(template, leaves: list, is_leaf: Callable | None = None):
    """``template``'s structure with ``leaves`` in leaf order (QTensor nodes
    rebuilt with the template's shape and pow)."""
    it = iter(leaves)
    out = _build(template, it, is_leaf, _qtensor())
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable | None = None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    flats = [tree_leaves(t, is_leaf) for t in (tree, *rest)]
    if any(len(f) != len(flats[0]) for f in flats):
        raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*flats)], is_leaf)
