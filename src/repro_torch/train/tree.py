"""Parameter and state trees: nested dicts and lists (and tuples) of
tensors, walked in a fixed order (a dict by its insertion order), the
port's stand-in for jax's pytrees."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def leaves(tree: Any, tuples: bool = True) -> List[Any]:
    """The leaves of ``tree`` in order; with ``tuples=False`` a tuple is a
    leaf (the int8 moments' (codes, scales) pairs)."""
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in leaves(v, tuples)]
    if isinstance(tree, list) or (tuples and isinstance(tree, tuple)):
        return [l for v in tree for l in leaves(v, tuples)]
    return [tree]


def unflatten(like: Any, new: List[Any], tuples: bool = True) -> Any:
    """A tree shaped as ``like`` whose leaves are ``new``, in order."""
    it = iter(new)
    out = _build(like, it, tuples)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _build(like: Any, it: Iterator, tuples: bool) -> Any:
    if isinstance(like, dict):
        return {k: _build(v, it, tuples) for k, v in like.items()}
    if isinstance(like, list) or (tuples and isinstance(like, tuple)):
        return type(like)(_build(v, it, tuples) for v in like)
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer leaves than the tree holds") from None


def tree_map(fn: Callable, tree: Any, *rest: Any, tuples: bool = True) -> Any:
    """fn applied leaf by leaf over trees of one shape."""
    cols = [leaves(t, tuples) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)], tuples)
