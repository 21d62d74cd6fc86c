"""Trees of tensors in the reference's pytree order.

The port's parameters are nested dicts of tensors; the trainer also
carries tuples (``(params, state)``) and NamedTuples (``AdamWState``).
These helpers walk them as ``jax.tree_util`` walks the reference's:
dict keys sorted, sequences in order, a NamedTuple's fields in order.
So a leaf's index and path (``"0/attn_layers/wq"``, ``"1/.mu/embed"``:
a dict key, a sequence index, or ``.`` and a field name, joined by
``/``) are the reference's, which keeps the gradient norm's summation
order and the checkpoint's file names the same in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Mapping, Tuple


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node: Any) -> List[Tuple[str, Any]]:
    """(path part, child) pairs of an inner node; [] for a leaf."""
    if isinstance(node, Mapping):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(node)]
    return []


def _is_leaf(node: Any) -> bool:
    return not isinstance(node, (Mapping, tuple, list))


# The walks below are module functions, not nested ones: a nested
# function that calls itself is a reference cycle (the function and its
# own closure cell), which keeps what its closure holds, every leaf it
# collected, alive until the cyclic collector runs: on the card, the
# previous step's parameters, gradients and optimizer state.

def _walk(node: Any, prefix: Tuple[str, ...],
          out: List[Tuple[str, Any]]) -> None:
    if _is_leaf(node):
        out.append(("/".join(prefix), node))
        return
    for part, child in _children(node):
        _walk(child, prefix + (part,), out)


def leaf_paths(tree: Any) -> List[Tuple[str, Any]]:
    """(path, leaf) for every leaf, in pytree order."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, (), out)
    return out


def leaves(tree: Any) -> List[Any]:
    """Every leaf, in pytree order."""
    return [leaf for _, leaf in leaf_paths(tree)]


def _build(node: Any, it: Iterator) -> Any:
    if _is_leaf(node):
        return next(it)
    if isinstance(node, Mapping):
        return {k: _build(node[k], it) for k in sorted(node)}
    kids = [_build(c, it) for _, c in _children(node)]
    return type(node)(*kids) if _is_namedtuple(node) else type(node)(kids)


def unflatten_like(tree: Any, new_leaves) -> Any:
    """``tree``'s structure with its leaves replaced, in pytree order."""
    it: Iterator = iter(new_leaves)
    out = _build(tree, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def map_leaves(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` leaf by leaf over trees of one structure."""
    cols = [leaves(t) for t in (tree,) + rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different structure")
    return unflatten_like(tree, [fn(*xs) for xs in zip(*cols)])
