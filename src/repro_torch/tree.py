"""Trees of tensors: nested dicts, lists, tuples and NamedTuples, walked in
JAX's pytree order (dict keys sorted, sequences by index, a NamedTuple by
field), so a leaf's path string is the one the reference's checkpoints
write (`repro/train/checkpoint.py::_flatten`): `0/embed/w0` for a dict
inside a tuple, `1/.m/embed/w0` for a NamedTuple's field."""
from __future__ import annotations

from collections.abc import Callable


def _children(node) -> list[tuple[str, object]] | None:
    """(path part, child) pairs of an inner node; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _walk(node, prefix: str, out: list) -> None:
    kids = _children(node)
    if kids is None:
        out.append((prefix, node))
        return
    for part, child in kids:
        _walk(child, f"{prefix}/{part}" if prefix else part, out)


def tree_flatten_with_path(tree) -> list[tuple[str, object]]:
    """[(path, leaf)] in pytree order.  The walk is a module function, not
    a closure over the list: a nested function that calls itself is a
    reference cycle, and the list of leaves in it (a model's gradients, say)
    would stay alive until the cyclic garbage collector ran."""
    out: list[tuple[str, object]] = []
    _walk(tree, "", out)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """`fn` applied leaf by leaf, in pytree order, to `tree` and the trees
    of the same structure in `rest`; dicts come back with sorted keys."""
    if isinstance(tree, dict):  # in key order, as tree_flatten_with_path walks it
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *parts) for parts in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *parts) for parts in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unflatten_like(template, leaves: list):
    """A tree shaped like `template` holding `leaves` in pytree order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
