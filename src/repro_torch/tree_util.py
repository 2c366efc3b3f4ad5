"""The part of ``jax.tree_util`` the port needs, over nested dicts, lists
and tuples.

Leaf order is ``jax.tree_util``'s: dict keys sorted, sequences in
order. That order is a file format, not a detail: a checkpoint's
``arr_<i>.npy`` files are numbered in it (``ckpt/checkpoint.py``), so
a directory the reference wrote restores here leaf for leaf, and the
spectral monitor publishes its tensors in the reference's order. (A
walk that keeps dict insertion order, as ``torch.utils._pytree`` does,
would number the Boussinesq state ``{"u0", "u1", "u2", "b"}`` in
another order than the reference's ``b, u0, u1, u2``.) ``None`` is an
empty subtree, as in JAX; every other object that is not a dict, list
or tuple is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_leaves_with_path(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf, with ``jax.tree_util.keystr`` paths
    (``['a'][0]``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in tree_leaves_with_path(tree[k],
                                                  f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree)
                for leaf in tree_leaves_with_path(v, f"{path}[{i}]")]
    return [(path, tree)]


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def treedef_str(tree: Any) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(tree))``
    prints it: ``PyTreeDef({'a': (*, *), 'b': *})``."""
    def walk(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple):
            inner = ", ".join(walk(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def tree_unflatten(tree: Any, leaves) -> Any:
    """A tree of ``tree``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(tree)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(f: Callable, tree: Any, *rest: Any) -> Any:
    """``f`` applied leafwise over ``tree`` and trees of its structure
    (``rest``'s leaves at ``tree``'s leaf positions may be anything,
    ``None`` included)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(f, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return f(tree, *rest)
