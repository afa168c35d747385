"""Nested-container trees of tensors, flattened in JAX's order.

The training path keeps parameters, optimizer state and BatchNorm
statistics as plain nested dicts (and lists) with the JAX package's
names and layouts, so a tree here flattens to the same leaf order as
``jax.tree_util.tree_flatten`` of the reference's tree: dict keys
sorted, lists and tuples in order, ``None`` an empty subtree.  That
order is what the bucket plan packs in, and what its ``layout()``
records for checkpoints.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

Tree = Any


class TreeDef:
    """The structure of a tree with its leaves taken out."""

    __slots__ = ("kind", "keys", "children")

    def __init__(self, kind: str, keys=None, children=()):
        self.kind = kind            # "leaf", "none", "dict", "list", "tuple"
        self.keys = keys
        self.children = tuple(children)

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def _sig(self):
        return (self.kind, self.keys, tuple(c._sig() for c in self.children))

    def __eq__(self, other) -> bool:
        return isinstance(other, TreeDef) and self._sig() == other._sig()

    def __hash__(self) -> int:
        return hash(self._sig())

    def __repr__(self) -> str:
        return f"TreeDef({self._sig()!r})"


def tree_flatten(tree: Tree) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []

    def walk(t) -> TreeDef:
        if t is None:
            return TreeDef("none")
        if isinstance(t, dict):
            keys = tuple(sorted(t))
            return TreeDef("dict", keys, [walk(t[k]) for k in keys])
        if isinstance(t, (list, tuple)):
            kind = "list" if isinstance(t, list) else "tuple"
            return TreeDef(kind, None, [walk(c) for c in t])
        leaves.append(t)
        return TreeDef("leaf")

    treedef = walk(tree)
    return leaves, treedef


def tree_leaves(tree: Tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_structure(tree: Tree) -> TreeDef:
    return tree_flatten(tree)[1]


def tree_unflatten(treedef: TreeDef, leaves) -> Tree:
    it = iter(leaves)

    def build(d: TreeDef):
        if d.kind == "leaf":
            return next(it)
        if d.kind == "none":
            return None
        if d.kind == "dict":
            return {k: build(c) for k, c in zip(d.keys, d.children)}
        out = [build(c) for c in d.children]
        return out if d.kind == "list" else tuple(out)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        rl, rd = tree_flatten(r)
        if rd != treedef:
            raise ValueError("tree_map: trees differ in structure")
        others.append(rl)
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others)])


def leaf_paths(treedef: TreeDef) -> List[str]:
    """``jax.tree_util.keystr`` spelling of each leaf's path, in leaf
    order: ``['Bottleneck_0']['Conv_0']['kernel']``, ``[0]`` for a list
    entry."""
    out: List[str] = []

    def walk(d: TreeDef, prefix: str) -> None:
        if d.kind == "leaf":
            out.append(prefix)
        elif d.kind == "dict":
            for k, c in zip(d.keys, d.children):
                walk(c, f"{prefix}[{k!r}]")
        elif d.kind in ("list", "tuple"):
            for i, c in enumerate(d.children):
                walk(c, f"{prefix}[{i}]")

    walk(treedef, "")
    return out
