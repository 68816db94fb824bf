"""Parameter trees: nested dicts, lists and tuples of tensors.

The port's counterpart of the parts of ``jax.tree_util`` the reference uses.
Learners' ``loss_fn(params, batch)`` takes the same tree shape as the JAX
pytrees, so leaf order and leaf names must match the reference exactly:

* dicts are walked in **sorted key order** (``tree_flatten_with_path`` sorts
  dict keys; a ``state_dict`` would keep insertion order instead), lists and
  tuples in index order;
* a leaf is named like ``jax.tree_util.keystr``: ``['layers'][0]['b']``.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["Structure", "flatten_with_path", "flatten", "unflatten", "tree_map"]


class Structure:
    """The container skeleton of a tree (the counterpart of a ``treedef``).

    ``kind`` is ``"dict"``, ``"list"``, ``"tuple"`` or ``"leaf"``; ``keys``
    holds the sorted dict keys; ``children`` the sub-structures in walk order.
    """

    __slots__ = ("kind", "keys", "children")

    def __init__(self, kind: str, keys: tuple = (), children: tuple = ()):
        self.kind = kind
        self.keys = keys
        self.children = children

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Structure)
            and self.kind == other.kind
            and self.keys == other.keys
            and self.children == other.children
        )

    def __hash__(self) -> int:
        return hash((self.kind, self.keys, self.children))

    def __repr__(self) -> str:
        return f"Structure({self.kind!r}, keys={self.keys!r}, children={len(self.children)})"


def flatten_with_path(tree: Any) -> tuple[list[tuple[str, Any]], Structure]:
    """``[(keystr_name, leaf), ...]`` in the reference's walk order, plus the
    structure that :func:`unflatten` rebuilds from."""
    out: list[tuple[str, Any]] = []

    def walk(node: Any, path: str) -> Structure:
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return Structure(
                "dict", keys, tuple(walk(node[k], f"{path}[{k!r}]") for k in keys)
            )
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return Structure(
                kind, (), tuple(walk(v, f"{path}[{i}]") for i, v in enumerate(node))
            )
        out.append((path, node))
        return Structure("leaf")

    structure = walk(tree, "")
    return out, structure


def flatten(tree: Any) -> tuple[list[Any], Structure]:
    """Leaves in walk order plus the structure."""
    named, structure = flatten_with_path(tree)
    return [leaf for _, leaf in named], structure


def unflatten(structure: Structure, leaves: list[Any]) -> Any:
    """Inverse of :func:`flatten`."""
    it = iter(leaves)

    def build(s: Structure) -> Any:
        if s.kind == "leaf":
            return next(it)
        children = [build(c) for c in s.children]
        if s.kind == "dict":
            return dict(zip(s.keys, children))
        return children if s.kind == "list" else tuple(children)

    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over one or more trees of the same structure."""
    leaves, structure = flatten(tree)
    others = []
    for t in rest:
        ls, s = flatten(t)
        if s != structure:
            raise ValueError("tree_map over trees of different structure")
        others.append(ls)
    return unflatten(structure, [fn(*xs) for xs in zip(leaves, *others)])
