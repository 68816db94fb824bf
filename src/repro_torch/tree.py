"""Parameter trees: nested dicts, lists and tuples of tensors.

The port's counterpart of the parts of ``jax.tree_util`` the reference uses.
Learners' ``loss_fn(params, batch)`` takes the same tree shape as the JAX
pytrees, so leaf order and leaf names must match the reference exactly:

* dicts are walked in **sorted key order** (``tree_flatten_with_path`` sorts
  dict keys; a ``state_dict`` would keep insertion order instead), lists and
  tuples in index order, named tuples (optimizer states) in field order;
* a leaf is named like ``jax.tree_util.keystr``: ``['layers'][0]['b']``, and
  a named tuple's field like ``.m``.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["Structure", "flatten_with_path", "flatten", "unflatten", "tree_map"]


class Structure:
    """The container skeleton of a tree (the counterpart of a ``treedef``).

    ``kind`` is ``"dict"``, ``"list"``, ``"tuple"``, ``"namedtuple"`` or
    ``"leaf"``; ``keys`` holds the sorted dict keys (a named tuple's class);
    ``children`` the sub-structures in walk order.
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


def _walk(node: Any, path: str, out: list[tuple[str, Any]]) -> Structure:
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return Structure(
            "dict", keys, tuple(_walk(node[k], f"{path}[{k!r}]", out) for k in keys)
        )
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return Structure(
            "namedtuple", (type(node),),
            tuple(_walk(v, f"{path}.{f}", out) for f, v in zip(node._fields, node)),
        )
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return Structure(
            kind, (), tuple(_walk(v, f"{path}[{i}]", out) for i, v in enumerate(node))
        )
    out.append((path, node))
    return Structure("leaf")


def flatten_with_path(tree: Any) -> tuple[list[tuple[str, Any]], Structure]:
    """``[(keystr_name, leaf), ...]`` in the reference's walk order, plus the
    structure that :func:`unflatten` rebuilds from."""
    # Module-level recursion: a nested function that calls itself is a
    # reference cycle, and its closure would keep every leaf (a model's
    # tensors) alive until the cyclic garbage collector runs.
    out: list[tuple[str, Any]] = []
    structure = _walk(tree, "", out)
    return out, structure


def flatten(tree: Any) -> tuple[list[Any], Structure]:
    """Leaves in walk order plus the structure."""
    named, structure = flatten_with_path(tree)
    return [leaf for _, leaf in named], structure


def _build(s: Structure, it: Any) -> Any:
    if s.kind == "leaf":
        return next(it)
    children = [_build(c, it) for c in s.children]
    if s.kind == "dict":
        return dict(zip(s.keys, children))
    if s.kind == "namedtuple":
        return s.keys[0](*children)
    return children if s.kind == "list" else tuple(children)


def unflatten(structure: Structure, leaves: list[Any]) -> Any:
    """Inverse of :func:`flatten`."""
    it = iter(leaves)
    out = _build(structure, it)
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
