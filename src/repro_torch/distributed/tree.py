"""Walking nested containers as the reference's pytrees walk them:
dict keys in sorted order, list and tuple indices, a NamedTuple's
fields as ``.<field>`` (``AdamWState``), ``None`` holding no leaf, every
other object a leaf.  Key paths are joined by ``/``, as the reference's
checkpoints and sharding rules name a leaf."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple


def is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def items(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a container in the reference's flattening
    order, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def _join(prefix: str, key: str) -> str:
    return f"{prefix}/{key}" if prefix else key


def walk(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) for every leaf, in flattening order."""
    if tree is None:
        return
    kids = items(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, child in kids:
        yield from walk(child, _join(prefix, k))


def map_leaves(fn: Callable[[str, Any], Any], node: Any,
               prefix: str = "") -> Any:
    """``fn(key path, leaf)`` over every leaf, in a tree of ``node``'s
    structure."""
    if node is None:
        return None
    kids = items(node)
    if kids is None:
        return fn(prefix, node)
    out = [map_leaves(fn, child, _join(prefix, k)) for k, child in kids]
    if isinstance(node, dict):
        return dict(zip(sorted(node), out))
    if is_namedtuple(node):
        return type(node)(*out)
    return type(node)(out)


def at(tree: Any, key: str) -> Any:
    """The subtree at a key path."""
    for k in key.split("/") if key else ():
        tree = dict(items(tree))[k]
    return tree
