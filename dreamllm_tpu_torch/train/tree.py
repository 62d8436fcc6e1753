"""Small tree helpers for the training code.

A tree is nested dicts and lists; everything else is a leaf: a tensor,
``None`` (a frozen or absent leaf), a bool of a mask, a stored moment. A
mask may be a PREFIX of the tree it is mapped over, as in the JAX package:
one bool then covers the whole subtree below it.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def is_node(x) -> bool:
    return isinstance(x, (dict, list))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *other_leaves)`` over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any, path: tuple = ()) -> Any:
    """As :func:`tree_map`, ``fn(path, leaf, *other_leaves)`` with the path
    a tuple of dict keys and list indices."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, *(r[i] for r in rest), path=path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def tree_leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_leaves_with_path(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_path(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def broadcast_prefix(prefix: Any, tree: Any) -> Any:
    """Expand a prefix tree (a leaf of ``prefix`` may stand above a whole
    subtree of ``tree``) to ``tree``'s full structure."""
    if is_node(tree) and not is_node(prefix):
        return tree_map(lambda _: prefix, tree)
    if isinstance(tree, dict):
        return {k: broadcast_prefix(prefix[k], v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [broadcast_prefix(prefix[i], v) for i, v in enumerate(tree)]
    return prefix


def path_str(path: tuple) -> str:
    return "/".join(str(p) for p in path)
