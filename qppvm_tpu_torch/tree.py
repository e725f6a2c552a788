"""Trees of dicts, tuples, lists and dataclasses over tensors: the port's
counterpart of ``jax.tree``.

A session's state, a rollout's carry and a plan's samples are such trees.
A leaf is addressed by its path in the tree; ``None`` is structure, not a
leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Tuple


def leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of every non-None leaf, depth first."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif tree is not None:
        yield path, tree


def rebuild(tree: Any, values: Dict[str, Any], path: str = "") -> Any:
    """``tree`` with each leaf replaced by ``values[its path]``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, values, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(rebuild(v, values, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: rebuild(getattr(tree, f.name), values,
                            f"{path}.{f.name}")
            for f in dataclasses.fields(tree)})
    return None if tree is None else values[path]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``tree`` with each leaf x replaced by fn(x, *the leaves at its path
    in ``rest``); the trees in ``rest`` have ``tree``'s structure."""
    others = [dict(leaves(t)) for t in rest]
    return rebuild(tree, {p: fn(v, *(o[p] for o in others))
                          for p, v in leaves(tree)})
