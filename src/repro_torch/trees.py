"""Nested-dict/list tree utilities with '/'-joined path keys — the same
paths as ``repro.trees.flatten`` on a JAX pytree (list entries by index,
dict entries by key, ``None`` leaves dropped)."""
from __future__ import annotations

from typing import Callable, Dict


def _children(tree):
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in sorted(tree.items())]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """→ {'stages/0/layers/1/mixer/wq': leaf, ...}; ``None`` leaves vanish."""
    out: Dict[str, object] = {}
    kids = _children(tree)
    if kids is None:
        if tree is not None:
            out[prefix] = tree
        return out
    for k, v in kids:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def map_with_path(fn: Callable[[str, object], object], tree, prefix: str = ""):
    """Map ``fn(path, leaf)`` over the non-None leaves, keeping structure
    (``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def unflatten(flat: Dict[str, object]) -> dict:
    """Inverse of ``flatten`` into nested dicts (every level a dict; list
    levels keep their integer keys as strings — see ``bridge`` for the
    config-sized list rebuild)."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return root
