"""Nested-dict/list tree utilities with '/'-joined path keys — the same
paths as ``repro.trees.flatten`` on a JAX pytree (list entries by index,
dict entries by key, ``None`` leaves dropped) — and the helpers the cohort
engine builds on: ``select``/``merge`` of subtrees by path, ``stack``/
``unstack`` along a leading client axis, ``tree_add``, ``tree_scale``,
``tree_l2``, ``mask_like``, and the counts ``count_params``/``byte_size``
(over tensors or numpy arrays)."""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch


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


def select(tree, pred: Callable[[str], bool]):
    """Keep leaves whose path satisfies ``pred``; others become ``None``
    (structure kept, so the result merges back with ``merge``)."""
    return map_with_path(lambda p, v: v if pred(p) else None, tree)


def merge(base, overlay):
    """``overlay``'s leaf where it is not ``None``, else ``base``'s; the two
    trees share one structure."""
    if overlay is None:
        return base
    if isinstance(base, dict):
        return {k: merge(v, overlay.get(k)) for k, v in base.items()}
    if isinstance(base, (list, tuple)):
        return type(base)(merge(b, o) for b, o in zip(base, overlay))
    return overlay


def map_leaves(fn: Callable, *trees_):
    """Map ``fn`` over the leaves of same-structure trees (``None`` in the
    first tree stays ``None``)."""
    first = trees_[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: map_leaves(fn, *(t[k] for t in trees_)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(map_leaves(fn, *xs) for xs in zip(*trees_))
    return fn(*trees_)


def mask_like(tree, pred: Callable[[str], bool]):
    """1.0/0.0 float mask tree by path predicate."""
    return map_with_path(lambda p, v: float(pred(p)), tree)


def stack(client_trees: Sequence):
    """n same-structure trees of leaf shape S → one tree of leaf shape
    (n, *S): the cohort's stacked client axis."""
    return map_leaves(lambda *ls: torch.stack(ls), *client_trees)


def unstack(stacked, n: Optional[int] = None) -> List:
    """Inverse of ``stack``: the per-client trees, as views of the stacked
    leaves."""
    if n is None:
        n = next(iter(flatten(stacked).values())).shape[0]
    return [map_leaves(lambda leaf, i=i: leaf[i], stacked) for i in range(n)]


def count_params(tree) -> int:
    """Elements over the leaves that have a shape."""
    return sum(math.prod(x.shape) for x in flatten(tree).values() if hasattr(x, "shape"))


def byte_size(tree) -> int:
    """Bytes over the leaves (tensors: ``element_size``, numpy: ``itemsize``)."""
    def nbytes(x):
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        return x.size * x.dtype.itemsize if hasattr(x, "size") else 0
    return sum(nbytes(x) for x in flatten(tree).values())


def tree_add(a, b, scale_b: float = 1.0):
    return map_leaves(lambda x, y: x + scale_b * y, a, b)


def tree_scale(a, s: float):
    return map_leaves(lambda x: x * s, a)


def tree_zeros_like(a):
    return map_leaves(torch.zeros_like, a)


def tree_l2(a, b):
    """Global squared L2 distance between two same-structure trees, each
    leaf's sum in f32 (``None`` leaves, as after ``select``, add nothing)."""
    fa, fb = flatten(a), flatten(b)
    if fa.keys() != fb.keys():
        raise ValueError("tree_l2: the trees have different leaves")
    return torch.stack([(fa[p].float() - fb[p].float()).square().sum()
                        for p in fa]).sum()
