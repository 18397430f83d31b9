"""Flat-key ``.npz`` checkpointing of trees of tensors, the port of
``repro.checkpoint.ckpt``.

Leaves are stored under their '/'-joined tree paths (``trees.flatten``, the
JAX package's paths), so a file either package writes loads in the other
under the same keys.  Restoring takes a template tree of the same
structure; each leaf's shape is checked, and it lands on the template
leaf's device and dtype.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch import trees


def save_checkpoint(path: str, tree) -> None:
    """Atomic write: serialize to a sibling tmp file, ``fsync``, then
    ``os.replace``.  A crash mid-write leaves the previous checkpoint
    intact (readers never observe a torn .npz).  bf16 leaves are stored
    as f32 (npz has no bf16)."""
    arrays = {}
    for k, v in trees.flatten(tree).items():
        t = v.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arrays[k] = t.cpu().numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load_checkpoint(path: str, template):
    """Restore into the structure of ``template``: each leaf onto its
    template leaf's device and dtype.  A missing leaf or a shape mismatch
    raises."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        def get(p, v):
            if p not in data:
                raise KeyError(f"checkpoint missing leaf {p}")
            arr = data[p]
            if tuple(arr.shape) != tuple(v.shape):
                raise ValueError(f"shape mismatch at {p}: {arr.shape} vs {tuple(v.shape)}")
            return torch.from_numpy(arr).to(device=v.device, dtype=v.dtype)

        return trees.map_with_path(get, template)


def save_json(path: str, obj) -> None:
    """The JSON sidecar of a checkpoint, written atomically like the npz."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
