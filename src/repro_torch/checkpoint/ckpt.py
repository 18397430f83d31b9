"""Flat-key ``.npz`` checkpointing of trees of tensors, the port of
``repro.checkpoint.ckpt``.

Leaves are stored under their '/'-joined tree paths (``trees.flatten``, the
JAX package's paths), so a file either package writes loads in the other
under the same keys.  Restoring takes a template tree of the same
structure; each leaf's shape is checked, and it lands on the template
leaf's device and dtype.

A checkpoint may carry a JSON-able ``meta`` (a runner's host state) inside
the same npz, under the reserved key ``META_KEY``: one atomic file holds
the state and the host state that belongs to it, so a kill can never leave
the two a round apart (the JAX package writes its JSON sidecar after the
npz, and a kill between the two leaves the npz one round ahead).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch import trees

META_KEY = "__meta__"   # the npz entry that holds the checkpoint's meta JSON


def save_checkpoint(path: str, tree, meta=None) -> None:
    """Atomic write: serialize to a sibling tmp file, ``fsync``, then
    ``os.replace``.  A crash mid-write leaves the previous checkpoint
    intact (readers never observe a torn .npz).  bf16 leaves are stored
    as f32 (npz has no bf16).  ``meta`` (JSON-able) is stored as UTF-8
    bytes under ``META_KEY``."""
    arrays = {}
    for k, v in trees.flatten(tree).items():
        t = v.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arrays[k] = t.cpu().numpy()
    if meta is not None:
        arrays[META_KEY] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
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


def load_meta(path: str):
    """The ``meta`` a checkpoint was saved with (KeyError when it has
    none)."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        if META_KEY not in data:
            raise KeyError(f"checkpoint {path} holds no {META_KEY}")
        return json.loads(data[META_KEY].tobytes().decode())


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
