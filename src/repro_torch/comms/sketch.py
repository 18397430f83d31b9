"""Sketch codecs, the port of ``repro.comms.sketch``: top-k sparsification
and count-sketch, leaf-level encode/decode pairs.

* **top-k** — the k largest-|value| entries as (f16 value, int32 index)
  pairs; decode scatters them into zeros.  No randomness.  ``torch.topk``
  may order ties otherwise than ``jax.lax.top_k``; the ties of an upload
  are the zeros of masked-out deltas, so the decoded leaf is the same.
* **count-sketch** — the flattened leaf projected into ``rows`` rows of
  ``buckets`` signed buckets; decode reads ``sign·bucket[h(j)]`` and takes
  the median over rows (the mean of the two middle values when ``rows`` is
  even, as ``jnp.median`` does).  The hash and sign streams are fixed per
  leaf (``leaf_seed``), so the server and every client share them: the
  port computes them as counter-based hashes of each position
  (``comms.streams``) on the leaf's device, the same on the card and the
  CPU, at each encode and decode (``rows × size`` int64 + f32 while they
  live).  JAX draws its own from ``PRNGKey(0x5EED ^ leaf_seed)``;
  ``hashes=`` takes such (h, sgn) for the parity tests.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comms import streams


def topk_k(size: int, frac: float) -> int:
    return max(1, min(size, int(round(size * frac))))


def topk_encode(x: torch.Tensor, frac: float):
    """{'idx': int32 (k,), 'val': f16-rounded f32 (k,)} for the k
    largest-magnitude entries of the flattened leaf."""
    flat = x.float().reshape(-1)
    _, idx = torch.topk(flat.abs(), topk_k(flat.numel(), frac))
    return {"idx": idx.int(), "val": flat[idx].half().float()}


def topk_decode(enc, shape, dtype=torch.float32) -> torch.Tensor:
    val = enc["val"]
    out = torch.zeros(int(np.prod(shape)), dtype=torch.float32, device=val.device)
    out[enc["idx"].long()] = val
    return out.reshape(shape).to(dtype)


def cs_buckets(size: int, rows: int, ratio: float) -> int:
    """``ceil(round(size·ratio) / rows)``: the sketch is ~ratio of the leaf."""
    return max(1, -(-int(round(size * ratio)) // rows))


def cs_hashes(leaf_seed: int, size: int, rows: int, buckets: int, device):
    """The leaf's fixed (h, sgn) on ``device``: (rows, size) bucket indices
    and ±1 f32 signs, one counter-based stream per row and kind."""
    h = torch.stack([streams.hash32(streams.stream_key(0x5EED, leaf_seed, r, 0), size,
                                    device) % buckets for r in range(rows)])
    sgn = torch.stack([(streams.hash32(streams.stream_key(0x5EED, leaf_seed, r, 1), size,
                                       device) & 1).float() * 2.0 - 1.0 for r in range(rows)])
    return h, sgn


def _hashes(hashes, leaf_seed, size, rows, buckets, device):
    if hashes is None:
        return cs_hashes(leaf_seed, size, rows, buckets, device)
    h, sgn = hashes
    return (torch.as_tensor(h, device=device).long(),
            torch.as_tensor(sgn, device=device).float())


def count_sketch_encode(x: torch.Tensor, *, leaf_seed: int, rows: int, ratio: float,
                        hashes=None):
    """{'table': (rows, buckets) f32}: each row the signed bucket sums of the
    flattened leaf."""
    flat = x.float().reshape(-1)
    size = flat.numel()
    buckets = cs_buckets(size, rows, ratio)
    h, sgn = _hashes(hashes, leaf_seed, size, rows, buckets, flat.device)
    table = torch.zeros((rows, buckets), dtype=torch.float32, device=flat.device)
    for r in range(rows):
        table[r].index_add_(0, h[r], sgn[r] * flat)
    return {"table": table}


def count_sketch_decode(enc, shape, *, leaf_seed: int, dtype=torch.float32, hashes=None):
    table = enc["table"]
    rows, buckets = table.shape
    size = int(np.prod(shape))
    h, sgn = _hashes(hashes, leaf_seed, size, rows, buckets, table.device)
    est = torch.stack([sgn[r] * table[r][h[r]] for r in range(rows)]).sort(0).values
    med = (est[(rows - 1) // 2] + est[rows // 2]) * 0.5
    return med.reshape(shape).to(dtype)
