"""Counter-based random streams for the codecs: each value is a pure
function of a stream key and its position, computed with int64 tensor ops
on whatever device the caller names, so the card and the CPU draw the same
values and nothing is carried from call to call.

The key is folded from a tuple of integers on the host
(``numpy.random.SeedSequence``); each position's 32-bit hash is murmur3's
finalizer applied twice around the key.  Products are taken 16 bits at a
time, so no int64 product overflows.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def stream_key(*words: int) -> int:
    """A 32-bit stream key from a tuple of non-negative integers."""
    return int(np.random.SeedSequence(list(words)).generate_state(1)[0])


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for 0 ≤ x < 2³², without an int64 overflow."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash32(key: int, n: int, device=None) -> torch.Tensor:
    """(n,) int64 values in [0, 2³²): the stream ``key``'s hashes of the
    positions 0 … n-1."""
    pos = torch.arange(n, dtype=torch.int64, device=device)
    return _fmix32(_fmix32(pos ^ (key & _M32)) ^ ((key * 0x9E3779B9) & _M32))


def uniforms(key: int, shape, device=None) -> torch.Tensor:
    """f32 uniforms on [0, 1) of ``shape``: each position's top 24 hash bits
    over 2²⁴ (exact in f32)."""
    n = int(np.prod(shape))
    return ((hash32(key, n, device) >> 8).float() * 2.0 ** -24).reshape(tuple(shape))
