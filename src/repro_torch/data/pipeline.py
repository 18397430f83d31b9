"""Minimal batching pipeline over in-memory synthetic corpora.

The port's copy of ``repro.data.pipeline`` (numpy only); its test holds it against
the original draw for draw.
"""
from __future__ import annotations

import numpy as np


def batch_iterator(arrays: dict, batch_size: int, *, seed: int = 0,
                   drop_last: bool = True):
    """Infinite shuffled batch iterator over a dict of equal-length arrays.
    Scalar entries are passed through."""
    n = len(next(v for v in arrays.values()
                 if isinstance(v, np.ndarray) and v.ndim >= 1))
    rng = np.random.RandomState(seed)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - (batch_size - 1 if drop_last else 0), batch_size):
            sel = order[i:i + batch_size]
            yield {k: (v[sel] if isinstance(v, np.ndarray) and v.ndim >= 1
                       and len(v) == n else v)
                   for k, v in arrays.items()}
