"""Public wrapper: model-layout flash-decode (one query token against the
KV cache).  A CPU tensor takes the plain version (``ref.decode_ref``); a
CUDA tensor launches ``csrc/decode_attn.cu`` or raises.

Convention: ``cache_len`` is the number of valid cache positions including
the token just written (positions ``< cache_len`` are read), the model
layer's contract.  The TPU kernel took ``pos = cache_len - 1``.  It is a
host ``int``, so the decode loop never reads a device scalar back.  The
kernel splits the positions it reads over a thread block cluster of 1-16
blocks, by a rule in the C code on the shapes and the SM count and never on
``cache_len`` (``split_plan`` reports it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn.ref import decode_ref
from repro_torch.kernels.flash_attn.ops import DTYPES, check_operands

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
             + [ctypes.c_float, ctypes.c_void_p])


def _pattern(sparse):
    return ((sparse.block_size, sparse.sink_blocks, sparse.local_blocks,
             sparse.stride) if sparse is not None else (0, 0, 0, 0))


def decode_attention(q, k_cache, v_cache, cache_len: int, *, window: int = 0,
                     sparse=None):
    """q: (B, 1, H, hd); caches: (B, Sc, K, hd) → (B, 1, H, hd).  ``sparse``
    (a ``SparseAttnConfig``) masks the positions of inactive blocks."""
    check_operands("decode_attention", q, k_cache, v_cache)
    if q.shape[1] != 1:
        raise ValueError(f"decode_attention: one query token, got {tuple(q.shape)}")
    cache_len = int(cache_len)
    if cache_len < 1:
        raise ValueError(f"decode_attention: cache_len {cache_len} < 1")
    if q.device.type == "cpu":
        return decode_ref(q, k_cache, v_cache, cache_len, window=window,
                          sparse=sparse)
    _build.forward_only("decode_attention", q, k_cache, v_cache)
    b, _, h, d = q.shape
    sc, kh = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    fn = _build.function("decode_attn", _ARGTYPES)
    rc = fn(DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), out.data_ptr(), b, sc, h, kh, d, cache_len,
            int(window), *_pattern(sparse), d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "decode_attn")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def split_plan(batch: int, cache_size: int, heads: int, *, window: int = 0,
               sparse=None) -> int:
    """The cluster size (blocks per (b, h)) the kernel's rule takes on the
    current CUDA device for a call over a (batch, cache_size) cache with
    ``heads`` query heads; the same for every ``cache_len``."""
    fn = _build.function("decode_attn", [ctypes.c_int] * 8 + [ctypes.c_void_p],
                         symbol="decode_attn_plan")
    split = ctypes.c_int(0)
    _build.check(fn(batch, cache_size, heads, int(window), *_pattern(sparse),
                    ctypes.byref(split)), "decode_attn_plan")
    return split.value
