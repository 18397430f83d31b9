"""Public wrapper: model-layout flash-decode (one query token against the
KV cache).  A CPU (or ``meta``: the dry run's shapes) tensor takes the
plain version (``ref.decode_ref``); a CUDA tensor launches
``csrc/decode_attn.cu`` or raises.

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
from repro_torch.kernels.flash_attn.ops import DTYPES, SQUARE, check_operands, plan
from repro_torch.models.attention import merge_by_lse, sparse_kv_decode, sparse_kv_ranges

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14
             + [ctypes.c_float, ctypes.c_void_p])


def _pattern(sparse):
    return ((sparse.block_size, sparse.sink_blocks, sparse.local_blocks,
             sparse.stride) if sparse is not None else (0, 0, 0, 0))


def decode_attention(q, k_cache, v_cache, cache_len: int, *, window: int = 0,
                     sparse=None, return_lse: bool = False, offset: int = 0):
    """q: (B, 1, H, hd); caches: (B, Sc, K, hd) → (B, 1, H, hd).  ``sparse``
    (a ``SparseAttnConfig``) masks the positions of inactive blocks.  With
    ``return_lse`` → (out, lse): lse (B, H) f32, the log-sum-exp of the
    scaled logits over the positions read (-inf when none is), so that
    outputs over disjoint position ranges merge exactly
    (``models.attention.merge_by_lse``).  ``offset``: slot i holds position
    offset + i (a segment of a sequence-split cache; a multiple of the
    sparse block), and cache_len counts positions, so the segment reads
    slots below cache_len − offset.  Any head width runs on the card, as
    ``plan(hd, hd, itemsize, widths=SQUARE)`` says: rows of whole 16-byte
    chunks at the smallest compiled lane layout that holds them (240 at
    256, 16 at 32), other rows up to 256 element by element at the same
    layouts (18 at 32), wider rows at the 256 layout with the q·k dot summed
    over 256-wide slices and v and o in 256-column planes, one cluster
    plane each (512: 2 × 2).  k and v share one width, as in the JAX
    package."""
    p = check_operands("decode_attention", q, k_cache, v_cache, widths=SQUARE)
    if q.shape[1] != 1 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: one query token and caches of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    cache_len, offset = int(cache_len), int(offset)
    if cache_len - offset < 1 or offset < 0:
        raise ValueError(f"decode_attention: cache_len {cache_len} at offset {offset} "
                         "reads no slot")
    if sparse is not None and offset % sparse.block_size:
        raise ValueError(f"decode_attention: offset {offset} is not a multiple of the "
                         f"sparse block {sparse.block_size}")
    if q.device.type in ("cpu", "meta"):
        return decode_ref(q, k_cache, v_cache, cache_len, window=window,
                          sparse=sparse, return_lse=return_lse, offset=offset)
    _build.forward_only("decode_attention", q, k_cache, v_cache)
    b, _, h, d = q.shape
    sc, kh = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, dtype=torch.float32, device=q.device) if return_lse
           else None)
    fn = _build.function("decode_attn", _ARGTYPES)
    rc = fn(DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, sc, h, kh, p.tile[0], p.path, d,
            cache_len, offset, int(window), *_pattern(sparse), d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "decode_attn")
    decode_attention.launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0


def decode_ranges(q, cache, ranges):
    """q (B, 1, H, hd) over slot ranges of a sparse-KV cache: one
    ``decode_attention`` a range (``ranges`` of ``sparse_kv_ranges``: slots
    [end − count, end) of region "pers" or "ring", read as cache_len = end,
    window = count) with its log-sum-exp, merged exactly by
    ``merge_by_lse`` (one range needs no merge).  The ranges are host ints:
    nothing is read back."""
    parts = [decode_attention(q, cache[f"k_{reg}"], cache[f"v_{reg}"], end, window=count,
                              return_lse=len(ranges) > 1) for reg, end, count in ranges]
    return parts[0] if len(parts) == 1 else merge_by_lse(parts)


def sparse_kv_attention(q, cache, pos: int, cfg, seq_len: int):
    """The query at ``pos`` against a sparse-KV cache (``models.attention``'s
    layout): on the card, ``decode_ranges`` over the persistent prefix and
    the ring's one or two ranges (up to three ``decode_attn`` launches); on
    the CPU the plain ``sparse_kv_decode``."""
    if q.device.type in ("cpu", "meta"):
        return sparse_kv_decode(q, cache, pos, cfg, seq_len)
    return decode_ranges(q, cache, sparse_kv_ranges(pos, cfg, seq_len))


def split_plan(batch: int, cache_size: int, heads: int, *, window: int = 0,
               sparse=None, head_dim: int = 64, itemsize: int = 4) -> int:
    """The cluster size (blocks per (b, h) and column plane) the kernel's
    rule takes on the current CUDA device for a call over a (batch,
    cache_size) cache with ``heads`` query heads of ``head_dim``
    (``itemsize``-byte elements); the same for every ``cache_len``."""
    fn = _build.function("decode_attn", [ctypes.c_int] * 11 + [ctypes.c_void_p],
                         symbol="decode_attn_plan")
    split = ctypes.c_int(0)
    p = plan(head_dim, head_dim, itemsize, widths=SQUARE)
    _build.check(fn(p.tile[0], p.path, p.dv_slices, batch, cache_size, heads,
                    int(window), *_pattern(sparse), ctypes.byref(split)), "decode_attn_plan")
    return split.value
