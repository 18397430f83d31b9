"""Public wrapper: model-layout (B,S,H,hd) causal block-sparse attention
(the paper's sparse-attention device) at prefill.  A CPU tensor takes the
plain version (``ref.block_sparse_ref``); a CUDA tensor launches
``csrc/block_sparse_attn.cu`` or raises.

The static (idx, valid) table of ``models.attention.sparse_block_table`` is
uploaded to the device once per (q blocks, kv blocks, pattern, block
offset, device) and kept, so a prefill does not copy it once per layer.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_sparse_attn.ref import block_sparse_ref
from repro_torch.kernels.flash_attn.ops import DTYPES, check_operands
from repro_torch.models.attention import check_sparse_lengths, sparse_block_table

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])


@functools.lru_cache(maxsize=64)
def device_table(nq: int, nk: int, cfg, q_block_offset: int, device):
    """The pattern's (idx, valid) table as int32 tensors on ``device``,
    uploaded on first use (read-only: every caller shares them)."""
    idx, valid = sparse_block_table(nq, nk, cfg, q_block_offset)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(valid.astype(np.int32)).to(device))


def block_sparse_attention(q, k, v, cfg, *, q_offset: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Sk, K, hd) → (B, Sq, H, hd).  Sq and Sk
    are multiples of ``cfg.block_size``; query row i sits at key position
    ``q_offset + i`` (a multiple of the block)."""
    check_operands("block_sparse_attention", q, k, v)
    bs = cfg.block_size
    check_sparse_lengths(q.shape[1], k.shape[1], bs)
    if q_offset < 0 or q_offset % bs:
        raise ValueError(f"block_sparse_attention: q_offset {q_offset} is not "
                         f"a multiple of the block {bs}")
    if q.device.type == "cpu":
        return block_sparse_ref(q, k, v, cfg, q_offset=q_offset)
    _build.forward_only("block_sparse_attention", q, k, v)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    idx, valid = device_table(sq // bs, sk // bs, cfg, q_offset // bs, q.device)
    out = torch.empty_like(q)
    fn = _build.function("block_sparse_attn", _ARGTYPES)
    rc = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), idx.data_ptr(), valid.data_ptr(), b, sq, sk, h, kh,
            d, bs, idx.shape[1], int(q_offset), d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "block_sparse_attn")
    block_sparse_attention.launches += 1
    return out


block_sparse_attention.launches = 0
