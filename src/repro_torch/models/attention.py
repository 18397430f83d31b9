"""Attention cores — the plain PyTorch versions (oracles and CPU path).

GQA-aware like the JAX package: q (B, S, H, hd), k/v (B, Sk, K, hd),
H = K·G, query head h reads kv head h // G.  The model's hot path runs the
hand-written kernels in ``repro_torch.kernels.{flash_attn,decode_attn,
block_sparse_attn}``, whose plain versions are these functions.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

NEG_INF = -1e30


def make_mask(sq: int, sk: int, *, causal: bool, window: int = 0,
              q_offset: int = 0, device=None):
    """(sq, sk) boolean 'allowed' mask."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    allowed = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        allowed &= kpos <= qpos
    if window > 0:
        allowed &= kpos > qpos - window
    return allowed


def dense_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, mask=None):
    """Masked-softmax attention in f32 → (B, Sq, H, hd) in q's dtype."""
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    qg = q.float().reshape(b, sq, n_kv, h // n_kv, d) * (d ** -0.5)
    logits = torch.einsum("bsKgd,btKd->bKgst", qg, k.float())
    if mask is None:
        mask = make_mask(sq, k.shape[1], causal=causal, window=window,
                         q_offset=q_offset, device=q.device)
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bKgst,btKd->bsKgd", probs, v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


# --------------------------------------------------------------------------
# Block-sparse (the paper's sparse-attention device)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def sparse_block_table(n_q_blocks: int, n_kv_blocks: int, cfg,
                       q_block_offset: int = 0):
    """Static (numpy) table of active kv-block indices per q block.

    Active set for absolute q block ``qi``: sink blocks [0, sink), local band
    (qi-local, qi], and strided global blocks {j : j % stride == 0, j ≤ qi},
    sorted and cut to ``a_max`` slots.  Returns (idx int32, valid bool),
    both (n_q_blocks, a_max); invalid slots hold block 0."""
    a_max = cfg.sink_blocks + cfg.local_blocks + int(np.ceil(n_kv_blocks / cfg.stride))
    idx = np.zeros((n_q_blocks, a_max), dtype=np.int32)
    valid = np.zeros((n_q_blocks, a_max), dtype=bool)
    for i in range(n_q_blocks):
        qi = i + q_block_offset
        active = set(range(min(cfg.sink_blocks, n_kv_blocks)))
        lo = max(0, qi - cfg.local_blocks + 1)
        active |= set(range(lo, min(qi + 1, n_kv_blocks)))
        active |= set(range(0, min(qi + 1, n_kv_blocks), cfg.stride))
        active = sorted(active)[:a_max]
        idx[i, : len(active)] = active
        valid[i, : len(active)] = True
    return idx, valid


def check_sparse_lengths(sq: int, sk: int, block: int) -> None:
    if sq % block or sk % block:
        raise ValueError(f"block-sparse attention needs lengths that are "
                         f"multiples of the block {block}; got Sq {sq}, Sk {sk}")


def block_sparse_attention(q, k, v, cfg, *, q_offset: int = 0):
    """Causal block-sparse attention: query block i (absolute block
    ``i + q_offset // block``) reads only the active kv blocks of its table
    row; within them, key positions ≤ the query position.  Computed densely
    over the gathered blocks in f32 → (B, Sq, H, hd) in q's dtype."""
    b, sq, h, d = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    bs = cfg.block_size
    check_sparse_lengths(sq, sk, bs)
    nq, nk = sq // bs, sk // bs
    idx_np, valid_np = sparse_block_table(nq, nk, cfg, q_offset // bs)
    idx = torch.from_numpy(idx_np).long().to(q.device)
    valid = torch.from_numpy(valid_np).to(q.device)
    a = idx.shape[1]
    g = h // n_kv
    qb = (q.float() * d ** -0.5).reshape(b, nq, bs, n_kv, g, d)
    kb = k.float().reshape(b, nk, bs, n_kv, d)
    vb = v.float().reshape(b, nk, bs, n_kv, d)
    kg, vg = kb[:, idx], vb[:, idx]                        # (b, nq, A, bs, K, d)
    logits = torch.einsum("bisKgd,biatKd->biKgsat", qb, kg)
    qpos = q_offset + (torch.arange(nq, device=q.device)[:, None] * bs
                       + torch.arange(bs, device=q.device)[None])   # (nq, bs)
    kpos = idx[..., None] * bs + torch.arange(bs, device=q.device)  # (nq, A, bs)
    allowed = (kpos[:, None] <= qpos[:, :, None, None]) & valid[:, None, :, None]
    logits = logits.masked_fill(~allowed[None, :, None, None], NEG_INF)
    probs = torch.softmax(logits.reshape(*logits.shape[:-2], a * bs), -1)
    out = torch.einsum("biKgsat,biatKd->bisKgd", probs.reshape(logits.shape), vg)
    return out.reshape(b, sq, h, d).to(q.dtype)


def sparse_position_mask(pos, cache_len: int, cfg):
    """The static block pattern as a mask over cache positions ``pos`` for
    the query at position cache_len - 1: sink, local band and strided
    blocks."""
    bs = cfg.block_size
    blk = pos // bs
    qblk = (cache_len - 1) // bs
    return ((blk < cfg.sink_blocks) | (blk > qblk - cfg.local_blocks)
            | (blk % cfg.stride == 0))


def decode_attention(q, k_cache, v_cache, cache_len: int, *, window: int = 0,
                     sparse=None, ring: bool = False):
    """q: (B,1,H,hd); caches: (B,Sc,K,hd); ``cache_len`` = number of valid
    positions INCLUDING the token just written (positions < cache_len are
    read; with ``window``, only the last ``window`` of them; with ``sparse``,
    a ``SparseAttnConfig``, only those of the active blocks).  ``ring``:
    the cache is a ring of Sc slots (a window cache), every slot below
    min(cache_len, Sc) valid and in the window by construction."""
    b, _, h, d = q.shape
    sc, n_kv = k_cache.shape[1], k_cache.shape[2]
    qg = q.float().reshape(b, n_kv, h // n_kv, d) * (d ** -0.5)
    logits = torch.einsum("bKgd,btKd->bKgt", qg, k_cache.float())
    pos = torch.arange(sc, device=q.device)
    if ring:
        allowed = pos < min(cache_len, sc)
    else:
        allowed = pos < cache_len
        if window > 0:
            allowed &= pos > cache_len - 1 - window
        if sparse is not None:
            allowed &= sparse_position_mask(pos, cache_len, sparse)
    logits = logits.masked_fill(~allowed, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bKgt,btKd->bKgd", probs, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)
