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
                    q_offset: int = 0, mask=None, scale=None):
    """Masked-softmax attention in f32 → (B, Sq, H, dv) in q's dtype;
    ``scale`` (default q's width^-1/2) multiplies q·k."""
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qg = q.float().reshape(b, sq, n_kv, h // n_kv, d) * scale
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


def block_sparse_attention(q, k, v, cfg, *, q_offset: int = 0, scale=None):
    """Causal block-sparse attention: query block i (absolute block
    ``i + q_offset // block``) reads only the active kv blocks of its table
    row; within them, key positions ≤ the query position.  Computed densely
    over the gathered blocks in f32 → (B, Sq, H, dv) in q's dtype; ``scale``
    defaults to q's width^-1/2."""
    b, sq, h, d = q.shape
    sk, n_kv, dv = k.shape[1], k.shape[2], v.shape[3]
    scale = d ** -0.5 if scale is None else scale
    bs = cfg.block_size
    check_sparse_lengths(sq, sk, bs)
    nq, nk = sq // bs, sk // bs
    idx_np, valid_np = sparse_block_table(nq, nk, cfg, q_offset // bs)
    idx = torch.from_numpy(idx_np).long().to(q.device)
    valid = torch.from_numpy(valid_np).to(q.device)
    a = idx.shape[1]
    g = h // n_kv
    qb = (q.float() * scale).reshape(b, nq, bs, n_kv, g, d)
    kb = k.float().reshape(b, nk, bs, n_kv, d)
    vb = v.float().reshape(b, nk, bs, n_kv, dv)
    kg, vg = kb[:, idx], vb[:, idx]                        # (b, nq, A, bs, K, d)
    logits = torch.einsum("bisKgd,biatKd->biKgsat", qb, kg)
    qpos = q_offset + (torch.arange(nq, device=q.device)[:, None] * bs
                       + torch.arange(bs, device=q.device)[None])   # (nq, bs)
    kpos = idx[..., None] * bs + torch.arange(bs, device=q.device)  # (nq, A, bs)
    allowed = (kpos[:, None] <= qpos[:, :, None, None]) & valid[:, None, :, None]
    logits = logits.masked_fill(~allowed[None, :, None, None], NEG_INF)
    probs = torch.softmax(logits.reshape(*logits.shape[:-2], a * bs), -1)
    out = torch.einsum("biKgsat,biatKd->bisKgd", probs.reshape(logits.shape), vg)
    return out.reshape(b, sq, h, dv).to(q.dtype)


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
                     sparse=None, ring: bool = False, return_lse: bool = False,
                     offset: int = 0):
    """q: (B,1,H,hd); caches: (B,Sc,K,hd); ``cache_len`` = number of valid
    positions INCLUDING the token just written (positions < cache_len are
    read; with ``window``, only the last ``window`` of them; with ``sparse``,
    a ``SparseAttnConfig``, only those of the active blocks).  ``offset``:
    slot i of the cache holds position offset + i (a segment of a cache
    split over ranks; the window and the sparse mask read positions).
    ``ring``: the cache is a ring of Sc slots (a window cache), every slot
    below min(cache_len, Sc) valid and in the window by construction.
    ``return_lse`` → (out, lse (B, H) f32: logsumexp of the scaled logits
    read, -inf where none is)."""
    b, _, h, d = q.shape
    sc, n_kv = k_cache.shape[1], k_cache.shape[2]
    qg = q.float().reshape(b, n_kv, h // n_kv, d) * (d ** -0.5)
    logits = torch.einsum("bKgd,btKd->bKgt", qg, k_cache.float())
    pos = torch.arange(sc, device=q.device) + offset
    if ring:
        allowed = pos < min(cache_len, sc)
    else:
        allowed = pos < cache_len
        if window > 0:
            allowed &= pos > cache_len - 1 - window
        if sparse is not None:
            allowed &= sparse_position_mask(pos, cache_len, sparse)
    out = torch.einsum("bKgt,btKd->bKgd",
                       torch.softmax(logits.masked_fill(~allowed, NEG_INF), dim=-1),
                       v_cache.float()).reshape(b, 1, h, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(logits.masked_fill(~allowed, float("-inf")), dim=-1)
    return out, lse.reshape(b, h)


def merge_by_lse(parts):
    """Outputs over disjoint position ranges → the softmax over their union:
    ``parts`` a list of (out (B, 1, H, hd), lse (B, H) f32), each the
    attention over its range and the log-sum-exp of its scaled logits.  The
    exact merge of the ranges' partial statistics, in f32 → q's dtype."""
    m = torch.stack([lse for _, lse in parts]).amax(0)
    num = den = 0.0
    for out, lse in parts:
        w = torch.exp(lse - m)                                 # (B, H)
        num = num + out.float() * w[:, None, :, None]
        den = den + w
    return (num / den[:, None, :, None]).to(parts[0][0].dtype)


def sparse_gather_decode(q, k_cache, v_cache, pos: int, cfg):
    """The JAX package's gather-based block-sparse decode: one query token
    (B, 1, H, hd) at position ``pos`` reading only the active kv blocks of
    the pattern (sinks, the local band, strided blocks j·stride for j <
    max(1, Sc/bs // stride)) gathered from caches (B, Sc, K, hd).  Where
    Sc / bs is a multiple of the stride it reads the positions of
    ``decode_attention(sparse=cfg)``, which the model runs for it."""
    b, _, h, d = q.shape
    sc, n_kv = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    g = h // n_kv
    bs = cfg.block_size
    n_blocks = sc // bs
    n_strided = max(1, n_blocks // cfg.stride)
    qblk = pos // bs
    dev = q.device
    sink_idx = torch.arange(cfg.sink_blocks, device=dev)
    local_idx = qblk - cfg.local_blocks + 1 + torch.arange(cfg.local_blocks, device=dev)
    strided_idx = torch.arange(n_strided, device=dev) * cfg.stride
    ok = torch.cat([sink_idx <= qblk,
                    (local_idx >= 0) & (local_idx >= cfg.sink_blocks) & (local_idx <= qblk),
                    (strided_idx >= cfg.sink_blocks)
                    & (strided_idx < qblk - cfg.local_blocks + 1)])
    idx = torch.cat([sink_idx, local_idx.clamp(0, n_blocks - 1), strided_idx])
    kg = k_cache.reshape(b, n_blocks, bs, n_kv, d)[:, idx].float()
    vg = v_cache.reshape(b, n_blocks, bs, n_kv, dv)[:, idx].float()
    qg = q.reshape(b, n_kv, g, d).float() * (d ** -0.5)
    logits = torch.einsum("bKgd,bakKd->bKgak", qg, kg)
    kpos = idx[:, None] * bs + torch.arange(bs, device=dev)[None, :]
    allowed = (kpos <= pos) & ok[:, None]
    logits = logits.masked_fill(~allowed, NEG_INF)
    a = idx.shape[0]
    probs = torch.softmax(logits.reshape(b, n_kv, g, a * bs), -1).reshape(logits.shape)
    out = torch.einsum("bKgak,bakKd->bKgd", probs, vg)
    return out.reshape(b, 1, h, dv).to(q.dtype)


# --------------------------------------------------------------------------
# Sparse KV cache (the JAX package's §Perf option: the paper's sparse
# attention as a cache layout)
# --------------------------------------------------------------------------
#
# Under the static block pattern a position is attended again only if it
# lies in a sink or strided block or within the trailing local band, so the
# decode cache holds a persistent region of the sink and strided blocks and
# a ring of the last local + 1 blocks.  The realized pattern is the paper's
# with a (local + 1)-block band.


@functools.lru_cache(maxsize=64)
def sparse_kv_layout(seq_len: int, cfg):
    """(persistent blocks int32, block → persistent slot int32 (−1: none),
    ring slots, persistent slots) for a ``seq_len``-position cache."""
    bs = cfg.block_size
    nb = -(-seq_len // bs)
    pers_blocks = sorted(set(range(min(cfg.sink_blocks, nb)))
                         | set(range(0, nb, cfg.stride)))
    block2slot = np.full((nb,), -1, np.int32)
    for slot, blk in enumerate(pers_blocks):
        block2slot[blk] = slot
    return (np.asarray(pers_blocks, np.int32), block2slot,
            (cfg.local_blocks + 1) * bs, len(pers_blocks) * bs)


def sparse_kv_write(cache, k_new, v_new, pos: int, cfg, seq_len: int):
    """Write the token at ``pos`` (host int; k/v (B, 1, K, hd)) into the
    cache's {k_pers, v_pers, k_ring, v_ring} IN PLACE: its persistent slot
    when its block is persistent, and ring slot pos mod ring."""
    bs = cfg.block_size
    _, block2slot, ring_slots, _ = sparse_kv_layout(seq_len, cfg)
    ps = int(block2slot[pos // bs])
    if ps >= 0:
        cache["k_pers"][:, ps * bs + pos % bs] = k_new[:, 0]
        cache["v_pers"][:, ps * bs + pos % bs] = v_new[:, 0]
    cache["k_ring"][:, pos % ring_slots] = k_new[:, 0]
    cache["v_ring"][:, pos % ring_slots] = v_new[:, 0]
    return cache


def sparse_kv_ranges(pos: int, cfg, seq_len: int):
    """The slots the query at ``pos`` reads, as (region, end, count) host
    ints — slots [end − count, end) of region "pers" or "ring": the
    persistent blocks below the band (always a prefix of the region), then
    the band [lo, pos], lo = max(0, (pos // bs − local)·bs), whose ring
    slots form the cyclic interval from lo mod ring (one or two ranges).
    Empty ranges are left out."""
    bs = cfg.block_size
    pers_blocks, _, ring, _ = sparse_kv_layout(seq_len, cfg)
    qblk = pos // bs
    out = []
    n_pers = bs * int((pers_blocks <= qblk - cfg.local_blocks - 1).sum())
    if n_pers:
        out.append(("pers", n_pers, n_pers))
    lo = max(0, (qblk - cfg.local_blocks) * bs)
    n, start = pos - lo + 1, lo % ring
    first = min(n, ring - start)
    out.append(("ring", start + first, first))
    if n > first:
        out.append(("ring", n - first, n - first))
    return out


def sparse_kv_decode(q, cache, pos: int, cfg, seq_len: int):
    """Attention of q (B, 1, H, hd) at ``pos`` over the sparse cache, as the
    JAX package computes it: each region's logits masked to the slots it
    holds for this query, the two merged by their partial softmax
    statistics, in f32 → q's dtype."""
    bs = cfg.block_size
    pers_blocks, _, ring_slots, _ = sparse_kv_layout(seq_len, cfg)
    b, _, h, d = q.shape
    n_kv = cache["k_pers"].shape[2]
    dev = q.device
    qblk = pos // bs
    qg = q.reshape(b, n_kv, h // n_kv, d).float() * (d ** -0.5)
    slot_blk = torch.from_numpy(np.repeat(pers_blocks, bs)).to(dev)
    slot_pos = slot_blk * bs + torch.arange(bs, device=dev).repeat(len(pers_blocks))
    pers_ok = (slot_pos <= pos) & (slot_blk <= qblk - cfg.local_blocks - 1)
    r = torch.arange(ring_slots, device=dev)
    rpos = (pos // ring_slots) * ring_slots + r
    rpos = torch.where(rpos > pos, rpos - ring_slots, rpos)
    ring_ok = (rpos >= 0) & (rpos >= (qblk - cfg.local_blocks) * bs)

    def stats(kc, vc, ok):
        lg = torch.einsum("bKgd,btKd->bKgt", qg, kc.float()).masked_fill(~ok, NEG_INF)
        m = lg.amax(-1, keepdim=True)
        p = torch.exp(lg - m)
        return m[..., 0], p.sum(-1), torch.einsum("bKgt,btKd->bKgd", p, vc.float())

    m1, l1, a1 = stats(cache["k_pers"], cache["v_pers"], pers_ok)
    m2, l2, a2 = stats(cache["k_ring"], cache["v_ring"], ring_ok)
    m = torch.maximum(m1, m2)
    c1, c2 = torch.exp(m1 - m), torch.exp(m2 - m)
    out = (a1 * c1[..., None] + a2 * c2[..., None]) / \
        torch.clamp(l1 * c1 + l2 * c2, min=1e-30)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)
