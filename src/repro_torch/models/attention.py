"""Attention cores — the plain PyTorch versions (oracles and CPU path).

GQA-aware like the JAX package: q (B, S, H, hd), k/v (B, Sk, K, hd),
H = K·G, query head h reads kv head h // G.  The model's hot path runs the
hand-written kernels in ``repro_torch.kernels.{flash_attn,decode_attn}``,
whose plain versions are these functions.
"""
from __future__ import annotations

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


def decode_attention(q, k_cache, v_cache, cache_len: int, *, window: int = 0,
                     sparse=None, ring: bool = False):
    """q: (B,1,H,hd); caches: (B,Sc,K,hd); ``cache_len`` = number of valid
    positions INCLUDING the token just written (positions < cache_len are
    read; with ``window``, only the last ``window`` of them)."""
    if sparse is not None:
        raise NotImplementedError("sparse decode masks are ported with the "
                                  "PFIT sparse-attention slice")
    if ring:
        raise NotImplementedError("ring (window) caches are ported with the "
                                  "arch-zoo slice")
    b, _, h, d = q.shape
    sc, n_kv = k_cache.shape[1], k_cache.shape[2]
    qg = q.float().reshape(b, n_kv, h // n_kv, d) * (d ** -0.5)
    logits = torch.einsum("bKgd,btKd->bKgt", qg, k_cache.float())
    pos = torch.arange(sc, device=q.device)
    allowed = pos < cache_len
    if window > 0:
        allowed &= pos > cache_len - 1 - window
    logits = logits.masked_fill(~allowed, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bKgt,btKd->bKgd", probs, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)
