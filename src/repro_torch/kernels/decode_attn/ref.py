"""Plain PyTorch versions of the flash-decode kernel: ``decode_ref``, the
function itself, and ``decode_split_ref``, the kernel's split-and-merge
arithmetic (used by tests only)."""
import torch

from repro_torch.models.attention import NEG_INF, decode_attention, sparse_position_mask


def decode_ref(q, k_cache, v_cache, cache_len: int, *, window: int = 0,
               sparse=None, return_lse: bool = False, offset: int = 0):
    """q: (B,1,H,hd); caches (B,Sc,K,hd), slot i holding position offset + i;
    positions < cache_len are valid (and, with ``sparse``, in an active
    block).  ``return_lse`` → (out, lse), lse (B, H) f32 the log-sum-exp of
    the scaled logits read."""
    return decode_attention(q, k_cache, v_cache, cache_len, window=window,
                            sparse=sparse, return_lse=return_lse, offset=offset)


def decode_split_ref(q, k_cache, v_cache, cache_len: int, split: int, *,
                     window: int = 0, sparse=None):
    """``decode_ref`` computed as ``csrc/decode_attn.cu`` splits it: the
    active positions (in order) cut into ``split`` even, contiguous shares,
    share r = [n·r/split, n·(r+1)/split); each share's running max m, sum l
    and unnormalised acc in f32 (an empty share: m = NEG_INF, l = 0,
    acc = 0), merged in rank order."""
    b, _, h, d = q.shape
    sc, kh = k_cache.shape[1], k_cache.shape[2]
    hi = min(cache_len, sc)
    lo = max(0, cache_len - window) if window > 0 else 0
    pos = torch.arange(lo, max(lo, hi), device=q.device)
    if sparse is not None:
        pos = pos[sparse_position_mask(pos, cache_len, sparse)]
    n = len(pos)
    qg = q.float().reshape(b, kh, h // kh, d) * (d ** -0.5)
    states = []
    for r in range(split):
        share = pos[n * r // split:n * (r + 1) // split]
        if len(share) == 0:
            states.append((torch.full_like(qg[..., 0], NEG_INF), torch.zeros_like(qg[..., 0]),
                           torch.zeros_like(qg)))
            continue
        s = torch.einsum("bKgd,btKd->bKgt", qg, k_cache[:, share].float())
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        states.append((m, p.sum(-1), torch.einsum("bKgt,btKd->bKgd", p,
                                                  v_cache[:, share].float())))
    mt = torch.stack([m for m, _, _ in states]).amax(0)
    l, acc = torch.zeros_like(mt), torch.zeros_like(qg)
    for m, lr, ar in states:
        c = torch.exp(m - mt)
        l = l + lr * c
        acc = acc + ar * c[..., None]
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)
