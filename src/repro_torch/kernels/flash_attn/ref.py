"""Plain PyTorch versions of the flash attention kernel: ``attention_ref``,
the function itself, and ``cover_ref``, the attention kernels' split and
sliced arithmetic (used by tests only)."""
import torch

from repro_torch.models.attention import NEG_INF, dense_attention


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """q: (B, Sq, H, dk); k: (B, Sk, K, dk); v: (B, Sk, K, dv) → (B, Sq, H,
    dv); query position i sits at key position i (no offset), as in the
    kernel; ``scale`` defaults to dk^-1/2."""
    return dense_attention(q, k, v, causal=causal, window=window, scale=scale)


def cover_ref(q, k, v, plan, allowed, scale: float, decode: bool = False):
    """Attention computed as the kernels cover a call of ``plan`` (an
    ``ops.AttnPlan``): the scaled q·k dot as partial dots over consecutive
    ranges of dims, each in f32, added in range order from zero; keys
    outside ``allowed`` (a bool mask broadcast to (Sq, Sk)) at NEG_INF; the
    softmax once; each range of v's columns weighted by that same P, side by
    side.  The prefill kernels' ranges are the ranks of ``plan.cluster``
    (each rank's q/k dims and v/o columns; one range without a cluster),
    the decode kernel's (``decode``) the SLICE-wide slices and column
    planes.  q (B, Sq, H, dk), k (B, Sk, K, dk), v (B, Sk, K, dv) → (B, Sq,
    H, dv)."""
    b, sq, h, dk = q.shape
    kh, dv = k.shape[2], v.shape[3]
    qg = q.float().reshape(b, sq, kh, h // kh, dk) * scale
    if decode:
        w = plan.tile[0]
        dims, cols = [(a, min(dk, a + w)) for a in range(0, dk, w)], plan.planes(dv)
    elif plan.cluster is not None:
        dims, cols = plan.cluster.dims(dk), plan.cluster.cols(dv)
    else:
        dims, cols = [(0, dk)], [(0, dv)]
    logits = torch.zeros(b, kh, h // kh, sq, k.shape[1], device=q.device)
    for a, e in dims:
        logits = logits + torch.einsum("bsKgd,btKd->bKgst", qg[..., a:e], k[..., a:e].float())
    probs = torch.softmax(logits.masked_fill(~allowed, NEG_INF), dim=-1)
    out = torch.cat([torch.einsum("bKgst,btKd->bsKgd", probs, v[..., a:e].float())
                     for a, e in cols], dim=-1)
    return out.reshape(b, sq, h, dv).to(q.dtype)
