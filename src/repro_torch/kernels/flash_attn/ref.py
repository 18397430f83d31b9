"""Plain PyTorch versions of the flash attention kernel: ``attention_ref``,
the function itself, and ``cover_ref``, the attention kernels' sliced
arithmetic (used by tests only)."""
import torch

from repro_torch.models.attention import NEG_INF, dense_attention


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """q: (B, Sq, H, dk); k: (B, Sk, K, dk); v: (B, Sk, K, dv) → (B, Sq, H,
    dv); query position i sits at key position i (no offset), as in the
    kernel; ``scale`` defaults to dk^-1/2."""
    return dense_attention(q, k, v, causal=causal, window=window, scale=scale)


def cover_ref(q, k, v, plan, allowed, scale: float):
    """Attention computed as the kernels cover a call of ``plan`` (an
    ``ops.AttnPlan``): the scaled q·k dot summed in f32 over the plan's
    ``dk_slices`` slices of DK dims in slice order, keys outside
    ``allowed`` (a bool mask broadcast to (Sq, Sk)) at NEG_INF, the softmax,
    and each of the plan's column planes of v weighted by that same P; the
    planes side by side.  q (B, Sq, H, dk), k (B, Sk, K, dk), v (B, Sk, K,
    dv) → (B, Sq, H, dv)."""
    b, sq, h, dk = q.shape
    kh, dv = k.shape[2], v.shape[3]
    qg = q.float().reshape(b, sq, kh, h // kh, dk) * scale
    w = plan.tile[0]
    logits = sum(torch.einsum("bsKgd,btKd->bKgst", qg[..., a:a + w], k[..., a:a + w].float())
                 for a in range(0, w * plan.dk_slices, w))
    probs = torch.softmax(logits.masked_fill(~allowed, NEG_INF), dim=-1)
    out = torch.cat([torch.einsum("bKgst,btKd->bsKgd", probs, v[..., a:e].float())
                     for a, e in plan.planes(dv)], dim=-1)
    return out.reshape(b, sq, h, dv).to(q.dtype)
