"""Public wrapper: model-layout (B,S,H,hd) GQA attention via the
hand-written flash kernel (decoder prefill, encoder layers).  A CPU tensor
takes the plain version (``ref.attention_ref``); a CUDA tensor launches
``csrc/flash_attn.cu`` or raises.  When grad mode is on and an operand
requires grad, the CUDA call goes through ``FlashAttention``: the kernel is
its forward, and its backward is the softmax VJP by recomputation in plain
torch (the TPU kernel has no backward; JAX training differentiates its
jnp attention, as XLA)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn.ref import attention_ref
from repro_torch.models.attention import NEG_INF, make_mask

HEAD_DIMS = (32, 64, 128)       # head widths the kernel is compiled for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])


def check_operands(name, q, k, v):
    """Shared operand checks of the two attention wrappers."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{name}: q (B,S,H,hd), k/v (B,Sk,K,hd) expected; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match kv "
                         f"{tuple(k.shape)} (batch, head width, H % K)")
    if len({t.dtype for t in (q, k, v)}) != 1 or q.dtype not in DTYPES:
        raise TypeError(f"{name}: q, k, v must share one dtype of {list(DTYPES)}")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError(f"{name}: operands on different devices")
    if q.device.type == "cuda" and d not in HEAD_DIMS:
        raise ValueError(f"{name}: head width {d} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{name}: operands must be contiguous")


class FlashAttention(torch.autograd.Function):
    """Attention with ``fwd(q, k, v, causal=, window=)`` as its forward
    (the kernel on the card; a test passes ``attention_ref``) and the
    softmax VJP in plain torch, in f32, from P recomputed under the same
    causal and window mask (G = H / K query heads per kv head):

        P = softmax(s·Q·Kᵀ), dV = Σ_g Pᵀ·dO, dP = dO·Vᵀ,
        dS = P∘(dP − rowsum(dO∘O)), dQ = s·dS·K, dK = s·Σ_g dSᵀ·Q."""

    @staticmethod
    def forward(ctx, fwd, q, k, v, causal, window):
        out = fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        b, sq, h, d = q.shape
        sk, kh = k.shape[1], k.shape[2]
        g = h // kh
        s = d ** -0.5
        qf = q.float().reshape(b, sq, kh, g, d)
        kf, vf = k.float(), v.float()
        of = out.float().reshape(b, sq, kh, g, d)
        dof = dout.float().reshape(b, sq, kh, g, d)
        logits = torch.einsum("bsKgd,btKd->bKgst", qf, kf) * s
        allowed = make_mask(sq, sk, causal=ctx.causal, window=ctx.window,
                            device=q.device)
        p = torch.softmax(logits.masked_fill(~allowed, NEG_INF), dim=-1)
        dv = torch.einsum("bKgst,bsKgd->btKd", p, dof)
        dp = torch.einsum("bsKgd,btKd->bKgst", dof, vf)
        rows = (dof * of).sum(-1).permute(0, 2, 3, 1)      # (B, K, G, Sq)
        ds = p * (dp - rows[..., None])
        dq = torch.einsum("bKgst,btKd->bsKgd", ds, kf) * s
        dk = torch.einsum("bKgst,bsKgd->btKd", ds, qf) * s
        return (None, dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Sk, K, hd) → (B, Sq, H, hd).  Query row i
    sits at key position i; ``window`` > 0 keeps the last ``window`` keys."""
    check_operands("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(_launch, q, k, v, causal, window)
    return _launch(q, k, v, causal=causal, window=window)


def _launch(q, k, v, *, causal: bool, window: int):
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = _build.function("flash_attn", _ARGTYPES)
    rc = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, sq, sk, h, kh, d, int(causal), int(window),
            d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attn")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
