"""Public wrapper: model-layout (B,S,H,hd) GQA attention via the
hand-written flash kernel (prefill).  A CPU tensor takes the plain version
(``ref.attention_ref``); a CUDA tensor launches ``csrc/flash_attn.cu`` or
raises."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn.ref import attention_ref

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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Sk, K, hd) → (B, Sq, H, hd).  Query row i
    sits at key position i; ``window`` > 0 keeps the last ``window`` keys."""
    check_operands("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
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
