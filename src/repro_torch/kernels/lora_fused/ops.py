"""Public wrapper for the fused LoRA projection (serving and training).

Model code reaches it through ``peft.lora_proj`` for every projection that
carries factors, at any rank ≥ 1.  A CPU (or ``meta``: the dry run's
shapes) tensor takes the plain version (``ref.lora_ref``); a CUDA tensor
launches ``csrc/lora_fused.cu`` or raises.  Where the C code's rank rule
forms x·A outside the main loop (``lora_fused_workspace``; the source
note), this wrapper allocates the M × r workspace its first launch writes
round(x·A) into for its epilogue (one launch counted).  When grad mode is
on and an operand
requires grad, the CUDA call goes through ``LoraMatmul``:
the kernel is its forward, and its backward is plain torch (the TPU kernel
has no backward; JAX training differentiates the jnp projection, as XLA).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lora_fused.ref import lora_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p])


def _check(x, w, a, b):
    k, n = w.shape
    r = a.shape[1]
    if x.shape[-1] != k or a.shape != (k, r) or b.shape != (r, n):
        raise ValueError(f"lora_matmul shapes: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}")
    if r < 1:
        raise ValueError(f"lora_matmul: rank {r} < 1")
    if len({t.dtype for t in (x, w, a, b)}) != 1 or x.dtype not in DTYPES:
        raise TypeError("lora_matmul: x, w, a, b must share one dtype of "
                        f"{list(DTYPES)}; got {[t.dtype for t in (x, w, a, b)]}")
    if len({t.device for t in (x, w, a, b)}) != 1:
        raise ValueError("lora_matmul: operands on different devices")
    if not all(t.is_contiguous() for t in (x, w, a, b)):
        raise ValueError("lora_matmul: operands must be contiguous")


class LoraMatmul(torch.autograd.Function):
    """``y = x·W + s·(x·A)·B`` with ``fwd(x, w, a, b, scale=)`` as its
    forward (the kernel on the card; a test passes ``lora_ref``) and the
    gradients in plain torch, in f32:

        dx = dy·Wᵀ + s·(dy·Bᵀ)·Aᵀ,  dA = s·xᵀ·(dy·Bᵀ),
        dB = s·(x·A)ᵀ·dy,           dW = xᵀ·dy (only when W requires grad)."""

    @staticmethod
    def forward(ctx, fwd, x, w, a, b, scale):
        ctx.save_for_backward(x, w, a, b)
        ctx.scale = scale
        return fwd(x, w, a, b, scale=scale)

    @staticmethod
    def backward(ctx, dy):
        x, w, a, b = ctx.saved_tensors
        s = ctx.scale
        k, n = w.shape
        xf = x.reshape(-1, k).float()
        dyf = dy.reshape(-1, n).float()
        af, bf = a.float(), b.float()
        dyb = dyf @ bf.T                                   # (M, r)
        dx = dw = da = db = None
        need = ctx.needs_input_grad
        if need[1]:
            dx = (dyf @ w.float().T + s * (dyb @ af.T)).reshape(x.shape).to(x.dtype)
        if need[2]:
            dw = (xf.T @ dyf).to(w.dtype)
        if need[3]:
            da = (s * (xf.T @ dyb)).to(a.dtype)
        if need[4]:
            db = (s * ((xf @ af).T @ dyf)).to(b.dtype)
        return None, dx, dw, da, db, None


def lora_matmul(x, w, a, b, *, scale: float):
    """x: (..., K) @ [W (K,N) + scale·A (K,r)·B (r,N)] → (..., N)."""
    _check(x, w, a, b)
    if x.device.type in ("cpu", "meta"):
        return lora_ref(x, w, a, b, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, a, b)):
        return LoraMatmul.apply(_launch, x, w, a, b, scale)
    return _launch(x, w, a, b, scale=scale)


def _launch(x, w, a, b, *, scale: float):
    k, n = w.shape
    r = a.shape[1]
    xf = x.reshape(-1, k)
    y = torch.empty((xf.shape[0], n), dtype=x.dtype, device=x.device)
    # freed on return while the kernels may still run: the caching allocator
    # hands the block only to later work on this stream, which runs after them
    elems = workspace_elems(xf.shape[0], r)
    ws = torch.empty(elems, dtype=x.dtype, device=x.device) if elems else None
    fn = _build.function("lora_fused", _ARGTYPES)
    rc = fn(DTYPES[x.dtype], xf.data_ptr(), w.data_ptr(), a.data_ptr(),
            b.data_ptr(), None if ws is None else ws.data_ptr(), y.data_ptr(),
            xf.shape[0], n, k, r, float(scale),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "lora_fused")
    lora_matmul.launches += 1
    return y.reshape(*x.shape[:-1], n)


lora_matmul.launches = 0


def workspace_elems(m: int, r: int) -> int:
    """Elements of the workspace a call of ``m`` rows at rank ``r`` needs:
    m × r where the C rule takes x·A through it, else 0."""
    fn = _build.function("lora_fused", [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
                         symbol="lora_fused_workspace")
    elems = ctypes.c_longlong(0)
    _build.check(fn(m, r, ctypes.byref(elems)), "lora_fused_workspace")
    return elems.value
