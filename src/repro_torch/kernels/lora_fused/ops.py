"""Public wrapper for the fused LoRA projection (personalized serving).

Model code reaches it through ``peft.lora_proj`` for every projection that
carries factors.  A CPU tensor takes the plain version (``ref.lora_ref``);
a CUDA tensor launches ``csrc/lora_fused.cu`` or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lora_fused.ref import lora_ref

RANK_MAX = 32          # the kernel's shared-memory budget for the rank
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p])


def _check(x, w, a, b):
    k, n = w.shape
    r = a.shape[1]
    if x.shape[-1] != k or a.shape != (k, r) or b.shape != (r, n):
        raise ValueError(f"lora_matmul shapes: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}")
    if not 1 <= r <= RANK_MAX:
        raise ValueError(f"lora_matmul: rank {r} outside 1..{RANK_MAX}")
    if len({t.dtype for t in (x, w, a, b)}) != 1 or x.dtype not in DTYPES:
        raise TypeError("lora_matmul: x, w, a, b must share one dtype of "
                        f"{list(DTYPES)}; got {[t.dtype for t in (x, w, a, b)]}")
    if len({t.device for t in (x, w, a, b)}) != 1:
        raise ValueError("lora_matmul: operands on different devices")
    if not all(t.is_contiguous() for t in (x, w, a, b)):
        raise ValueError("lora_matmul: operands must be contiguous")


def lora_matmul(x, w, a, b, *, scale: float):
    """x: (..., K) @ [W (K,N) + scale·A (K,r)·B (r,N)] → (..., N)."""
    _check(x, w, a, b)
    if x.device.type == "cpu":
        return lora_ref(x, w, a, b, scale=scale)
    _build.forward_only("lora_matmul", x, w, a, b)
    k, n = w.shape
    xf = x.reshape(-1, k)
    y = torch.empty((xf.shape[0], n), dtype=x.dtype, device=x.device)
    fn = _build.function("lora_fused", _ARGTYPES)
    rc = fn(DTYPES[x.dtype], xf.data_ptr(), w.data_ptr(), a.data_ptr(),
            b.data_ptr(), y.data_ptr(), xf.shape[0], n, k, a.shape[1],
            float(scale), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "lora_fused")
    lora_matmul.launches += 1
    return y.reshape(*x.shape[:-1], n)


lora_matmul.launches = 0
