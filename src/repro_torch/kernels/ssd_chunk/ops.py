"""Public wrapper: model-layout Mamba-2 SSD chunked scan.  A CPU tensor
takes the plain version (``ref.ssd_ref``); a CUDA tensor launches
``csrc/ssd_chunk.cu`` or raises.

x (B,S,H,P) and B/C (B,S,H,N) may be strided views — the mixer passes the
head slice of its conv output and a stride-0 broadcast of one group over
the heads — as long as their last axis is contiguous; the kernel reads them
through their strides.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_chunk.ref import ssd_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SHAPES = ((16, 16), (32, 32), (64, 64), (64, 128))   # (P, N) the kernel is compiled for
CHUNK_MAX = 1024
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])


def _check(x, dt, a_coef, bmat, cmat, h0):
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if (dt.shape != (b, s, h) or a_coef.shape != (h,)
            or bmat.shape != (b, s, h, n) or cmat.shape != (b, s, h, n)
            or (h0 is not None and h0.shape != (b, h, p, n))):
        raise ValueError(
            f"ssd_scan shapes: x {tuple(x.shape)}, dt {tuple(dt.shape)}, a "
            f"{tuple(a_coef.shape)}, B {tuple(bmat.shape)}, C {tuple(cmat.shape)}"
            + ("" if h0 is None else f", h0 {tuple(h0.shape)}"))
    tensors = [x, dt, a_coef, bmat, cmat] + ([] if h0 is None else [h0])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("ssd_scan: operands on different devices")
    if x.device.type == "cpu":
        return
    if len({x.dtype, bmat.dtype, cmat.dtype}) != 1 or x.dtype not in DTYPES:
        raise TypeError(f"ssd_scan: x, B, C must share one dtype of {list(DTYPES)}")
    if any(t.dtype != torch.float32 for t in [dt, a_coef] + ([] if h0 is None else [h0])):
        raise TypeError("ssd_scan: dt, a and h0 must be float32")
    if (p, n) not in SHAPES:
        raise ValueError(f"ssd_scan: (P, N) = {(p, n)} not in {SHAPES}")
    if any(t.stride(-1) != 1 for t in (x, bmat, cmat)):
        raise ValueError("ssd_scan: the last axis of x, B and C must be contiguous")
    if not all(t.is_contiguous() for t in [dt, a_coef] + ([] if h0 is None else [h0])):
        raise ValueError("ssd_scan: dt, a and h0 must be contiguous")


def ssd_scan(x, dt, a_coef, bmat, cmat, *, chunk: int = 256, h0=None):
    """x (B,S,H,P); dt (B,S,H); a_coef (H,); b/c (B,S,H,N); h0 (B,H,P,N)
    or None → (y (B,S,H,P) in x's dtype, h_final (B,H,P,N) f32).  y
    excludes the D-skip term."""
    _check(x, dt, a_coef, bmat, cmat, h0)
    if x.device.type == "cpu":
        return ssd_ref(x, dt, a_coef, bmat, cmat, chunk=chunk, h0=h0)
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    chunk = min(chunk, s)
    if not 1 <= chunk <= CHUNK_MAX:
        raise ValueError(f"ssd_scan: chunk {chunk} outside 1..{CHUNK_MAX}")
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    h_out = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    fn = _build.function("ssd_chunk", _ARGTYPES)
    rc = fn(DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a_coef.data_ptr(),
            bmat.data_ptr(), cmat.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_out.data_ptr(), b, s, h, p, n, chunk,
            *x.stride()[:3], *bmat.stride()[:3], *cmat.stride()[:3],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "ssd_chunk")
    ssd_scan.launches += 1
    return y, h_out


ssd_scan.launches = 0
