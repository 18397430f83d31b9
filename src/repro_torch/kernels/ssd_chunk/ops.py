"""Public wrapper: model-layout Mamba-2 SSD chunked scan.  A CPU tensor
takes the plain version (``ref.ssd_ref``); a CUDA tensor launches
``csrc/ssd_chunk.cu`` or raises.

x (B,S,H,P) and B/C (B,S,H,N) may be strided views — the mixer passes the
head slice of its conv output and a stride-0 broadcast of one group over
the heads — as long as their last axis is contiguous; the kernel reads them
through their strides.  With that broadcast (B and C of stride 0 over the
heads) C·Bᵀ is formed once per (batch, chunk), else once per head.

The CUDA path is four launches on the current stream (C·Bᵀ, the chunk
states, the state passing, the outputs; three when C·Bᵀ's tiles run in the
chunk states' launch) over a workspace this wrapper allocates;
``ssd_plan`` reports which, as the C code's rule chooses it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_chunk.ref import ssd_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SHAPES = ((16, 16), (32, 32), (64, 64), (64, 128))   # (P, N) the kernel is compiled for
CHUNK_MAX = 1024
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_longlong]
             + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])


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
    _build.forward_only("ssd_scan", x, dt, a_coef, bmat, cmat, h0)
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    chunk = min(chunk, s)
    if not 1 <= chunk <= CHUNK_MAX:
        raise ValueError(f"ssd_scan: chunk {chunk} outside 1..{CHUNK_MAX}")
    shared = shared_cb(bmat, cmat)
    size = workspace_floats(b, s, h, p, n, chunk, shared)
    # freed on return while the kernels may still run: the caching allocator
    # hands the block only to later work on this stream, which runs after them
    ws = torch.empty(size, dtype=torch.float32, device=x.device)
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    h_out = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    fn = _build.function("ssd_chunk", _ARGTYPES)
    rc = fn(DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a_coef.data_ptr(),
            bmat.data_ptr(), cmat.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_out.data_ptr(), ws.data_ptr(), size, b, s, h, p, n, chunk,
            int(shared), *x.stride()[:3], *bmat.stride()[:3], *cmat.stride()[:3],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "ssd_chunk")
    ssd_scan.launches += 1
    return y, h_out


ssd_scan.launches = 0


def shared_cb(bmat, cmat) -> bool:
    """Whether C·Bᵀ is formed once per (batch, chunk): one head, or B and C
    a stride-0 broadcast over the heads (the mixer's one group)."""
    return bmat.shape[2] == 1 or (bmat.stride(2) == 0 and cmat.stride(2) == 0)


def workspace_floats(b, s, h, p, n, chunk, shared) -> int:
    """f32 workspace of one call: the chunk states (B,H,nc,P,N), the prefix
    sums and dt (B,H,nc,LP) each, and C·Bᵀ (B,G,nc,L,LP) with G 1 when
    ``shared`` else H; LP is the chunk rounded up to 4.  Per head, C·Bᵀ is
    about B·H·S·chunk floats: 134 MB at B 4, S 512, H 64, chunk 256 and
    2.1 GB at S 2048, chunk 1024, against 2.1 MB and 34 MB shared.  Only
    B and C given per head (several groups) take that size."""
    nc, lp = -(-s // chunk), (chunk + 3) // 4 * 4
    return b * h * nc * p * n + 2 * b * h * nc * lp + b * (1 if shared else h) * nc * chunk * lp


def ssd_plan(batch: int, seq: int, heads: int, headdim: int, state: int, *,
             chunk: int = 256) -> bool:
    """Whether the C rule runs C·Bᵀ's tiles in the chunk states' launch
    (True) or in a launch of its own for a call of this shape."""
    fn = _build.function("ssd_chunk", [ctypes.c_int] * 6 + [ctypes.c_void_p],
                         symbol="ssd_chunk_plan")
    fused = ctypes.c_int(0)
    _build.check(fn(batch, seq, heads, headdim, state, min(chunk, seq), ctypes.byref(fused)),
                 "ssd_chunk_plan")
    return bool(fused.value)
