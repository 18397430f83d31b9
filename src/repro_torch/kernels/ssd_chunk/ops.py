"""Public wrapper: model-layout Mamba-2 SSD chunked scan.  A CPU tensor
(or a ``meta`` one: the dry run's shapes) takes the plain version (``ref.ssd_ref``); a CUDA tensor launches
``csrc/ssd_chunk.cu`` or raises.

x (B,S,H,P) and B/C (B,S,H,N) may be strided views — the mixer passes the
head slice of its conv output and a stride-0 broadcast of one group over
the heads — as long as their last axis is contiguous; the kernel reads them
through their strides.  With that broadcast (B and C of stride 0 over the
heads) C·Bᵀ is formed once per (batch, chunk), else once per head.

The CUDA path is four launches on the current stream (C·Bᵀ, the chunk
states, the state passing, the outputs; three when C·Bᵀ's tiles run in the
chunk states' launch) over a workspace this wrapper allocates;
``ssd_plan`` reports which, as the C code's rule chooses it.  The kernel is
compiled for the (P, N) pairs of ``SHAPES``; any other pair runs as a
cover (``ssd_cover``): one such call of a compiled pair per head-dim block
× state block, the state's columns and the head dims being independent, y
summed over the state blocks in f32 and ``h_final`` assembled from the
blocks (``cover`` picks the pair).  When grad
mode is on and an operand requires grad, the CUDA call goes through
``SSDScan``: the kernel is its forward, and its backward recomputes the
plain version under autograd (the TPU kernel has no backward; JAX
training differentiates its jnp scan, as XLA).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

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
    if x.device.type in ("cpu", "meta"):
        return
    if len({x.dtype, bmat.dtype, cmat.dtype}) != 1 or x.dtype not in DTYPES:
        raise TypeError(f"ssd_scan: x, B, C must share one dtype of {list(DTYPES)}")
    if any(t.dtype != torch.float32 for t in [dt, a_coef] + ([] if h0 is None else [h0])):
        raise TypeError("ssd_scan: dt, a and h0 must be float32")
    if any(t.stride(-1) != 1 for t in (x, bmat, cmat)):
        raise ValueError("ssd_scan: the last axis of x, B and C must be contiguous")
    if not all(t.is_contiguous() for t in [dt, a_coef] + ([] if h0 is None else [h0])):
        raise ValueError("ssd_scan: dt, a and h0 must be contiguous")


class SSDScan(torch.autograd.Function):
    """The scan with ``fwd(x, dt, a_coef, bmat, cmat, chunk=, h0=)`` as its
    forward (the kernel on the card; a test passes ``ssd_ref``) and the
    backward by recomputation: ``ssd_ref`` on detached copies of the
    inputs under ``enable_grad``, then ``autograd.grad`` of its two outputs
    against the incoming cotangents (f32 arithmetic, as the plain version
    computes).  A stride-0 broadcast of B or C over the heads gets its
    gradient summed over the broadcast by autograd of the view it came
    from."""

    @staticmethod
    def forward(ctx, fwd, chunk, x, dt, a_coef, bmat, cmat, h0):
        y, h_out = fwd(x, dt, a_coef, bmat, cmat, chunk=chunk, h0=h0)
        ctx.save_for_backward(x, dt, a_coef, bmat, cmat, h0)
        ctx.chunk = chunk
        return y, h_out

    @staticmethod
    def backward(ctx, dy, dh):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        ins = [None if t is None else t.detach().requires_grad_(n)
               for t, n in zip(saved, need)]
        with torch.enable_grad():
            y, h_out = ssd_ref(*ins[:5], chunk=ctx.chunk, h0=ins[5])
            wrt = [t for t, n in zip(ins, need) if t is not None and n]
            outs, cots = zip(*[(o, c) for o, c in ((y, dy), (h_out, dh)) if c is not None])
            got = iter(torch.autograd.grad(outs, wrt, cots, allow_unused=True))
        grads = [next(got) if t is not None and n else None for t, n in zip(ins, need)]
        return (None, None, *grads)


def ssd_scan(x, dt, a_coef, bmat, cmat, *, chunk: int = 256, h0=None):
    """x (B,S,H,P); dt (B,S,H); a_coef (H,); b/c (B,S,H,N); h0 (B,H,P,N)
    or None → (y (B,S,H,P) in x's dtype, h_final (B,H,P,N) f32).  y
    excludes the D-skip term.  Any (P, N); on the card a pair outside
    ``SHAPES`` counts one launch per block of its cover."""
    _check(x, dt, a_coef, bmat, cmat, h0)
    if x.device.type in ("cpu", "meta"):
        return ssd_ref(x, dt, a_coef, bmat, cmat, chunk=chunk, h0=h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, a_coef, bmat, cmat, h0)):
        return SSDScan.apply(_launch, chunk, x, dt, a_coef, bmat, cmat, h0)
    return _launch(x, dt, a_coef, bmat, cmat, chunk=chunk, h0=h0)


def _launch(x, dt, a_coef, bmat, cmat, *, chunk: int, h0=None):
    return ssd_cover(_launch_block, x, dt, a_coef, bmat, cmat, chunk=chunk, h0=h0)


def padded_work(p: int, n: int, pi: int, ni: int, *, chunk: int, heads: int,
                groups: int) -> int:
    """Operations a position (up to a factor of 2) of covering (p, n) by
    launches of the compiled pair (pi, ni), padding included, as
    chip_smoke.py counts the scan's: each head's causal S·x (chunk·P) and its
    chunk state and C·h_startᵀ (4·P·N), each group's causal C·Bᵀ (chunk·N),
    all repeated in every one of the ceil(p/pi)·ceil(n/ni) launches."""
    launches = -(-p // pi) * -(-n // ni)
    return launches * (heads * (chunk * pi + 4 * pi * ni) + groups * chunk * ni)


def cover(p: int, n: int, *, chunk: int, heads: int, groups: int):
    """The compiled pair (pi, ni) of least ``padded_work``, then fewest
    launches → (pi, ni, ceil(p/pi) head-dim blocks, ceil(n/ni) state
    blocks).  A pair of ``SHAPES`` covers itself in one launch."""
    pi, ni = min(SHAPES, key=lambda pair: (
        padded_work(p, n, *pair, chunk=chunk, heads=heads, groups=groups),
        -(-p // pair[0]) * -(-n // pair[1])))
    return pi, ni, -(-p // pi), -(-n // ni)


def _block(t, lo: int, size: int):
    """t[..., lo:lo + size], zero-filled past t's last axis."""
    v = t[..., lo:lo + size]
    return v if v.shape[-1] == size else F.pad(v, (0, size - v.shape[-1]))


def ssd_cover(fn, x, dt, a_coef, bmat, cmat, *, chunk: int, h0=None):
    """The scan by calls of ``fn`` (``ssd_scan``'s contract) at a compiled
    (P, N) pair: ``fn`` itself for a pair of ``SHAPES``, else one call per
    block of ``cover``'s.  A head-dim block takes x's columns as a view
    (a copy zero-filled past P); a state block B's and C's columns, cut
    from the one group before it is broadcast over the heads when they are
    the mixer's stride-0 broadcast, so each call still forms C·Bᵀ once per
    (batch, chunk); ``h0`` is cut the same way.  Zero columns of x, B, C and
    h0 add nothing to y and keep their state columns zero.  y is the sum of
    the state blocks' outputs (in f32: a bf16 call then runs its blocks in
    f32), ``h_final`` the blocks' states."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if (p, n) in SHAPES:
        return fn(x, dt, a_coef, bmat, cmat, chunk=chunk, h0=h0)
    shared = shared_cb(bmat, cmat)
    pi, ni, _, n_n = cover(p, n, chunk=min(chunk, s), heads=h, groups=1 if shared else h)
    out_dtype = x.dtype
    if n_n > 1:
        x, bmat, cmat = x.float(), bmat.float(), cmat.float()
    if shared:   # one group, cut before the broadcast
        bmat, cmat = bmat[:, :, :1], cmat[:, :, :1]
    ys, h_out = [], torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    for p0 in range(0, p, pi):
        xb, y, pw = _block(x, p0, pi), None, min(pi, p - p0)
        for n0 in range(0, n, ni):
            nw = min(ni, n - n0)
            bb, cb = (_block(t, n0, ni).expand(b, s, h, ni) for t in (bmat, cmat))
            hb = None if h0 is None else F.pad(
                h0[:, :, p0:p0 + pw, n0:n0 + nw], (0, ni - nw, 0, pi - pw)).contiguous()
            yb, hf = fn(xb, dt, a_coef, bb, cb, chunk=chunk, h0=hb)
            y = yb if y is None else y + yb
            h_out[:, :, p0:p0 + pw, n0:n0 + nw] = hf[:, :, :pw, :nw]
        ys.append(y[..., :pw])
    return torch.cat(ys, -1).to(out_dtype), h_out


def _launch_block(x, dt, a_coef, bmat, cmat, *, chunk: int, h0=None):
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
             chunk: int = 256, groups: int = 1) -> bool:
    """Whether the C rule runs C·Bᵀ's tiles in the chunk states' launch
    (True) or in a launch of its own for a call of this shape (for each
    launch of its cover, for a pair outside ``SHAPES``: ``groups`` 1 when B
    and C are shared over the heads, else ``heads``, as ``ssd_cover``
    picks the cover)."""
    if (headdim, state) not in SHAPES:
        headdim, state = cover(headdim, state, chunk=min(chunk, seq), heads=heads,
                               groups=groups)[:2]
    fn = _build.function("ssd_chunk", [ctypes.c_int] * 6 + [ctypes.c_void_p],
                         symbol="ssd_chunk_plan")
    fused = ctypes.c_int(0)
    _build.check(fn(batch, seq, heads, headdim, state, min(chunk, seq), ctypes.byref(fused)),
                 "ssd_chunk_plan")
    return bool(fused.value)
