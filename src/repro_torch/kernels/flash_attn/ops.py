"""Public wrapper: model-layout (B,S,H,hd) GQA attention via the
hand-written flash kernel (decoder prefill, encoder layers, MLA).  A CPU
(or ``meta``: the dry run's shapes) tensor takes the plain version (``ref.attention_ref``); a CUDA tensor
launches ``csrc/flash_attn.cu`` or raises.  When grad mode is on and an
operand requires grad, the CUDA call goes through ``FlashAttention``: the
kernel is its forward, and its backward is the softmax VJP by recomputation
in plain torch (the TPU kernel has no backward; JAX training differentiates
its jnp attention, as XLA).

v may be narrower than q and k (MLA: q/k nope + rope wide, v its own
width).  Any row widths dk, dv ≥ 1 run on the card; ``plan(dk, dv,
itemsize)`` says how (``AttnPlan``), one function for the three attention
kernels:
- rows of whole 16-byte chunks up to 256 wide run in the smallest compiled
  (q/k, v) tile of ``WIDTHS`` that holds them, zero-filled past the rows
  (gemma3's heads of 240 in the 256 tile, heads of 16 in the 32 one, MLA's
  (80, 64) in (96, 64)), through cp.async where the operands are 16-byte
  aligned;
- rows that are not whole chunks (heads of 18 in f32, odd widths in bf16)
  are read and stored element by element, in the smallest square tile
  that holds the wider of the two (18 in 32, MLA's (34, 18) in 64);
- the prefill kernels split rows wider than 256 over a thread block
  cluster (``AttnPlan.cluster``, a ``Cluster``): each rank owns a slice of
  q/k dims and of v/o columns in the (128, 128) tile (``RANK_TILE``), the
  ranks' partial q·k dots are summed in rank order into one S that every
  rank holds, and each rank weights its own v columns by the same P (heads
  of 512: 4 ranks; past 16 ranks of 128 a rank loops over its slices).
  Whole-chunk rows keep their chunk reads there too;
- the decode kernel runs rows past 256 sliced in its 256 layout: the q·k
  dot over ``dk_slices`` 256-wide slices and v and o in ``dv_slices``
  column planes (heads of 512: 2 × 2).
Width 0 raises."""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn.ref import attention_ref
from repro_torch.models.attention import NEG_INF, make_mask

# (q/k, v) tile widths the prefill kernels are compiled for
# (REPRO_ATTN_WIDTHS in csrc/attn_tile.cuh): the square heads and MLA's
# (deepseek-v2's published (192, 128); (96, 64) for its reduced d-256
# variant, q/k 80)
WIDTHS = ((32, 32), (64, 64), (128, 128), (256, 256), (96, 64), (192, 128))
SQUARE = tuple(w for w in WIDTHS if w[0] == w[1])   # the decode kernel's; element rows'
SLICE = 256          # the widest one-block tile: wider rows split (decode: sliced)
RANK_TILE = (128, 128)   # a split rank's tile (RANK_W in csrc/attn_tile.cuh)
SPLIT_MAX = 16       # the largest thread block cluster on Hopper
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
             + [ctypes.c_float, ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class Cluster:
    """A head split over ``ranks`` blocks of a thread block cluster, each
    of the compiled ``tile`` (RK, RV): rank r owns ``k_per`` slices of RK
    q/k dims and ``v_per`` slices of RV v/o columns, from r·k_per·RK and
    r·v_per·RV (1 and 1 up to SPLIT_MAX ranks; past that every rank loops
    over its slices, and with ``v_per`` > 1 keeps its accumulators in an f32
    workspace of o's layout)."""
    tile: tuple
    ranks: int
    k_per: int = 1
    v_per: int = 1

    @property
    def loops(self) -> bool:
        return self.k_per > 1 or self.v_per > 1

    def dims(self, dk: int):
        """Each rank's [start, end) of q/k dims (empty for a rank with none)."""
        w = self.tile[0] * self.k_per
        return [(min(dk, r * w), min(dk, (r + 1) * w)) for r in range(self.ranks)]

    def cols(self, dv: int):
        """Each rank's [start, end) of v/o columns (empty for a rank with none)."""
        w = self.tile[1] * self.v_per
        return [(min(dv, r * w), min(dv, (r + 1) * w)) for r in range(self.ranks)]


def split_over(dk: int, dv: int) -> Cluster:
    """The ``Cluster`` of rows (dk, dv) over ranks of ``RANK_TILE``: as many
    ranks as the wider side needs, or, past SPLIT_MAX, slices a rank that
    bring both sides within SPLIT_MAX ranks (the C ``split_plan``)."""
    sk, sv = -(-dk // RANK_TILE[0]), -(-dv // RANK_TILE[1])
    if max(sk, sv) <= SPLIT_MAX:
        return Cluster(RANK_TILE, max(sk, sv))
    kp, vp = -(-sk // SPLIT_MAX), -(-sv // SPLIT_MAX)
    return Cluster(RANK_TILE, max(-(-sk // kp), -(-sv // vp)), kp, vp)


@dataclasses.dataclass(frozen=True)
class AttnPlan:
    """How the attention kernels run rows of q/k width dk and v width dv:
    ``tile`` the compiled (DK, DV) instance (SLICE square past SLICE);
    ``aligned`` whether the rows are whole 16-byte chunks (the chunk path:
    cp.async or 16-byte loads where the operands are 16-byte aligned) or
    are read and stored element by element; ``cluster`` the prefill
    kernels' split of rows past SLICE (``Cluster``; None where the call
    runs in one block a (batch·head, q tile)); ``dk_slices`` and
    ``dv_slices`` the decode kernel's route past SLICE: the SLICE-wide
    slices q·k is summed over and the column planes v and o are cut into
    (the decode kernel has dk = dv)."""
    tile: tuple
    aligned: bool
    dk_slices: int = 1
    dv_slices: int = 1
    cluster: Cluster | None = None

    @property
    def sliced(self) -> bool:
        return self.dk_slices > 1 or self.dv_slices > 1

    @property
    def path(self) -> int:
        """The C entry points' ``rows``: 0 whole chunks, 1 elements, 2 rows
        past SLICE (the prefill kernels split, reading chunks where the rows
        are whole; the decode kernel slices)."""
        return 2 if self.sliced else 0 if self.aligned else 1

    def planes(self, dv: int):
        """The [start, end) columns of v and o each of the decode kernel's
        planes covers."""
        w = self.tile[1]
        return [(z * w, min(dv, (z + 1) * w)) for z in range(self.dv_slices)]


def plan(dk: int, dv: int, itemsize: int = 4, widths=WIDTHS) -> AttnPlan:
    """The ``AttnPlan`` of a call with rows of q/k width ``dk`` and v width
    ``dv`` (elements of ``itemsize`` bytes) in the tiles ``widths``: rows
    wider than SLICE in (SLICE, SLICE), split over ranks of ``RANK_TILE``
    (decode: sliced); rows of whole 16-byte chunks in the smallest of
    ``widths`` (by DK + DV) with DK ≥ dk and DV ≥ dv; other rows element by
    element in the smallest square one of them.  A width below 1 raises
    ValueError naming it."""
    if min(dk, dv) < 1:
        vw = f" (v {dv})" if dv != dk else ""
        raise ValueError(f"head width {dk}{vw}: rows must be at least one element wide")
    chunk = 16 // itemsize
    aligned = dk % chunk == 0 and dv % chunk == 0
    if max(dk, dv) > SLICE:
        return AttnPlan((SLICE, SLICE), aligned, -(-dk // SLICE), -(-dv // SLICE),
                        split_over(dk, dv))
    fits = [w for w in widths if w[0] >= dk and w[1] >= dv and (aligned or w in SQUARE)]
    return AttnPlan(min(fits, key=lambda w: (w[0] + w[1], w[0])), aligned)


def instance(dk: int, dv: int, itemsize: int = 4, widths=WIDTHS):
    """The compiled (DK, DV) tile a call with rows (dk, dv) runs in:
    ``plan(...).tile``."""
    return plan(dk, dv, itemsize, widths).tile


def check_operands(name, q, k, v, widths=WIDTHS):
    """Shared operand checks of the attention wrappers: q (B,S,H,dk), k
    (B,Sk,K,dk), v (B,Sk,K,dv).  On the card → the call's ``AttnPlan`` in
    ``widths``; elsewhere None."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"{name}: q (B,S,H,hd), k (B,Sk,K,hd), v (B,Sk,K,hdv) expected; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    dv = v.shape[3]
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match kv "
                         f"{tuple(k.shape)} (batch, head width, H % K)")
    if len({t.dtype for t in (q, k, v)}) != 1 or q.dtype not in DTYPES:
        raise TypeError(f"{name}: q, k, v must share one dtype of {list(DTYPES)}")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError(f"{name}: operands on different devices")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{name}: operands must be contiguous")
    try:
        p = plan(d, dv, q.element_size(), widths)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    return p if q.device.type == "cuda" else None


class FlashAttention(torch.autograd.Function):
    """Attention with ``fwd(q, k, v, causal=, window=, scale=)`` as its
    forward (the kernel on the card; a test passes ``attention_ref``) and
    the softmax VJP in plain torch, in f32, from P recomputed under the same
    causal and window mask (G = H / K query heads per kv head, s the
    scale; v may be narrower than q and k):

        P = softmax(s·Q·Kᵀ), dV = Σ_g Pᵀ·dO, dP = dO·Vᵀ,
        dS = P∘(dP − rowsum(dO∘O)), dQ = s·dS·K, dK = s·Σ_g dSᵀ·Q."""

    @staticmethod
    def forward(ctx, fwd, q, k, v, causal, window, scale=None):
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        out = fwd(q, k, v, causal=causal, window=window, scale=scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        b, sq, h, d = q.shape
        sk, kh, dv = k.shape[1], k.shape[2], v.shape[3]
        g = h // kh
        s = ctx.scale
        qf = q.float().reshape(b, sq, kh, g, d)
        kf, vf = k.float(), v.float()
        of = out.float().reshape(b, sq, kh, g, dv)
        dof = dout.float().reshape(b, sq, kh, g, dv)
        logits = torch.einsum("bsKgd,btKd->bKgst", qf, kf) * s
        allowed = make_mask(sq, sk, causal=ctx.causal, window=ctx.window,
                            device=q.device)
        p = torch.softmax(logits.masked_fill(~allowed, NEG_INF), dim=-1)
        dvv = torch.einsum("bKgst,bsKgd->btKd", p, dof)
        dp = torch.einsum("bsKgd,btKd->bKgst", dof, vf)
        rows = (dof * of).sum(-1).permute(0, 2, 3, 1)      # (B, K, G, Sq)
        ds = p * (dp - rows[..., None])
        dq = torch.einsum("bKgst,btKd->bsKgd", ds, kf) * s
        dk = torch.einsum("bKgst,bsKgd->btKd", ds, qf) * s
        return (None, dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
                dvv.to(v.dtype), None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """q: (B, Sq, H, dk); k: (B, Sk, K, dk); v: (B, Sk, K, dv) → (B, Sq, H,
    dv).  Query row i sits at key position i; ``window`` > 0 keeps the last
    ``window`` keys; ``scale`` (default dk^-1/2) multiplies q·k."""
    check_operands("flash_attention", q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type in ("cpu", "meta"):
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(_launch, q, k, v, causal, window, scale)
    return _launch(q, k, v, causal=causal, window=window, scale=scale)


def workspace(q, dv: int, p: AttnPlan):
    """The f32 (B, Sq, H, dv) accumulator workspace of a split whose ranks
    loop over more than one v slice (dv past SPLIT_MAX · 128), else None."""
    if p.cluster is None or p.cluster.v_per == 1:
        return None
    return torch.empty(*q.shape[:3], dv, dtype=torch.float32, device=q.device)


def _launch(q, k, v, *, causal: bool, window: int, scale: float):
    b, sq, h, d = q.shape
    sk, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    p = plan(d, dv, q.element_size())
    out = q.new_empty(b, sq, h, dv)
    work = workspace(q, dv, p)
    fn = _build.function("flash_attn", _ARGTYPES)
    rc = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if work is None else work.data_ptr(), b, sq, sk, h, kh,
            *p.tile, p.path, d, dv, int(causal), int(window), scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attn")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def occupancy(dk: int, dv: int, bq: int):
    """(blocks an SM, dynamic shared bytes a block) of the f32 tile of
    widths (dk, dv) (one of ``WIDTHS``) with a ``bq``-row q tile (32 or 64),
    by the card's occupancy call."""
    fn = _build.function("flash_attn", [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
                         symbol="flash_attn_occupancy")
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(fn(dk, dv, bq, ctypes.byref(blocks), ctypes.byref(smem)),
                 "flash_attn_occupancy")
    return blocks.value, smem.value


def split_occupancy(ranks: int):
    """(blocks an SM, clusters of ``ranks`` the card holds at once, dynamic
    shared bytes a block) of the f32 split instance rows past SLICE run in,
    by the card's occupancy calls."""
    fn = _build.function("flash_attn", [ctypes.c_int] + [ctypes.c_void_p] * 3,
                         symbol="flash_attn_split_occupancy")
    blocks, clusters, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    _build.check(fn(ranks, ctypes.byref(blocks), ctypes.byref(clusters),
                    ctypes.byref(smem)), "flash_attn_split_occupancy")
    return blocks.value, clusters.value, smem.value
