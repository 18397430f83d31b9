"""Stochastic-rounding per-channel quantization, the port of
``repro.comms.quantize``: one leaf at a time, so the tree layer
(``comms.codec``) runs it for each client of the cohort.

Scheme (per leaf):

* **channel axis** — the smaller of the last two dims (the rank axis of a
  LoRA factor); 1-D leaves get one per-tensor scale.
* **scale** — the channel's absmax over ``qmax = 2^(bits-1) - 1``, biased
  up by 1 + 2⁻⁷ and rounded through bfloat16 (the precision it rides the
  payload at; ``.to(torch.bfloat16)`` rounds to nearest even, as JAX's
  ``astype`` does).
* **stochastic rounding** — ``q = floor(x/scale + u)``, ``u`` uniform on
  [0, 1), so ``E[q·scale] = x``.  The uniforms are an argument: the caller
  draws them (``comms.codec.codec_uniforms``, or the JAX package's draws in
  the parity tests).

The bit charge is the empirical entropy of the symbols.  Its histogram is
counted in float64 and the entropy formed in float64: the JAX package
counts in float32, whose bins stop moving past 2²⁴ elements (a 38.6 M
element embedding masked almost wholly to symbol 0), and the port does not
copy that.
"""
from __future__ import annotations

import torch


def qmax_for(bits: int) -> int:
    """Largest symmetric integer level: 127 for int8, 7 for int4."""
    return 2 ** (bits - 1) - 1


def channel_axis(shape) -> int:
    """The axis a per-channel scale reduces over (``len(shape) >= 2``)."""
    return -2 if shape[-2] >= shape[-1] else -1


def channel_scale(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-channel absmax / qmax, rounded up through bf16 (f32 result)."""
    ax = x.float().abs()
    s = ax.amax(dim=channel_axis(x.shape), keepdim=True) if x.dim() >= 2 else ax.amax()
    s = s / qmax_for(bits)
    # biased UP (1+2⁻⁷ > bf16's 2⁻⁸ ulp): a scale rounded down would push the
    # channel's absmax element past qmax into the clip, a biased rounding
    return (s * (1.0 + 2.0 ** -7)).to(torch.bfloat16).float()


def sr_quantize(x: torch.Tensor, bits: int, u: torch.Tensor):
    """Encode with the uniforms ``u`` (x's shape): {'q': int8 symbols in
    [-qmax, qmax], 'scale': the bf16-rounded scales}.  An all-zero channel
    gives scale 0 and q 0."""
    qm = qmax_for(bits)
    scale = channel_scale(x, bits)
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    y = x.float() * inv
    q = torch.clamp(torch.floor(y + u), -qm, qm).to(torch.int8)
    return {"q": q, "scale": scale}


def sr_dequantize(enc, dtype=torch.float32) -> torch.Tensor:
    """Decode: q · scale."""
    return (enc["q"].float() * enc["scale"]).to(dtype)


def symbol_entropy_bits(q: torch.Tensor, bits: int, weight=None) -> torch.Tensor:
    """n·H(q) bits over the ``2^bits``-ary histogram of the symbols (≤
    n·bits), an f32 scalar.  ``weight`` (broadcastable to q, e.g. PFIT's 0/1
    sparsity mask) weights each element's count; weight-0 elements are not
    charged.  Counts and entropy in float64."""
    nsym = 2 ** bits
    sym = (q.long() + nsym // 2).reshape(-1)
    w = None if weight is None else torch.broadcast_to(
        torch.as_tensor(weight, device=q.device), q.shape).reshape(-1).double()
    hist = torch.bincount(sym, weights=w, minlength=nsym).double()
    n = hist.sum()
    p = hist / torch.clamp(n, min=1.0)
    plogp = torch.where(p > 0, p * torch.log2(torch.clamp(p, min=1e-300)),
                        torch.zeros_like(p))
    return (-n * plogp.sum()).float()
