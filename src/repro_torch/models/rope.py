"""Rotary position embeddings (the port of ``repro.models.rope``): the
half-rotation convention — the head's first and second halves form the
rotated pairs, not interleaved neighbours."""
import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _freqs(half: int, theta: float, device) -> torch.Tensor:
    """exp(−log(θ)·i/half), i < half, f32: the exponent in f32 arithmetic
    from log(θ) rounded to f32, as the JAX package computes it, and its exp
    rounded correctly from float64 on the host, so the card and the CPU use
    one table.  (XLA's f32 exp on the CPU is off by an ulp at a few i.)"""
    arg = (np.float32(-np.log(np.float32(theta))) * np.arange(half, dtype=np.float32)
           / np.float32(half))
    return torch.from_numpy(np.exp(arg.astype(np.float64)).astype(np.float32)).to(device)


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions (...,) int → cos, sin of shape positions.shape + (head_dim/2,),
    f32."""
    ang = positions.to(torch.float32)[..., None] * _freqs(head_dim // 2, float(theta),
                                                          positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (S,) or (B, S) → x rotated, in x's dtype."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


def rotate(x, cos, sin):
    """``apply_rope`` from a table ``rope_cos_sin`` made once for the
    positions (a model step rotates every layer's q and k with one)."""
    while cos.dim() < x.dim() - 1:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).to(x.dtype)
