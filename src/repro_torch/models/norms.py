"""Normalization layers (functional), computed in f32 and cast back."""
import torch
import torch.nn.functional as F


def rmsnorm(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    """(x - mean) / sqrt(biased var + eps) · scale + bias, as the JAX
    package computes it, in one fused PyTorch op."""
    out = F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(), eps)
    return out.to(x.dtype)


def apply_norm(x, params, kind: str, eps: float):
    if kind == "rms":
        return rmsnorm(x, params["scale"], eps)
    return layernorm(x, params["scale"], params["bias"], eps)
