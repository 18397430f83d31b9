"""Plain PyTorch version of the fused LoRA projection."""
import torch


def lora_ref(x, w, a, b, *, scale: float):
    """``x·W + scale·(x·A)·B`` in f32, with ``x·A`` cast to ``B.dtype``
    before the rank-r product as the kernel does; output in ``x.dtype``."""
    xf = x.float()
    xa = (xf @ a.float()).to(b.dtype).float()
    return (xf @ w.float() + scale * (xa @ b.float())).to(x.dtype)
