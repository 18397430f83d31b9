"""PyTorch / CUDA port of the personalized federated LLM system.

The JAX package ``repro`` is the reference; this package mirrors its module
names, keeps its weight layouts at public functions (``W`` is
``(d_in, d_out)``, attention tensors are ``(B, S, H, hd)``) and runs its
hot spots through kernels written by hand for Hopper
(``repro_torch/csrc``).  Entry points run on CUDA unless the caller asks
for the CPU, where every kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"`` → the CUDA device, raising when there is none (no
    silent CPU fallback); ``"cpu"`` only when asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the plain PyTorch versions on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU); host timers
    of device work end here."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
