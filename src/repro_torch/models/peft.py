"""LoRA and bottleneck adapters (the port of ``repro.models.peft``).

LoRA factors mirror targeted weight leaves: ``W (…, din, dout)`` →
``A (…, din, r)``, ``B (…, r, dout)`` and a per-repeat enable ``mask``
``(repeats, 1, 1)``.  Serving and training keep them UNMERGED: every
targeted projection runs ``y = x@W + (α/r)·(x@A)@(mask·B)`` through the
fused ``lora_fused`` kernel (``lora_proj``), so the shared base is never
re-materialized per client; the mask carries no gradient.
``apply_lora`` (merge ``W + (α/r)·mask·A·B`` and run the plain forward) is
kept as the merged parity oracle.  PFTT's universal adapters
(``init_adapters``) are bottleneck modules with a residual, inserted in
every layer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import trees
from repro_torch.kernels.lora_fused.ops import lora_matmul

LORA_DEFAULT_TARGETS = ("mixer/wq", "mixer/wv", "mixer/wq_a", "mixer/wq_b",
                        "mixer/wkv_a", "mixer/wkv_b", "mixer/in_proj",
                        "mixer/out_proj")


@dataclasses.dataclass(frozen=True)
class PEFTConfig:
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = LORA_DEFAULT_TARGETS
    lora_layers: int = 0          # 0 → all repeats; n → only the last n repeats
    adapter_dim: int = 64
    enable_lora: bool = True
    enable_adapters: bool = True


def lora_scale(peft: PEFTConfig) -> float:
    """The α/r multiplier of the low-rank path."""
    return peft.lora_alpha / peft.lora_rank


def _is_target(path: str, targets) -> bool:
    return any(path.endswith(t) for t in targets)


def init_lora(generator: torch.Generator, params, peft: PEFTConfig) -> Dict:
    """Mirror of ``params`` with {'a','b','mask'} at each targeted leaf and
    ``None`` elsewhere.  A ~ N(0, 1/din), B = 0 (the delta starts at zero).
    Draws on the CPU from ``generator`` and moves each factor to its
    weight's device."""
    def make(path, w):
        if not _is_target(path, peft.lora_targets) or w.dim() < 2:
            return None
        *lead, din, dout = w.shape
        r = peft.lora_rank
        a = torch.randn(*lead, din, r, generator=generator) * din ** -0.5
        b = torch.zeros(*lead, r, dout)
        if lead:
            n = lead[0]
            on = (torch.arange(n) >= n - peft.lora_layers if peft.lora_layers
                  else torch.ones(n, dtype=torch.bool))
            mask = on.reshape(n, 1, 1)
        else:
            mask = torch.ones(())
        return {k: t.to(device=w.device, dtype=w.dtype)
                for k, t in (("a", a), ("b", b), ("mask", mask))}

    return trees.map_with_path(make, params)


def _is_lora_leaf(x) -> bool:
    return isinstance(x, dict) and "a" in x


def merge_factors(params, lora, scale: float):
    """Dense-merge ``W + scale·mask·(A·B)`` over a (sub)tree pair — the
    merged parity oracle."""
    if lora is None:
        return params
    if _is_lora_leaf(lora):
        return params + scale * lora["mask"] * (lora["a"] @ lora["b"])
    if isinstance(params, dict):
        return {k: merge_factors(v, lora.get(k), scale) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(merge_factors(p, l, scale) for p, l in zip(params, lora))
    return params


def apply_lora(params, lora, peft: PEFTConfig):
    """Materialize W + (α/r)·mask·(A·B) for targeted leaves (merged oracle;
    serving threads the factors through ``lora_proj`` instead)."""
    return merge_factors(params, lora, lora_scale(peft))


def lora_proj(x, w, lf, *, scale: float):
    """Factored projection ``y = x@W + scale·((x@A)@(mask·B))`` through the
    ``lora_fused`` kernel; ``lf`` None (no factors) → plain ``x@w``.  The
    per-layer enable mask (shape (1, 1) once the layer loop has sliced the
    (repeats, 1, 1) leaf) is folded into B outside the kernel's autograd
    Function and detached, as the JAX package's ``stop_gradient``."""
    if lf is None or lf.get("a") is None:
        return x @ w
    b = lf["b"] * lf["mask"].detach().to(lf["b"].dtype)   # stop-gradient
    return lora_matmul(x, w, lf["a"], b, scale=scale)


def adapter_fwd(x, ap):
    """Bottleneck adapter with residual: x + up(gelu(down(x))), tanh GELU
    as ``jax.nn.gelu``'s default."""
    return x + F.gelu(x @ ap["wd"], approximate="tanh") @ ap["wu"]


def init_adapters(generator: torch.Generator, params, cfg, peft: PEFTConfig):
    """A new params tree with an ``adapter`` {"wd" (r, d, a) ~ N(0, 1/d),
    "wu" (r, a, d) = 0} in every stacked layer of every stage (the base
    leaves are shared, not copied).  Draws on the CPU from ``generator``."""
    emb = params["embed"]
    stages = []
    for si, sp in enumerate(params["stages"]):
        r = cfg.stages[si].repeats
        layers = []
        for lp in sp["layers"]:
            wd = torch.randn(r, cfg.d_model, peft.adapter_dim,
                             generator=generator) * cfg.d_model ** -0.5
            wu = torch.zeros(r, peft.adapter_dim, cfg.d_model)
            layers.append(dict(lp, adapter={
                "wd": wd.to(device=emb.device, dtype=emb.dtype),
                "wu": wu.to(device=emb.device, dtype=emb.dtype)}))
        stages.append(dict(sp, layers=layers))
    return dict(params, stages=stages)


def is_adapter_path(path: str) -> bool:
    return "/adapter/" in path

