"""LoRA and bottleneck adapters (the port of ``repro.models.peft``).

LoRA factors mirror targeted weight leaves: ``W (…, din, dout)`` →
``A (…, din, r)``, ``B (…, r, dout)`` and a per-repeat enable ``mask``
``(repeats, 1, 1)``.  Serving and training keep them UNMERGED: every
targeted projection runs ``y = x@W + (α/r)·(x@A)@(mask·B)`` through the
fused ``lora_fused`` kernel (``lora_proj``), so the shared base is never
re-materialized per client; the mask carries no gradient.
``apply_lora`` (merge ``W + (α/r)·mask·A·B`` and run the plain forward) is
kept as the merged parity oracle: ``PFTTConfig``/``PFITConfig(factored=
False)`` and the step builders' ``factored=False`` run it.  PFTT's
universal adapters (``init_adapters``) are bottleneck modules with a
residual, inserted in every layer.  PFIT's gradient masks (``last_k_layers_mask``,
``head_sparsity_mask``, ``apply_grad_mask``) are trees of f32 tensors in
broadcast shapes: (repeats, 1, …) over a stacked layer leaf, (1, …, h·hd)
over a head-structured projection, a scalar elsewhere.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
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


def is_lora_leaf(x) -> bool:
    """A {'a','b','mask'} factor dict, or ``None`` (the leaf test of a
    factor tree, as the JAX package's ``is_leaf`` predicate)."""
    return x is None or (isinstance(x, dict) and "a" in x)


def has_factors(lf) -> bool:
    """True if a factor (sub)tree holds any actual {'a','b'} leaf — a real
    side channel, not the all-``None`` mirror ``init_lora`` leaves on
    untargeted weights."""
    if lf is None:
        return False
    if isinstance(lf, dict) and "a" in lf:
        return lf["a"] is not None
    if isinstance(lf, dict):
        return any(has_factors(v) for v in lf.values())
    if isinstance(lf, (list, tuple)):
        return any(has_factors(v) for v in lf)
    return False


# Dense-merge accounting: every merge of a present factor leaf bumps this
# counter, so tests and the arch-matrix launcher can assert that the
# factored hot path never fell back to materializing ``W + s·A·B`` (the
# JAX package counts at trace time; here every eager merge counts).
_DENSE_MERGE_COUNT = [0]


def dense_merge_count() -> int:
    """Number of factor-leaf dense merges so far (process-global)."""
    return _DENSE_MERGE_COUNT[0]


def merge_factors(params, lora, scale: float):
    """Dense-merge ``W + scale·mask·(A·B)`` over a (sub)tree pair — the
    merged parity oracle, and the MoE expert FFN's per-layer merge (its
    batched expert products take no factors).  The mask carries no
    gradient, as the JAX package's ``stop_gradient``."""
    if lora is None:
        return params
    if is_lora_leaf(lora):
        _DENSE_MERGE_COUNT[0] += 1
        return params + scale * lora["mask"].detach() * (lora["a"] @ lora["b"])
    if isinstance(params, dict):
        return {k: merge_factors(v, lora.get(k), scale) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(merge_factors(p, l, scale) for p, l in zip(params, lora))
    return params


def effective_weight(w, lf, scale: float):
    """ONE leaf's factors merged into its base weight, ``W + scale·(A·(mask·
    B))``, for a contraction that consumes the weight itself instead of
    projecting activations through it (absorbed-MLA decode contracts q and
    the context against ``wkv_b``).  That matrix lives in the latent space
    (kv_lora_rank × heads·dims, the order of the factor's own B), so it is
    not a dense-merge fallback and ``dense_merge_count`` does not move.  The
    mask carries no gradient."""
    if lf is None or lf.get("a") is None:
        return w
    b = lf["b"] * lf["mask"].detach().to(lf["b"].dtype)
    return w + scale * (lf["a"] @ b)


def apply_lora(params, lora, peft: PEFTConfig):
    """Materialize W + (α/r)·mask·(A·B) for targeted leaves (merged oracle;
    serving threads the factors through ``lora_proj`` instead)."""
    return merge_factors(params, lora, lora_scale(peft))


def merge_lora(params, lora, peft: PEFTConfig):
    """Permanent merge (the legacy serving path, ``PFITConfig(factored=
    False)``'s evaluation); factored serving threads the tree instead."""
    return apply_lora(params, lora, peft)


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


@dataclasses.dataclass(frozen=True)
class LoraProj:
    """A frozen base weight with optional rank-r factors; calling it runs
    ``lora_proj`` (the kernel on the card)."""
    w: object
    lf: Optional[dict] = None
    scale: float = 1.0

    def __call__(self, x):
        return lora_proj(x, self.w, self.lf, scale=self.scale)


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


def strip_adapters(params):
    """The params tree without the ``adapter`` entry of any layer."""
    return dict(params, stages=[
        dict(sp, layers=[{k: v for k, v in lp.items() if k != "adapter"}
                         for lp in sp["layers"]])
        for sp in params["stages"]])


def is_adapter_path(path: str) -> bool:
    return "/adapter/" in path


def is_lora_path(path: str) -> bool:
    """Within a LoRA tree every path is LoRA."""
    return True


def last_k_layers_mask(params, cfg, k: int):
    """Gradient mask: 1.0 on the last ``k`` repeats of the last decoder
    stage (the last stage of an encoder) and on the final norm and the
    heads (``cls_head``, ``value_head``, ``reward_head``), 0.0 elsewhere —
    PFIT's "train only the last two layers"."""
    decoder = [si for si, s in enumerate(cfg.stages) if s.stream == "decoder"]
    last_si = max(decoder) if decoder else len(cfg.stages) - 1
    r = cfg.stages[last_si].repeats
    lo = max(0, r - k)
    device = _device_of(params)

    def mk(path, v):
        if path.startswith(f"stages/{last_si}/layers/"):
            lm = (torch.arange(r, device=device) >= lo).float()
            return lm.reshape((r,) + (1,) * (v.dim() - 1))
        one = path.startswith(("final_norm", "cls_head", "value_head", "reward_head"))
        return torch.tensor(float(one), device=device)

    return trees.map_with_path(mk, params)


def head_sparsity_mask(params, cfg, sparsity: float, seed: int,
                       keep: Optional[Sequence[int]] = None):
    """The paper's sparse-attention communication mask: a ``sparsity``
    fraction of the attention heads' q/o parameters (and k/v under MHA) is
    zeroed, head by head, so it is neither trained nor uploaded.  The kept
    heads are ``keep`` when given (parity runs pass the JAX package's
    ``permutation(PRNGKey(seed))`` draw), else the first ``round(h·(1 −
    sparsity))`` of a ``torch.randperm`` from a CPU generator seeded with
    ``seed`` (deterministic per client)."""
    h, hd = cfg.n_heads, cfg.hd
    device = _device_of(params)
    if h == 0:
        return trees.map_with_path(lambda p, v: torch.ones((), device=device), params)
    n_keep = max(1, int(round(h * (1.0 - sparsity))))
    if keep is None:
        keep = torch.randperm(h, generator=torch.Generator().manual_seed(seed))[:n_keep]
    keep = torch.tensor(np.asarray(keep), dtype=torch.long)
    if keep.numel() != n_keep:
        raise ValueError(f"head_sparsity_mask: {keep.numel()} kept heads, "
                         f"sparsity {sparsity} of {h} keeps {n_keep}")
    on = torch.zeros(h).index_fill_(0, keep, 1.0)
    per_dim = on.repeat_interleave(hd).to(device)          # (h·hd,)

    def mk(path, v):
        if re.search(r"mixer/w[qkv]$", path) and v.shape[-1] == h * hd:
            # wq always; wk/wv only under MHA, where kv heads are q heads
            return per_dim.reshape((1,) * (v.dim() - 1) + (h * hd,))
        if re.search(r"mixer/wo$", path) and v.shape[-2] == h * hd:
            return per_dim.reshape((1,) * (v.dim() - 2) + (h * hd, 1))
        return torch.ones((), device=device)

    return trees.map_with_path(mk, params)


def apply_grad_mask(grads, *masks):
    """Multiply each gradient leaf by every mask's (broadcast) leaf; a
    ``None`` gradient (a leaf the loss does not reach) stays ``None``."""
    out = grads
    for m in masks:
        out = trees.map_leaves(lambda g, mm: g * mm.to(g.dtype), out, m)
    return out


def _device_of(tree):
    return next(iter(trees.flatten(tree).values())).device
