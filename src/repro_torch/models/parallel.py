"""Tensor-parallel execution of one layer under a (data, model) mesh.

A model built with ``Model(cfg, meshctx=...)`` holds this rank's blocks of
its parameters under ``sharding.param_specs``.  The spec decides what is
stored; a per-layer plan (``layer_plan``) decides the compute, and where the
stored layout does not fit the plan the weight is gathered whole and the
sublayer runs replicated, which is exact:

* every dimension over the batch axes (FSDP) is gathered just before its
  layer (``layer_view``; under remat again in the backward); its gradient
  comes back summed over the data ranks (a reduce-scatter);
* attention whose heads divide the model axis (``attn``, ``local``,
  ``enc`` and ``dec``'s self-attention) is Megatron's: column-parallel
  ``wq``/``wk``/``wv`` (each rank its heads), ``flash_attn`` on the local
  heads, row-parallel ``wo`` and one sum over the model axis; LoRA factors
  (replicated) go with it, B's local columns for a column-parallel weight
  and A's local rows for a row-parallel one;
* the dense MLP is column-parallel ``wg``/``wu``, row-parallel ``wd``;
* MoE is expert-parallel (``moe.moe_ffn``'s local experts);
* everything else — MLA, mamba, the cross-attention, heads that do not
  divide — is gathered whole and runs replicated over the model axis.

Activations between layers are replicated over the model axis and hold
this rank's batch rows (Megatron's layout).  ``decode_segment`` is the
flash-decode over a cache whose sequence is split over ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.sharding import (MeshCtx, Spec, all_reduce, copy_to, gather,
                                  reduce_from, scatter, spec_axes)

ATTN_TP = ("attn", "local", "enc", "dec")

# Leaves a plan keeps as this rank's model block, with the dimension that
# holds it (counted in the layer's own leaf, without the repeat axis).
_ATTN_LOCAL = {"mixer/wq": -1, "mixer/wk": -1, "mixer/wv": -1, "mixer/wo": 0}
_MLP_LOCAL = {"ff/wg": -1, "ff/wu": -1, "ff/wd": 0}
_MOE_LOCAL = {"ff/wg": 0, "ff/wu": 0, "ff/wd": 0}
_SHARED_LOCAL = {"ff/shared/wg": -1, "ff/shared/wu": -1, "ff/shared/wd": 0}


@dataclasses.dataclass
class LayerTP:
    """One layer's plan: which sublayers run on this rank's model blocks,
    whether the activations hold this rank's batch rows (``rows``), and the
    mesh-only options in force (``mamba_sp``, ``moe_a2a``, training)."""

    mc: MeshCtx
    attn: bool = False
    mlp: bool = False
    moe: bool = False
    shared: bool = False
    rows: bool = False
    train: bool = False
    mamba_sp: bool = False
    moe_a2a: bool = False
    cache_specs: Optional[Dict[str, Spec]] = None

    @property
    def model(self) -> str:
        return self.mc.model_axis

    def local(self) -> Dict[str, int]:
        keep = {}
        if self.attn:
            keep.update(_ATTN_LOCAL)
        if self.mlp:
            keep.update(_MLP_LOCAL)
        if self.moe:
            keep.update(_MOE_LOCAL)
        if self.shared:
            keep.update(_SHARED_LOCAL)
        return keep


def layer_plan(mc: MeshCtx, cfg, kind, specs: Dict[str, Spec], *, sparse_kv=False,
               **flags) -> LayerTP:
    """The plan of one layer from its leaves' specs (``specs``: relative
    path → spec without the repeat axis)."""
    m, msize = mc.model_axis, mc.model_size

    def on(table):
        return all(p not in specs or specs[p][d] == m for p, d in table.items()) and \
            any(p in specs for p in table)

    attn = (kind.mixer in ATTN_TP and not sparse_kv and msize > 1
            and cfg.n_heads % msize == 0 and cfg.n_kv_heads % msize == 0
            and on(_ATTN_LOCAL))
    return LayerTP(mc=mc, attn=attn, mlp=kind.ff == "mlp" and msize > 1 and on(_MLP_LOCAL),
                   moe=kind.ff == "moe" and msize > 1 and on(_MOE_LOCAL),
                   shared=kind.ff == "moe" and msize > 1 and on(_SHARED_LOCAL), **flags)


def view_leaf(x, spec: Spec, mc: MeshCtx, keep_model: bool = False):
    """A stored block → the compute's layout: every batch-axes dimension
    gathered (gradient summed over the data ranks), a model dimension kept
    (``keep_model``) or gathered (the compute is replicated: gradient
    sliced)."""
    if spec is None:
        return x
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes or mc.extent(axes) <= 1:
            continue
        if axes == (mc.model_axis,):
            if not keep_model:
                x = gather(x, mc, axes, dim, sum_grad=False)
        else:
            x = gather(x, mc, axes, dim, sum_grad=mc.model_axis not in axes)
    return x


def layer_view(lp, specs: Dict[str, Spec], plan: LayerTP, prefix: str = ""):
    """One layer's parameter dict in the plan's layout."""
    keep = plan.local()
    if isinstance(lp, dict):
        return {k: layer_view(v, specs, plan, f"{prefix}/{k}" if prefix else k)
                for k, v in lp.items()}
    return view_leaf(lp, specs.get(prefix), plan.mc, prefix in keep)


# ---------------------------------------------------------------- factors
def col_factors(lf, mc: MeshCtx):
    """A column-parallel weight's LoRA factors: A whole (its gradient summed
    over the model ranks), B's local columns."""
    if lf is None or lf.get("a") is None:
        return lf
    m = mc.model_axis
    return dict(lf, a=copy_to(lf["a"], mc, m), b=scatter(lf["b"], mc, m, -1))


def row_factors(lf, mc: MeshCtx):
    """A row-parallel weight's factors: A's local rows, B whole (its
    gradient summed over the model ranks): Σ_r s·(x_r·A_r)·B = s·(x·A)·B."""
    if lf is None or lf.get("a") is None:
        return lf
    m = mc.model_axis
    return dict(lf, a=scatter(lf["a"], mc, m, -2), b=copy_to(lf["b"], mc, m))


def expert_factors(lf, mc: MeshCtx):
    """An expert slab's factors (E, …): this rank's experts."""
    if lf is None or lf.get("a") is None:
        return lf
    m = mc.model_axis
    return dict(lf, a=scatter(lf["a"], mc, m, 0), b=scatter(lf["b"], mc, m, 0))


def plan_factors(lora, plan: LayerTP):
    """A layer's factor subtree in its plan's layout (None stays None)."""
    if lora is None:
        return None
    mc = plan.mc
    mode = {}
    if plan.attn:
        mode.update({"mixer/wq": col_factors, "mixer/wk": col_factors,
                     "mixer/wv": col_factors, "mixer/wo": row_factors})
    if plan.mlp:
        mode.update({"ff/wg": col_factors, "ff/wu": col_factors, "ff/wd": row_factors})
    if plan.moe:
        mode.update({"ff/wg": expert_factors, "ff/wu": expert_factors,
                     "ff/wd": expert_factors})
    if plan.shared:
        mode.update({"ff/shared/wg": col_factors, "ff/shared/wu": col_factors,
                     "ff/shared/wd": row_factors})

    def walk(node, prefix):
        if node is None:
            return None
        if isinstance(node, dict) and "a" in node:
            fn = mode.get(prefix)
            return node if fn is None else fn(node, mc)
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k) for k, v in node.items()}
        return node

    return walk(lora, "")


# ------------------------------------------------------------ embeddings
def vocab_embed(table_loc, tokens, mc: MeshCtx):
    """A vocab-parallel embedding: this rank's rows of the table read its
    tokens (the others read zero), summed over the model axis."""
    v_loc = table_loc.shape[0]
    lab = tokens.long() - mc.coord(mc.model_axis) * v_loc
    inr = (lab >= 0) & (lab < v_loc)
    x = table_loc[lab.clamp(0, v_loc - 1)] * inr[..., None].to(table_loc.dtype)
    return reduce_from(x, mc, mc.model_axis)


def vocab_xent(hidden, head_loc, labels, mc: MeshCtx):
    """Cross-entropy terms (logz − logit of the label) of a vocab-parallel
    head: this rank's logit columns, the max and the sum of exponentials
    over the model axis, the label's logit from the rank that holds it."""
    m_ax = mc.model_axis
    logits = (copy_to(hidden, mc, m_ax) @ head_loc).float()
    v_loc = logits.shape[-1]
    mx = all_reduce(logits.detach().amax(-1), mc, m_ax, "MAX")
    se = reduce_from(torch.exp(logits - mx[..., None]).sum(-1), mc, m_ax)
    logz = mx + torch.log(se)
    lab = labels.long() - mc.coord(m_ax) * v_loc
    inr = (lab >= 0) & (lab < v_loc)
    ll = logits.gather(-1, lab.clamp(0, v_loc - 1)[..., None])[..., 0] * inr.float()
    return logz - reduce_from(ll, mc, m_ax)


# ----------------------------------------------------------- flash-decode
def decode_segment(q, kc, vc, n_total: int, mc: MeshCtx, seq_entry, *, sparse=None):
    """One query against a cache whose sequence is split over ``seq_entry``'s
    axes: this rank holds slots [base, base + S_loc) of a cache whose first
    ``n_total`` slots are valid (``n_total`` also the query's cache_len).
    Each rank reads its segment with its log-sum-exp (a rank with no valid
    slot skips the launch: lse −inf and a finite zero output, since
    NaN·0 = NaN would poison the sum), then the MAX and SUM all_reduces
    merge them (``attention.merge_by_lse`` over the group)."""
    from repro_torch.kernels.decode_attn.ops import decode_attention
    axes = spec_axes(seq_entry)
    s_loc = kc.shape[1]
    base = mc.coord(axes) * s_loc if axes else 0
    n = max(0, min(n_total - base, s_loc))
    if mc.extent(axes) <= 1:
        return decode_attention(q, kc, vc, n_total, sparse=sparse)
    b, _, h, _ = q.shape
    if n > 0:
        out, lse = decode_attention(q, kc, vc, n_total, offset=base, sparse=sparse,
                                    return_lse=True)
    else:
        out = torch.zeros_like(q)
        lse = torch.full((b, h), float("-inf"), dtype=torch.float32, device=q.device)
    mx = all_reduce(lse, mc, axes, "MAX")
    w = torch.exp(lse - mx)
    num = all_reduce(out.float() * w[:, None, :, None], mc, axes)
    den = all_reduce(w, mc, axes)
    return (num / den[:, None, :, None]).to(q.dtype)


def segment_write(buf, new, slot: int, mc: MeshCtx, seq_entry):
    """Write ``new`` (B, 1, …) at global ``slot`` of a sequence-split cache
    ``buf`` (B, S_loc, …) on the rank that owns it."""
    axes = spec_axes(seq_entry)
    s_loc = buf.shape[1]
    base = mc.coord(axes) * s_loc if axes else 0
    if base <= slot < base + s_loc:
        buf[:, slot - base] = new[:, 0]
