"""Mixture-of-Experts feed-forward on one device (the port of
``repro.models.moe``'s ``moe_ffn`` with ``_local_moe``'s body).

Token-choice top-k routing: a softmax router in f32, the top-k experts of
each token with their weights renormalised, then a sort-based dispatch
table — the (token, slot) pairs sorted stably by expert, each pair's
position within its expert from ``searchsorted`` starts, pairs at
positions ≥ the capacity C dropped — a gather of each expert's C tokens,
the expert FFNs as batched products over (E, C, d), and a scatter-add of
the weighted outputs back to the tokens.  C is T·k while T·k ≤ 4096
(dropless: decode and small batches), else capacity-factor dropping.  The
Switch load-balance loss E·Σ_e frac_routed_e·mean_prob_e comes back beside
the output.  Shared (always-on) experts are a dense MLP of width
n_shared·f.  The JAX package's ``shard_map`` over a model axis and its
all-to-all variant (``moe_ffn_a2a``) are multi-device (ROADMAP queue 1
item 8); on one device the expert axis is whole.
"""
from __future__ import annotations

import torch

from repro_torch.models.mlp import act_fn, mlp


def _capacity(n_tokens: int, cfg) -> int:
    tk = n_tokens * cfg.top_k
    if tk <= 4096:
        return tk  # dropless for small batches (decode / smoke)
    c = int(tk * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def route(xt, router, cfg):
    """xt (T, d) → (gates (T, E) f32, w (T, k) renormalised, idx (T, k))."""
    gates = torch.softmax(xt.float() @ router.float(), dim=-1)
    w, idx = torch.topk(gates, cfg.top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return gates, w, idx


def dispatch(idx, w, n_experts: int, capacity: int):
    """Sort-based dispatch of the (T, k) choices → (table (E, C) of token
    ids, T in an empty slot; wtab (E, C) f32 weights, 0 in an empty slot).
    A choice at position ≥ C within its expert is dropped."""
    t, k = idx.shape
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(n_experts, device=idx.device))
    pos = torch.arange(t * k, device=idx.device) - starts[sorted_e]
    ok = pos < capacity
    table = torch.full((n_experts, capacity), t, dtype=torch.long, device=idx.device)
    wtab = torch.zeros((n_experts, capacity), dtype=torch.float32, device=idx.device)
    table[sorted_e[ok], pos[ok]] = order[ok] // k
    wtab[sorted_e[ok], pos[ok]] = w.reshape(-1)[order[ok]]
    return table, wtab


def moe_ffn(x, params, cfg, act: str):
    """x: (B, S, d) → (y (B, S, d), aux f32 scalar).  ``params``: router
    (d, E) f32, wg/wu (E, d, f), wd (E, f, d), and ``shared`` (a dense MLP)
    with shared experts."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    gates, w, idx = route(xt, params["router"], cfg)
    table, wtab = dispatch(idx, w, cfg.n_experts, _capacity(t, cfg))
    xe = torch.cat([xt, xt.new_zeros(1, d)])[table]              # (E, C, d)
    if act in ("swiglu", "geglu"):
        h = act_fn(act)(torch.einsum("ecd,edf->ecf", xe, params["wg"])) * \
            torch.einsum("ecd,edf->ecf", xe, params["wu"])
    else:
        h = act_fn(act)(torch.einsum("ecd,edf->ecf", xe, params["wu"]))
    ye = torch.einsum("ecf,efd->ecd", h, params["wd"])
    ye = (ye.float() * wtab[..., None]).to(x.dtype)
    y = x.new_zeros(t + 1, d).index_add(0, table.reshape(-1), ye.reshape(-1, d))[:t]
    # Switch-style load-balance auxiliary loss
    frac_routed = torch.zeros(cfg.n_experts, dtype=torch.float32, device=x.device)
    frac_routed = frac_routed.index_add(
        0, idx.reshape(-1), torch.ones(t * cfg.top_k, device=x.device)) / (t * cfg.top_k)
    aux = cfg.n_experts * torch.sum(frac_routed * gates.mean(0))
    y = y.reshape(b, s, d)
    if cfg.n_shared_experts > 0:
        y = y + mlp(x, params["shared"], act)
    return y, aux


def init_moe(normal, d_model: int, cfg, act: str, lead=()):
    """The MoE params at the JAX package's shapes and scales, each leaf with
    the leading axes ``lead``; ``normal(shape, std)`` draws in the model
    dtype.  The router stays f32 whatever the model dtype."""
    e, f = cfg.n_experts, cfg.d_ff
    std_in, std_out = d_model ** -0.5, f ** -0.5
    p = {"router": normal((*lead, d_model, e), std_in).float(),
         "wg": normal((*lead, e, d_model, f), std_in),
         "wu": normal((*lead, e, d_model, f), std_in),
         "wd": normal((*lead, e, f, d_model), std_out)}
    if cfg.n_shared_experts > 0:
        fs = cfg.n_shared_experts * f
        p["shared"] = {"wu": normal((*lead, d_model, fs), std_in),
                       "wd": normal((*lead, fs, d_model), fs ** -0.5)}
        if act in ("swiglu", "geglu"):
            p["shared"]["wg"] = normal((*lead, d_model, fs), std_in)
    return p
