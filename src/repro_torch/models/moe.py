"""Mixture-of-Experts feed-forward (the port of ``repro.models.moe``:
``moe_ffn`` with ``_local_moe``'s body, and ``moe_ffn_a2a``).

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
n_shared·f.  Tables are filled through a sentinel row and column (as
JAX's ``mode="drop"``), so every shape is static and the dry run traces
them on ``meta`` tensors.

Under a (data, model) mesh (``tp``, the layer's plan) the experts are
sharded over the model axis: each rank routes its batch rows' tokens, runs
its E/M experts over them and one sum over the model axis combines the
experts' contributions (the balance loss is the data shard's, averaged
over the data ranks by the loss).  At decode (S = 1) the tokens of every
data rank are gathered and the expert FFN's f dimension is split over the
data axes too (JAX's 2-D expert layout), the partial sums folded into the
same all_reduce.  ``moe_ffn_a2a`` shards the tokens over the sequence too
and moves only the routed ones to their experts' ranks and back by two
all-to-alls (each an all_reduce of an (M, M, c, d) buffer).
"""
from __future__ import annotations

import torch

from repro_torch.models.mlp import act_fn, mlp
from repro_torch.sharding import (all_reduce, all_to_all, copy_to, gather,
                                  reduce_from, scatter)


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


def dispatch(idx, w, n_experts: int, capacity: int, e0: int = 0, e_loc=None):
    """Sort-based dispatch of the (T, k) choices to experts [e0, e0 + e_loc)
    (all by default) → (table (e_loc, C) of token ids, T in an empty slot;
    wtab (e_loc, C) f32 weights, 0 in an empty slot).  A choice at position
    ≥ C within its expert, or to another expert, is dropped."""
    e_loc = n_experts if e_loc is None else e_loc
    t, k = idx.shape
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(n_experts, device=idx.device))
    pos = torch.arange(t * k, device=idx.device) - starts[sorted_e]
    le = sorted_e - e0
    ok = (pos < capacity) & (le >= 0) & (le < e_loc)
    le = torch.where(ok, le, e_loc)
    pc = torch.where(ok, pos, capacity)
    table = torch.full((e_loc + 1, capacity + 1), t, dtype=torch.long, device=idx.device)
    wtab = torch.zeros((e_loc + 1, capacity + 1), dtype=torch.float32, device=idx.device)
    table[le, pc] = order // k
    wtab = wtab.index_put((le, pc), w.reshape(-1)[order].float())
    return table[:e_loc, :capacity], wtab[:e_loc, :capacity]


def _experts(xe, wg, wu, wd, act: str):
    """The expert FFNs over (E, C, d) → (E, C, d)."""
    if act in ("swiglu", "geglu"):
        h = act_fn(act)(torch.einsum("ecd,edf->ecf", xe, wg)) * \
            torch.einsum("ecd,edf->ecf", xe, wu)
    else:
        h = act_fn(act)(torch.einsum("ecd,edf->ecf", xe, wu))
    return torch.einsum("ecf,efd->ecd", h, wd)


def _local_moe(xt, w, idx, params, cfg, act: str, e0: int, e_loc: int, capacity: int):
    """Experts [e0, e0 + e_loc) (``params``' slabs) over the tokens xt
    (T, d) → their weighted contributions (T, d)."""
    t, d = xt.shape
    table, wtab = dispatch(idx, w, cfg.n_experts, capacity, e0, e_loc)
    xe = torch.cat([xt, xt.new_zeros(1, d)])[table]              # (E, C, d)
    ye = _experts(xe, params.get("wg"), params["wu"], params["wd"], act)
    ye = (ye.float() * wtab[..., None]).to(xt.dtype)
    return xt.new_zeros(t + 1, d).index_add(0, table.reshape(-1), ye.reshape(-1, d))[:t]


def _balance(gates, idx, cfg):
    """Switch-style load-balance auxiliary loss of these tokens."""
    t = gates.shape[0]
    frac_routed = torch.zeros(cfg.n_experts, dtype=torch.float32, device=gates.device)
    frac_routed = frac_routed.index_add(
        0, idx.reshape(-1), torch.ones(t * cfg.top_k, device=gates.device)) / (t * cfg.top_k)
    return cfg.n_experts * torch.sum(frac_routed * gates.mean(0))


def _shared(x, y, params, cfg, act, tp):
    if cfg.n_shared_experts > 0:
        y = y + mlp(x, params["shared"], act,
                    mc=tp.mc if tp is not None and tp.shared else None)
    return y


def moe_ffn(x, params, cfg, act: str, tp=None):
    """x: (B, S, d) → (y (B, S, d), aux f32 scalar).  ``params``: router
    (d, E) f32, wg/wu (E, d, f), wd (E, f, d) — this rank's E/M experts
    under an expert-parallel plan ``tp`` — and ``shared`` (a dense MLP)
    with shared experts."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    if tp is None or not tp.moe:
        gates, w, idx = route(xt, params["router"], cfg)
        y = _local_moe(xt, w, idx, params, cfg, act, 0, cfg.n_experts, _capacity(t, cfg))
        return _shared(x, y.reshape(b, s, d), params, cfg, act, tp), _balance(gates, idx, cfg)
    mc, m = tp.mc, tp.model
    e_loc = cfg.n_experts // mc.model_size
    e0 = mc.coord(m) * e_loc
    if s > 1:
        gates, w, idx = route(xt, params["router"], cfg)
        y = _local_moe(copy_to(xt, mc, m), copy_to(w, mc, m), idx, params, cfg, act, e0,
                       e_loc, _capacity(t, cfg))
        y = reduce_from(y, mc, m)
        return _shared(x, y.reshape(b, s, d), params, cfg, act, tp), _balance(gates, idx, cfg)
    # decode: every data rank's tokens, the experts' f split over the data axes
    batch = mc.batch_axes
    xa = gather(xt, mc, batch, 0, sum_grad=False) if tp.rows else xt
    gates, w, idx = route(xa, params["router"], cfg)
    n_d = mc.extent(batch)
    p = params
    split_f = n_d > 1 and cfg.d_ff % n_d == 0
    if split_f:
        f = cfg.d_ff // n_d
        c = mc.coord(batch)
        p = {"wu": params["wu"][..., c * f:(c + 1) * f],
             "wd": params["wd"][:, c * f:(c + 1) * f]}
        if "wg" in params:
            p["wg"] = params["wg"][..., c * f:(c + 1) * f]
    y = _local_moe(xa, w, idx, p, cfg, act, e0, e_loc, _capacity(xa.shape[0], cfg))
    y = all_reduce(y, mc, (m,) + (tuple(batch) if split_f else ()))
    if tp.rows:
        y = y[mc.coord(batch) * t:(mc.coord(batch) + 1) * t]
    return _shared(x, y.reshape(b, s, d), params, cfg, act, tp), _balance(gates, idx, cfg)


# ---------------------------------------------------------------------------
# All-to-all dispatch expert parallelism
# ---------------------------------------------------------------------------


def _bucket_table(bucket_ids, n_buckets: int, capacity: int):
    """Sort-based dispatch: bucket_ids (N,) → table (n_buckets, capacity) of
    indices into N (N in an empty or overflowing slot)."""
    n = bucket_ids.shape[0]
    dev = bucket_ids.device
    order = torch.argsort(bucket_ids, stable=True)
    sorted_b = bucket_ids[order]
    starts = torch.searchsorted(sorted_b, torch.arange(n_buckets, device=dev))
    pos = torch.arange(n, device=dev) - starts[sorted_b.clamp(max=n_buckets - 1)]
    ok = (pos < capacity) & (sorted_b >= 0) & (sorted_b < n_buckets)
    bi = torch.where(ok, sorted_b, n_buckets)
    pi = torch.where(ok, pos, capacity)
    table = torch.full((n_buckets + 1, capacity + 1), n, dtype=torch.long, device=dev)
    table[bi, pi] = order
    return table[:n_buckets, :capacity]


def moe_ffn_a2a(x, params, cfg, act: str, tp=None):
    """All-to-all expert parallelism (``repro.models.moe.moe_ffn_a2a``):
    this rank takes its block of the sequence (tokens over data and model),
    sends each routed token to the rank of its expert (capacity c_out a
    destination, 1.5× over-provisioned), runs its E/M experts over what it
    received (a second, local dispatch), and sends the outputs back; the
    balance loss is averaged over the model ranks.  Falls back to
    ``moe_ffn`` where JAX's does (no model axis, E or S not dividing it)."""
    mc = None if tp is None else tp.mc
    if (mc is None or not tp.moe or mc.model_size <= 1 or cfg.n_experts % mc.model_size
            or x.shape[1] % mc.model_size):
        return moe_ffn(x, params, cfg, act, tp)
    m, n_model = tp.model, mc.model_size
    k = cfg.top_k
    e_loc = cfg.n_experts // n_model
    xs = scatter(x, mc, m, 1)
    b, s, d = xs.shape
    t = b * s
    xt = xs.reshape(t, d)
    gates, w, idx = route(xt, copy_to(params["router"], mc, m), cfg)
    flat_e, flat_w = idx.reshape(-1), w.reshape(-1)
    c_out = max(8, -(-int(t * k / n_model * 1.5) // 8) * 8)
    table = _bucket_table(flat_e // e_loc, n_model, c_out)         # (M, c_out)
    slot_ok = table < t * k
    tcl = table.clamp(max=t * k)
    tok = torch.where(slot_ok, table // k, t)
    send_x = torch.cat([xt, xt.new_zeros(1, d)])[tok]               # (M, c_out, d)
    epad = torch.cat([flat_e, flat_e.new_zeros(1)])
    wpad = torch.cat([flat_w, flat_w.new_zeros(1)])
    send_e = torch.where(slot_ok, epad[tcl] % e_loc, e_loc)
    send_w = torch.where(slot_ok, wpad[tcl], 0.0)
    recv_x = all_to_all(send_x, mc, m)
    recv_e = all_to_all(send_e, mc, m)
    recv_w = all_to_all(send_w, mc, m)
    n_recv = n_model * c_out
    rx, re_, rw = recv_x.reshape(n_recv, d), recv_e.reshape(n_recv), recv_w.reshape(n_recv)
    c2 = min(max(8, -(-int(n_recv / max(e_loc, 1)) // 8) * 8), n_recv)
    table2 = _bucket_table(re_, e_loc, c2)                           # (E_loc, c2)
    ok2 = table2 < n_recv
    t2 = table2.clamp(max=n_recv)
    xe = torch.cat([rx, rx.new_zeros(1, d)])[t2] * ok2[..., None].to(rx.dtype)
    ye = _experts(xe, params.get("wg"), params["wu"], params["wd"], act)
    wtab = torch.where(ok2, torch.cat([rw, rw.new_zeros(1)])[t2], 0.0)
    ye = (ye.float() * wtab[..., None]).to(x.dtype)
    back = x.new_zeros(n_recv + 1, d).index_add(0, t2.reshape(-1),
                                                ye.reshape(-1, d))[:n_recv]
    ret = all_to_all(back.reshape(n_model, c_out, d), mc, m)
    y = x.new_zeros(t + 1, d).index_add(0, tok.reshape(-1), ret.reshape(-1, d))[:t]
    aux = reduce_from(_balance(gates, idx, cfg), mc, m) / n_model
    y = gather(y.reshape(b, s, d), mc, m, 1, sum_grad=False)
    return _shared(x, y, params, cfg, act, tp), aux


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
