"""Federated aggregation operators (the port of ``repro.core.aggregation``).

* **Stacked** (the cohort engine): client trees carry a leading client axis
  on every leaf and outage/selection is a per-client weight vector —
  ``fedavg_stacked``, ``partial_fedavg_stacked``,
  ``masked_fedavg_stacked``, ``broadcast_merge_stacked``.
* **List** (for callers holding per-client trees, as the legacy
  per-client loop does): ``fedavg``, ``partial_fedavg``,
  ``masked_fedavg``.  They stack their inputs and call the stacked core,
  so both layers agree bit for bit.

The per-leaf weighted mean is one ``tensordot`` over the client axis in
f32, cast back to the leaf's dtype.  ``factored_fedavg_stacked``
aggregates LoRA factor pairs by the SVD re-projection of
``comms.factored_agg``.

Every stacked operator takes ``mesh=`` (a ``sharding.ClientMesh``; the JAX
package's ``axis_names=``): the client axis is then sharded over the
ranks, each holding its rows.  The weights are normalised by their total
summed over the ranks, each rank's weighted partial sums are summed over
the ranks (one ``all_reduce`` for the whole tree), and every rank returns
the same global mean.  Zero-weight rows (outages, ghost padding) drop out
of numerator and denominator alike.  At world size 1 the arithmetic is
the unsharded one, bit for bit; at more ranks the partial sums
reassociate the f32 sum.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch import trees
from repro_torch.sharding import psum, psum_tree


def _client_weights(n: int, weights, device=None) -> torch.Tensor:
    """Normalized (n,) f32 weight vector; uniform when ``weights`` is None.
    Zero entries model outages; an all-zero vector is the caller's signal
    to keep the previous global (guarded, never a NaN)."""
    if weights is None:
        return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    return w / torch.clamp(w.sum(), min=1e-12)


def _weighted_mean(stacked_leaf, w):
    """(n, *S) leaf × (n,) weights → (*S), f32 accumulation, dtype kept."""
    out = torch.tensordot(w, stacked_leaf.float(), dims=1)
    return out.to(stacked_leaf.dtype)


def _pad_mask(m, ndim: int):
    """Right-pad a stacked (n, ...) mask with singleton dims so it
    broadcasts leading-aligned against a stacked leaf of rank ``ndim``."""
    return m.reshape(tuple(m.shape) + (1,) * (ndim - m.dim()))


def fedavg_stacked(stacked_tree, weights=None, *, mesh=None):
    """Weighted mean over the leading client axis of every leaf; under
    ``mesh`` over the rows of every rank (a replicated result)."""
    leaves = list(trees.flatten(stacked_tree).values())
    if not leaves:
        return stacked_tree
    n, dev = leaves[0].shape[0], leaves[0].device
    if mesh is None:
        w = _client_weights(n, weights, dev)
        return trees.map_leaves(lambda leaf: _weighted_mean(leaf, w), stacked_tree)
    w = (torch.ones(n, dtype=torch.float32, device=dev) if weights is None
         else torch.as_tensor(weights, dtype=torch.float32, device=dev))
    w = w / torch.clamp(psum(w.sum(), mesh), min=1e-12)
    means = psum_tree(trees.map_leaves(lambda leaf: torch.tensordot(w, leaf.float(), dims=1),
                                       stacked_tree), mesh)
    return trees.map_leaves(lambda m, leaf: m.to(leaf.dtype), means, stacked_tree)


def partial_fedavg_stacked(global_tree, stacked_tree,
                           pred: Callable[[str], bool], weights=None, *, mesh=None):
    """Aggregate only leaves whose path satisfies ``pred``; others keep the
    global value."""
    flat_avg = trees.flatten(fedavg_stacked(stacked_tree, weights, mesh=mesh))
    return trees.map_with_path(
        lambda p, g: flat_avg[p] if (pred(p) and p in flat_avg) else g,
        global_tree)


def masked_fedavg_stacked(global_tree, stacked_tree, stacked_masks,
                          weights=None, *, mesh=None):
    """Elementwise θ_g ← Σ_i w_i·m_i·θ_i / Σ_i w_i·m_i, keeping θ_g where the
    denominator is zero; masks are leading-aligned 1/0 float trees.  Under
    ``mesh`` the numerators and denominators are summed over the ranks
    before the divide, so the kept-global test reads the whole cohort's
    denominator."""
    n = next(iter(trees.flatten(stacked_tree).values())).shape[0]

    def parts(t, m):
        w = (torch.ones(n, dtype=torch.float32, device=t.device) if weights is None
             else torch.as_tensor(weights, dtype=torch.float32, device=t.device))
        wm = _pad_mask(w, t.dim()) * _pad_mask(m.float(), t.dim())
        return {"num": (wm * t.float()).sum(0),
                "den": torch.broadcast_to(wm, t.shape).sum(0)}

    def agg(g, s):
        num, den = s["num"], s["den"]
        avg = num / torch.where(den > 0, den, torch.ones_like(den))
        return torch.where(den > 0, avg, g.float()).to(g.dtype)

    if mesh is None:    # leaf by leaf: one leaf's sums alive at a time
        return trees.map_leaves(lambda g, t, m: agg(g, parts(t, m)), global_tree,
                                stacked_tree, stacked_masks)
    sums = psum_tree(trees.map_leaves(parts, stacked_tree, stacked_masks), mesh)
    return _map_sums(agg, global_tree, sums)


def _map_sums(fn, tree, sums):
    """``fn(leaf, {"num", "den"})`` over ``tree``'s leaves, the sums tree
    holding a {"num", "den"} dict where ``tree`` holds a leaf."""
    if isinstance(tree, dict):
        return {k: _map_sums(fn, tree[k], sums[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_sums(fn, t, s) for t, s in zip(tree, sums))
    return None if tree is None else fn(tree, sums)


def factored_fedavg_stacked(stacked_tree, weights=None, *, mesh=None, rank=None):
    """LoRA-factor-aware weighted mean: every ``{'a','b'}`` sibling pair
    aggregates as the rank-r SVD re-projection of ``Σ ŵ_i A_i·B_i``
    (``comms.factored_agg``: avg(A·B) ≠ avg(A)·avg(B), and the dense mean
    update is never formed); every other leaf as ``fedavg_stacked``.
    Under ``mesh`` the factor rows are gathered first (rank-r tiny)."""
    from repro_torch.comms.factored_agg import factored_fedavg_tree
    return factored_fedavg_tree(stacked_tree, weights, mesh=mesh, rank=rank)


def broadcast_merge_stacked(stacked_tree, global_tree, stacked_masks=None,
                            gate=None):
    """Each client resumes from the global value on its masked entries
    (``m > 0``; every entry with no masks), keeping local values elsewhere;
    a falsy ``gate`` (e.g. "no client survived the uplink") makes it a
    no-op."""
    def put(loc, glob, m=None):
        bc = torch.broadcast_to(glob[None].to(loc.dtype), loc.shape)
        out = bc if m is None else torch.where(
            torch.broadcast_to(_pad_mask(m, loc.dim()), loc.shape) > 0, bc, loc)
        if gate is not None:
            out = torch.where(torch.as_tensor(gate, device=loc.device), out, loc)
        return out

    if stacked_masks is None:
        return trees.map_leaves(put, stacked_tree, global_tree)
    return trees.map_leaves(put, stacked_tree, global_tree, stacked_masks)


def fedavg(client_trees: Sequence, weights: Optional[Sequence[float]] = None):
    return fedavg_stacked(trees.stack(client_trees), weights)


def partial_fedavg(global_tree, client_trees: Sequence, pred: Callable[[str], bool],
                   weights: Optional[Sequence[float]] = None):
    """Aggregate only leaves whose path satisfies ``pred``; others keep the
    global value."""
    return partial_fedavg_stacked(global_tree, trees.stack(client_trees), pred, weights)


def masked_fedavg(global_tree, client_trees: Sequence, masks: Sequence):
    """Elementwise θ_g ← Σ_i m_i·θ_i / Σ_i m_i, keeping θ_g where Σm = 0.
    ``masks`` are 1/0 float trees broadcast trailing-aligned against each
    client's leaves (numpy rules) before stacking, so any mask rank that
    broadcasts is taken; the stacked API takes leading-aligned (n, ...)
    masks instead."""
    bmasks = [trees.map_leaves(lambda m, t: torch.broadcast_to(m, t.shape), m, t)
              for m, t in zip(masks, client_trees)]
    return masked_fedavg_stacked(global_tree, trees.stack(client_trees), trees.stack(bmasks))
