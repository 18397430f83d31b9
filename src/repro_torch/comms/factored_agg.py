"""Server-side LoRA factor aggregation without densification, the port of
``repro.comms.factored_agg``.

Averaging the factors elementwise is not the mean update:
``avg_i(A_i·B_i) ≠ avg_i(A_i)·avg_i(B_i)``.  ``svd_reproject`` computes the
best rank-r factorization of the weighted-mean update touching only
(d × n·r) matrices:

    Δ = Σ_i ŵ_i A_i B_i = L·R,   L = [√ŵ_i A_i]_i  (din, m),  m = n·r
                                  R = [√ŵ_i B_i]_i  (m, dout)
    L = Q_l S_l   (thin QR)        R^T = Q_r S_r    (thin QR)
    U Σ V^T = svd(S_l S_r^T)       (m × m)
    A' = Q_l U_r √Σ_r,  B' = √Σ_r V_r^T Q_r^T       (rank r)

so ``A'·B'`` is the rank-r truncated SVD of Δ and Δ never exists: O(d·m²)
work and O(d·m) memory.  QR and SVD are ``torch.linalg``'s (cuSOLVER on the
card).  The signs of an SVD are ambiguous, so only the product ``A'·B'``
is defined; the tests compare products.  ``factored_fedavg_tree`` applies
it to every ``{'a','b'}`` sibling pair of an uploaded tree (other leaves
get the plain weighted mean); ``core.aggregation.factored_fedavg_stacked``
dispatches to it.  Under a client mesh the factor rows and weights are
gathered from every rank first (``sharding.gather_clients``; factors are
rank-r tiny) and every rank computes the same re-projection.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import trees
from repro_torch.core.aggregation import fedavg_stacked
from repro_torch.sharding import gather_clients


def _normalized_weights(n: int, weights, device=None) -> torch.Tensor:
    if weights is None:
        return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    return w / torch.clamp(w.sum(), min=1e-12)


def svd_reproject(st_a, st_b, weights=None, rank: Optional[int] = None, *, mesh=None):
    """Stacked factors ``A (n, …, din, r)``, ``B (n, …, r, dout)`` and (n,)
    weights → rank-``rank`` (default r) factors ``(A', B')`` of the weighted
    mean update ``Σ ŵ_i A_i B_i``, batched over the leading dims (the
    layer-repeat axis).  Zero weights make L rank-deficient (fine); all-zero
    weights give a zero product, which the round's gate then discards.
    ``mesh``: every rank's rows are gathered first (replicated result)."""
    if mesh is not None:
        st_a, st_b = gather_clients(st_a, mesh), gather_clients(st_b, mesh)
        if weights is not None:
            weights = gather_clients(torch.as_tensor(weights, dtype=torch.float32,
                                                      device=st_a.device), mesh)
    n, r = st_a.shape[0], st_a.shape[-1]
    rank = r if rank is None else rank
    w = _normalized_weights(n, weights, st_a.device)
    sw = torch.sqrt(w).reshape((n,) + (1,) * (st_a.dim() - 1))
    a = st_a.float() * sw
    b = st_b.float() * sw
    # (n, …, din, r) → (…, din, n·r)  /  (n, …, r, dout) → (…, n·r, dout)
    l = a.movedim(0, -2)
    l = l.reshape(l.shape[:-3] + (l.shape[-3], n * r))
    rt = b.movedim(0, -3)
    rt = rt.reshape(rt.shape[:-3] + (n * r, rt.shape[-1]))
    ql, sl = torch.linalg.qr(l)                            # (…, din, m)
    qr_, sr_ = torch.linalg.qr(rt.transpose(-1, -2))       # (…, dout, m)
    u, s, vt = torch.linalg.svd(sl @ sr_.transpose(-1, -2), full_matrices=False)
    root = torch.sqrt(s[..., :rank])
    a_new = (ql @ u[..., :, :rank]) * root[..., None, :]
    b_new = (root[..., :, None] * vt[..., :rank, :]) @ qr_.transpose(-1, -2)
    return a_new.to(st_a.dtype), b_new.to(st_b.dtype)


def dense_rank_r_oracle(st_a, st_b, weights=None, rank: Optional[int] = None):
    """Parity oracle: the dense weighted-mean update, its SVD truncated to
    rank r, reconstructed.  O(d²): tests and the smoke run only, never the
    server path."""
    n, r = st_a.shape[0], st_a.shape[-1]
    rank = r if rank is None else rank
    w = _normalized_weights(n, weights, st_a.device)
    wr = w.reshape((n,) + (1,) * (st_a.dim() - 1))
    dense = torch.einsum("n...dr,n...rf->...df", st_a.float() * wr, st_b.float())
    u, s, vt = torch.linalg.svd(dense, full_matrices=False)
    return (u[..., :, :rank] * s[..., None, :rank]) @ vt[..., :rank, :]


def _factor_pairs(flat):
    """{'…/a': leaf} paths with a '…/b' sibling → [(base, path_a, path_b)]."""
    return [(p[:-2], p, p[:-2] + "/b") for p in flat
            if p.endswith("/a") and (p[:-2] + "/b") in flat]


def factored_fedavg_tree(stacked_tree, weights=None, *, mesh=None,
                         rank: Optional[int] = None):
    """Weighted mean of a stacked upload tree where every ``{'a','b'}``
    factor pair aggregates as ``svd_reproject`` and every other leaf as
    ``fedavg_stacked`` (both under ``mesh`` when given)."""
    avg = fedavg_stacked(stacked_tree, weights, mesh=mesh)
    flat = trees.flatten(stacked_tree)
    repl = {}
    for _, pa, pb in _factor_pairs(flat):
        repl[pa], repl[pb] = svd_reproject(flat[pa], flat[pb], weights, rank, mesh=mesh)
    if not repl:
        return avg
    return trees.map_with_path(lambda p, v: repl.get(p, v), avg)
