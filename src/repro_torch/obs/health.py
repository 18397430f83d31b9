"""Training-health scalars of a federated round, the port of
``repro.obs.health``.

``cohort_health`` runs inside the supervised round bodies of
``core/cohort.py`` on tensors the body already holds — a handful of
reductions, no host synchronisation — and returns every value as a
0-dimensional f32 tensor on the round's device; the runner reads them once,
when it writes the round's telemetry event.  Keys (``HEALTH_KEYS``):

    update_norm       L2 norm of the aggregated global update — the
                      weighted FedAvg mean of per-client deltas (send −
                      round-start upload subtree), gated to 0 on a void
                      round.  Under ``factored_agg`` the plain stacked-mean
                      norm (a monitor of the raw update mass).
    client_norm_mean  mean over cohort rows of the per-client delta L2 norm
                      (the whole round's local update, not one step's
                      gradient).
    client_norm_max   max over cohort rows of the same norm.
    codec_err         L2 norm of (decoded − raw) upload across the cohort:
                      the codec's reconstruction error this round; 0 with
                      no codec.
    agg_weight_sum    Σ effective aggregation weights (staleness decay ×
                      on-time mask).
    delivered         count of cohort rows with weight > 0.
    loss_mean         mean local training loss over (client, local step),
                      divided by Σ train_m · steps (a non-training row's
                      losses are 0).

Under a client mesh (``mesh=``) every scalar is the whole cohort's: the
partial sums of all ranks go out in one ``all_reduce`` and the max in one
more, so every rank returns the same values.  ``ghost`` marks the rank's
ghost-padded rows, which the per-client scalars and the codec error leave
out (the JAX package's sharded body counts them; without ghosts the
scalars are those of the unsharded cohort).

``host_health`` is the float64 numpy oracle (a copy of the JAX package's,
over the port's nested-dict trees) the tests and the chip run hold it
against.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import trees
from repro_torch.core.aggregation import fedavg_stacked
from repro_torch.sharding import pmax, psum

HEALTH_KEYS = ("update_norm", "client_norm_mean", "client_norm_max",
               "codec_err", "agg_weight_sum", "delivered", "loss_mean")


def _leaves(tree) -> list:
    return list(trees.flatten(tree).values())


def _leaf_sq(leaf):
    """Per-client sum of squares: reduce every axis but the client axis."""
    x = leaf.float()
    return (x * x).reshape(x.shape[0], -1).sum(1)


def cohort_health(send, ref, losses, agg_w, gate, *, train_m=None, raw=None,
                  decoded=None, mesh=None, ghost=None) -> Dict[str, torch.Tensor]:
    """All args are the round body's tensors: ``send``/``ref`` stacked client
    trees (axis 0 = cohort row), ``losses`` (C, steps), ``agg_w`` (C,),
    ``gate`` a 0-d bool or float tensor, ``raw``/``decoded`` the pre/post-
    codec upload trees (None without a codec); ``mesh`` the client mesh
    (None: one process holds the cohort), ``ghost`` a (C,) bool of ghost
    rows (None: none)."""
    delta = trees.map_leaves(lambda s, r: s.float() - r.float(), send, ref)
    agg = fedavg_stacked(delta, agg_w, mesh=mesh)
    sq = torch.stack([l.float().square().sum() for l in _leaves(agg)]).sum()
    update_norm = torch.sqrt(sq) * gate.float()

    norms = torch.sqrt(torch.stack([_leaf_sq(l) for l in _leaves(delta)]).sum(0))
    real = (torch.ones_like(norms) if ghost is None
            else (~ghost.to(norms.device)).float())
    w = agg_w.float()
    tm = (torch.ones(losses.shape[0], dtype=torch.float32, device=losses.device)
          if train_m is None else train_m.float())
    err = torch.zeros((), dtype=torch.float32, device=agg_w.device)
    if raw is not None and decoded is not None:
        err = (real * torch.stack([(d.float() - r.float()).square().reshape(d.shape[0], -1).sum(1)
                                   for d, r in zip(_leaves(decoded), _leaves(raw))]).sum(0)).sum()
    n_steps = float(losses.shape[1]) if losses.dim() > 1 else 1.0
    # every partial sum of the cohort in one vector: one all_reduce
    part = torch.stack([(norms * real).sum(), real.sum(), err, w.sum(), (w > 0).float().sum(),
                        (losses.float().reshape(losses.shape[0], -1).sum(1) * real).sum(),
                        (tm * real).sum()])
    top = torch.where(real > 0, norms, torch.zeros_like(norms)).max()
    if mesh is not None:
        part, top = psum(part, mesh), pmax(top, mesh)
    return {"update_norm": update_norm,
            "client_norm_mean": part[0] / torch.clamp(part[1], min=1.0),
            "client_norm_max": top,
            "codec_err": torch.sqrt(part[2]),
            "agg_weight_sum": part[3],
            "delivered": part[4],
            "loss_mean": part[5] / torch.clamp(part[6] * n_steps, min=1.0)}


# ---------------------------------------------------------------------------
# float64 numpy oracle
# ---------------------------------------------------------------------------


def _np64(tree) -> list:
    return [np.asarray(l.detach().cpu().numpy() if isinstance(l, torch.Tensor) else l,
                       np.float64) for l in _leaves(tree)]


def _arr64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def host_health(send, ref, losses, agg_w, gate, *, train_m=None, raw=None,
                decoded=None) -> Dict[str, float]:
    """Numpy recomputation of ``cohort_health`` in float64 (tensors or numpy
    arrays as leaves)."""
    send_l, ref_l = _np64(send), _np64(ref)
    w = _arr64(agg_w)
    losses = _arr64(losses)
    deltas = [s - r for s, r in zip(send_l, ref_l)]

    wsum = max(w.sum(), 1e-12)
    sq = 0.0
    for d in deltas:
        mean = np.tensordot(w, d, axes=(0, 0)) / wsum
        sq += float(np.sum(mean * mean))
    update_norm = float(np.sqrt(sq)) * float(_arr64(gate))

    per_client = np.zeros(w.shape[0], np.float64)
    for d in deltas:
        per_client += d.reshape(d.shape[0], -1).__pow__(2).sum(axis=1)
    norms = np.sqrt(per_client)

    if raw is not None and decoded is not None:
        err = 0.0
        for dd, rr in zip(_np64(decoded), _np64(raw)):
            diff = dd - rr
            err += float(np.sum(diff * diff))
        codec_err = float(np.sqrt(err))
    else:
        codec_err = 0.0

    tm = np.ones(w.shape[0]) if train_m is None else _arr64(train_m)
    n_steps = float(losses.shape[1]) if losses.ndim > 1 else 1.0
    loss_mean = float(losses.sum()) / max(float(tm.sum()) * n_steps, 1.0)

    return {"update_norm": update_norm,
            "client_norm_mean": float(norms.mean()),
            "client_norm_max": float(norms.max()),
            "codec_err": codec_err,
            "agg_weight_sum": float(w.sum()),
            "delivered": float((w > 0).sum()),
            "loss_mean": loss_mean}
