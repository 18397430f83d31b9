"""Training-health scalars of a federated round, the port of
``repro.obs.health`` (without the mesh: no client shards, so no partial
sums to reduce across them).

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

HEALTH_KEYS = ("update_norm", "client_norm_mean", "client_norm_max",
               "codec_err", "agg_weight_sum", "delivered", "loss_mean")


def _leaves(tree) -> list:
    return list(trees.flatten(tree).values())


def _leaf_sq(leaf):
    """Per-client sum of squares: reduce every axis but the client axis."""
    x = leaf.float()
    return (x * x).reshape(x.shape[0], -1).sum(1)


def cohort_health(send, ref, losses, agg_w, gate, *, train_m=None, raw=None,
                  decoded=None) -> Dict[str, torch.Tensor]:
    """All args are the round body's tensors: ``send``/``ref`` stacked client
    trees (axis 0 = cohort row), ``losses`` (C, steps), ``agg_w`` (C,),
    ``gate`` a 0-d bool or float tensor, ``raw``/``decoded`` the pre/post-
    codec upload trees (None without a codec)."""
    delta = trees.map_leaves(lambda s, r: s.float() - r.float(), send, ref)
    agg = fedavg_stacked(delta, agg_w)
    sq = torch.stack([l.float().square().sum() for l in _leaves(agg)]).sum()
    update_norm = torch.sqrt(sq) * gate.float()

    norms = torch.sqrt(torch.stack([_leaf_sq(l) for l in _leaves(delta)]).sum(0))
    client_norm_mean = norms.sum() / max(float(norms.shape[0]), 1.0)
    client_norm_max = norms.max()

    if raw is not None and decoded is not None:
        err_sq = torch.stack([(d.float() - r.float()).square().sum()
                              for d, r in zip(_leaves(decoded), _leaves(raw))]).sum()
        codec_err = torch.sqrt(err_sq)
    else:
        codec_err = torch.zeros((), dtype=torch.float32, device=agg_w.device)

    w = agg_w.float()
    tm = (torch.ones(losses.shape[0], dtype=torch.float32, device=losses.device)
          if train_m is None else train_m.float())
    n_steps = float(losses.shape[1]) if losses.dim() > 1 else 1.0
    loss_mean = losses.float().sum() / torch.clamp(tm.sum() * n_steps, min=1.0)

    return {"update_norm": update_norm,
            "client_norm_mean": client_norm_mean,
            "client_norm_max": client_norm_max,
            "codec_err": codec_err,
            "agg_weight_sum": w.sum(),
            "delivered": (w > 0).float().sum(),
            "loss_mean": loss_mean}


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
