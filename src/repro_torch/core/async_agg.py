"""Asynchronous aggregation with staleness discounting (paper §VI-1) and
the host-side int8 uplink (§VI-3): the port of
``repro.core.async_agg``'s ``StalenessWeightedAggregator``,
``quantize_update``, ``dequantize_update`` and ``quantized_bytes``.

A FedAsync-style server: client updates arrive with a round lag (an outage
→ retransmission next round) and each merges with weight
``α · (1+staleness)^(-a)``, so stale updates cannot drag the global model
backwards.  It is the oracle of the discount that
``core/robust.StalenessTracker`` folds into the cohort engine's
aggregation weights.

``quantize_update``/``dequantize_update`` are the legacy numpy int8 path
(symmetric, one scale per leaf, round to nearest); the cohort round runs
the codecs of ``repro_torch.comms`` instead.  ``FairSelector`` is the
proportional-fairness client selector (numpy, a copy of the JAX module's).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch import trees


@dataclasses.dataclass
class StalenessWeightedAggregator:
    """Server state for asynchronous FL: merge each arriving update with
    weight α·(1+staleness)^(-a); updates delayed by outages are buffered and
    merged when they arrive."""

    global_tree: object
    alpha: float = 0.6
    a: float = 0.5
    round: int = 0
    _pending: List = dataclasses.field(default_factory=list)

    def submit(self, client_tree, produced_round: int):
        self._pending.append((client_tree, produced_round))

    @torch.no_grad()
    def step(self):
        """Advance one server round, merging everything that has arrived.

        The arrivals merge in ONE pass: the global keeps weight
        ``Π(1-wᵢ)`` and the complement goes to the wᵢ-weighted mean of the
        arrivals (f32), permutation-invariant and identical to the pairwise
        merge when a single update arrives."""
        if self._pending:
            ws, cs = [], []
            for client_tree, produced in self._pending:
                staleness = max(0, self.round - produced)
                ws.append(self.alpha * (1.0 + staleness) ** (-self.a))
                cs.append(client_tree)
            keep = float(np.prod([1.0 - w for w in ws]))
            wsum = float(sum(ws))
            if wsum > 0:
                def merge(g, *leaves):
                    mean = sum(w * c.float() for w, c in zip(ws, leaves)) / wsum
                    return (keep * g.float() + (1.0 - keep) * mean).to(g.dtype)

                self.global_tree = trees.map_leaves(merge, self.global_tree, *cs)
        self._pending = []
        self.round += 1
        return self.global_tree


# ---------------------------------------------------------------------------
# Proportional-fairness client selection
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FairSelector:
    """Select K clients per round by proportional fairness:
    score_i = instantaneous_rate_i / mean_throughput_i.  Clients in deep
    fade are skipped but their average decays, raising future priority."""

    n_clients: int
    ewma: float = 0.9

    def __post_init__(self):
        self._avg = np.ones(self.n_clients)

    def select(self, rates: np.ndarray, k: int) -> List[int]:
        score = rates / np.maximum(self._avg, 1e-9)
        chosen = list(np.argsort(-score)[:k])
        served = np.zeros(self.n_clients)
        served[chosen] = rates[chosen]
        self._avg = self.ewma * self._avg + (1 - self.ewma) * served
        return chosen


# ---------------------------------------------------------------------------
# int8 uplink quantization (host side, numpy)
# ---------------------------------------------------------------------------


def quantize_update(tree):
    """Per-leaf symmetric int8 quantization → (q dict of numpy int8 by path,
    scales dict of floats by path)."""
    q, scales = {}, {}
    for path, leaf in trees.flatten(tree).items():
        x = leaf.detach().cpu().numpy().astype(np.float32)
        s = float(np.max(np.abs(x))) / 127.0 if x.size else 0.0
        scales[path] = s
        q[path] = (np.round(x / s).astype(np.int8) if s > 0
                   else np.zeros_like(x, np.int8))
    return q, scales


def dequantize_update(q: Dict, scales: Dict, template):
    """q · scale on each path of ``template`` that ``q`` holds, on the
    template leaf's device and dtype; other leaves are the template's."""
    def rebuild(path, leaf):
        if q.get(path) is None:
            return leaf
        return torch.from_numpy(q[path].astype(np.float32) * scales[path]).to(
            device=leaf.device, dtype=leaf.dtype)

    return trees.map_with_path(rebuild, template)


def quantized_bytes(q: Dict) -> int:
    """int8 payload bytes + one f32 scale per leaf that ships (``None``
    paths carry no scale on the wire)."""
    shipped = [v for v in q.values() if v is not None]
    return sum(v.size for v in shipped) + 4 * len(shipped)
