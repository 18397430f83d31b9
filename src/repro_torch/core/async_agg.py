"""Asynchronous aggregation with staleness discounting (paper §VI-1), the
port of ``repro.core.async_agg.StalenessWeightedAggregator``.

A FedAsync-style server: client updates arrive with a round lag (an outage
→ retransmission next round) and each merges with weight
``α · (1+staleness)^(-a)``, so stale updates cannot drag the global model
backwards.  It is the oracle of the discount that
``core/robust.StalenessTracker`` folds into the cohort engine's
aggregation weights.  The module's other parts are not ported yet
(ROADMAP queue 1: ``quantize_update`` with item 2, ``FairSelector`` with
item 4).
"""
from __future__ import annotations

import dataclasses
from typing import List

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
