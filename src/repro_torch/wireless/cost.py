"""Communication-cost accounting (the paper's Figs. 4/5 right panels).

The port of ``repro.wireless.cost``: ``tree_bytes`` counts every
non-``None`` leaf of a tree of tensors at its element size (under an
optional upload mask), and ``CommLedger`` keeps the per-round, per-client upload record
(bytes, delay, energy, outages) the round loop feeds from
``comms.ChannelBudget``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch import trees


def tree_bytes(tree, *, nonzero_mask=None, itemsize=None):
    """Bytes of a tree payload: every tensor leaf's element count times its
    element size (``None`` leaves carry nothing).  ``nonzero_mask`` (a tree
    of the same leaves holding 1/0 masks in broadcast shapes): a leaf sends
    only its mask's share of its elements, ``round(numel · mean(mask))`` —
    the paper's sparse-attention upload.  The mean is numpy's over the mask
    as stored, as in the JAX package, so the byte counts agree exactly.
    ``itemsize`` overrides the bytes per element (quantized leaves are not
    their dtype's size): a number for every leaf, or a tree of the same
    leaves (``None`` or missing entries keep the leaf's own)."""
    flat = trees.flatten(tree)
    masks = {}
    if nonzero_mask is not None:
        masks = trees.flatten(nonzero_mask)
        if masks.keys() != flat.keys():
            raise ValueError("tree_bytes: nonzero_mask's leaves do not match the "
                             f"tree's: {sorted(masks.keys() ^ flat.keys())[:4]}")
    if itemsize is None:
        override = {}
    elif isinstance(itemsize, (int, float)):
        override = {p: float(itemsize) for p in flat}
    else:
        override = {p: float(v) for p, v in trees.flatten(itemsize).items()}
    total = 0.0
    for p, x in flat.items():
        frac = 1.0
        if p in masks:
            m = masks[p].detach().cpu().numpy()
            frac = float(m.mean()) if m.size else 1.0
        total += round(x.numel() * frac) * override.get(p, x.element_size())
    return int(total) if float(total).is_integer() else total


@dataclasses.dataclass
class CommLedger:
    """Per-round, per-client record of upload traffic, delay and energy."""
    rounds: List[Dict] = dataclasses.field(default_factory=list)

    def log_round(self, reports, extra=None, *, round_id=None):
        # an all-outage round has no completed upload: its delay is
        # undefined (NaN), not 0.0 — mean_round_delay skips it
        alive = [r.delay_s for r in reports if not r.outage]
        rec = {
            "record_id": len(self.rounds),
            "round": int(round_id) if round_id is not None
            else len(self.rounds),
            "bytes": sum(r.bytes_sent for r in reports),
            "delay_s": max(alive) if alive else float("nan"),
            "energy_j": sum(getattr(r, "energy_j", 0.0) for r in reports),
            "outages": sum(r.outage for r in reports),
            "per_client": [dataclasses.asdict(r) for r in reports],
        }
        if extra:
            rec.update(extra)
        self.rounds.append(rec)

    @property
    def total_bytes(self) -> float:
        return sum(r["bytes"] for r in self.rounds)

    @property
    def total_energy_j(self) -> float:
        return sum(r.get("energy_j", 0.0) for r in self.rounds)

    @property
    def mean_round_bytes(self) -> float:
        return self.total_bytes / max(len(self.rounds), 1)

    @property
    def mean_round_delay(self) -> float:
        vals = [r["delay_s"] for r in self.rounds
                if not np.isnan(r["delay_s"])]
        return float(np.mean(vals)) if vals else 0.0

    @property
    def total_sim_time_s(self) -> float:
        """Simulated wall-clock across rounds (only the deadline rounds of
        the robust runtime, not yet ported, record one)."""
        return sum(r.get("sim_dt_s", 0.0) for r in self.rounds)

    @property
    def quorum_noops(self) -> int:
        return sum(1 for r in self.rounds if r.get("quorum_noop", False))
