"""Continuous-time upload arrivals for the robust federated round.

The round-granular fault runtime (``wireless/faults.py``) makes a
``straggle-by-k`` client an *input*.  This module drives staleness from
realized ``ChannelBudget`` delays instead: each attempting client gets a
per-round **arrival time**

    arrival_s = start_s + payload_bits / realized_rate

where ``realized_rate`` is the round's Shannon rate at the client's realized
Rayleigh SNR (``RayleighChannel.snr`` — the SAME fading → SNR map the outage
decision uses), ``payload_bits`` is the encoded size of the payload on the
air (the client's fresh encode, or the buffered bits of a retransmission),
and ``start_s`` is a compute-time draw scaled by the fault trace's straggle
factor (fresh uploads) or the remaining exponential-backoff wait
(retransmissions).  The server aggregates whoever arrives before
``DeadlineConfig.deadline_s``; late payloads go pending with staleness =
rounds-elapsed-at-delivery — ``straggle-by-k`` becomes an *emergent*
outcome of a slow channel instead of an input.

Scheduling uses the payload size the host knows *when the round is
dispatched*: exact for uncompressed uploads and for retransmissions (the
buffered size), and the client's previously realized encoded size for
compressed fresh uploads (round 0 falls back to the shape-only
``payload_bits_upper_bound``) — the radio reserves its slot from the size
the client reports, while the ledger always charges the realized bits.

Retries (outage, deadline miss, or checksum NACK) follow capped exponential
backoff: the n-th failure of a payload schedules its next attempt no
earlier than ``t_fail + backoff_base_s · 2^(n-1)``, each attempt's airtime
energy is charged to the ledger, and the payload is abandoned (its bits
drop out of the ledger) after ``max_retries`` failed retransmissions.

``min_quorum`` is the graceful-degradation gate: a round delivering fewer
payloads than the quorum becomes an accuracy-preserving no-op — nothing is
merged, deliveries are NACKed back to pending (no backoff penalty: the
abort is the server's, not the channel's), and the event is recorded in the
ledger.  ``min_quorum=0`` reduces to the all-outage ``Σw > 0`` gate.

All decisions are pure functions of host-known quantities (trace masks,
realized gains, known payload sizes), so the cohort engine consumes the
masks/weights of one ``StalenessTracker`` and the port's runs equal the
JAX package's under deadlines.

The port's copy of ``repro.wireless.arrivals`` (numpy only); its test holds
it against the original.  Its codec remarks apply once ``comms`` codecs
are ported; until then every payload's size is exact.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DeadlineConfig:
    """Server-side deadline + retry knobs for the continuous-time round.

    The all-default config ``is_inert()``: an infinite deadline with no
    quorum, no backoff and zero compute time is byte-for-byte the
    round-granular robust runtime (the runners skip the arrival machinery
    entirely), so ``DeadlineConfig()`` is always safe to thread through."""
    deadline_s: float = math.inf   # aggregation cutoff per round (seconds)
    backoff_base_s: float = 0.0    # n-th failure retries after base·2^(n-1)
    max_retries: int = 8           # failed retransmissions before abandoning
    min_quorum: int = 0            # deliveries below this → no-op round
    compute_mean_s: float = 0.0    # mean local-compute time before the uplink
    seed: int = 0                  # compute-jitter draw stream

    def is_inert(self) -> bool:
        return (math.isinf(self.deadline_s) and self.min_quorum == 0
                and self.backoff_base_s == 0.0 and self.compute_mean_s == 0.0)

    # ---- serialization (launch flags, benchmark manifests) ----------------

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "DeadlineConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown DeadlineConfig fields {sorted(unknown)}; "
                f"known: {sorted(known)}")
        return cls(**d)

    @classmethod
    def from_spec(cls, spec: Optional[str]) -> Optional["DeadlineConfig"]:
        """``None``/""/"none" → no config; a JSON file path; or an inline
        ``k=v,k=v`` string, e.g. ``deadline_s=0.5,min_quorum=2``
        (``deadline_s=inf`` parses)."""
        if spec is None or spec == "" or spec == "none":
            return None
        if os.path.exists(spec):
            with open(spec) as f:
                return cls.from_dict(json.load(f))
        d: Dict = {}
        for item in spec.split(","):
            k, sep, v = item.partition("=")
            if not sep:
                raise ValueError(f"bad deadline item {item!r} "
                                 "(want key=value)")
            k = k.strip()
            d[k] = (int(v) if k in ("max_retries", "min_quorum", "seed")
                    else float(v))
        return cls.from_dict(d)


class ArrivalModel:
    """Seeded per-round arrival-time draws against a ``RayleighChannel``.

    One fixed-size draw block per round (``compute_times``) keeps the RNG
    stream layout identical whatever the round decides and lets
    checkpoint resume replay skipped rounds by burning draws, exactly like
    the channel's fading stream."""

    def __init__(self, channel, cfg: DeadlineConfig, n_clients: int):
        self.channel = channel
        self.cfg = cfg
        self.n_clients = n_clients
        self._rng = np.random.RandomState(cfg.seed)

    def rates(self, gains: np.ndarray) -> np.ndarray:
        """Realized Shannon rate (bps) per client, floored at 1 bps — the
        same ``bits / max(rate, 1)`` floor ``RayleighChannel.uplink``
        charges, so airtime and delay agree."""
        _, snr_lin = self.channel.snr(gains)
        rate = self.channel.bandwidth_hz * np.log2(1.0 + snr_lin)
        return np.maximum(rate, 1.0).astype(np.float64)

    def compute_times(self, compute_scale=None) -> np.ndarray:
        """One round's local-compute draw per client:
        ``compute_mean_s · U[0.5, 1.5) · straggle_scale``.  The uniform
        jitter is drawn for every client every round (stream stability);
        ``compute_scale`` is the trace's per-round straggle factor
        (``1 + k`` on straggle rounds, 1 otherwise)."""
        u = self._rng.rand(self.n_clients)
        ct = self.cfg.compute_mean_s * (0.5 + u)
        if compute_scale is not None:
            ct = ct * np.asarray(compute_scale, np.float64)
        return ct

    def burn_round(self) -> None:
        """Consume one round's draws (checkpoint-resume replay)."""
        self._rng.rand(self.n_clients)

    def backoff_wait_s(self, failures: np.ndarray) -> np.ndarray:
        """Wait before the next attempt after ``failures`` failed attempts
        of the current payload: ``base · 2^(failures-1)`` (0 for an
        unfailed payload)."""
        f = np.asarray(failures, np.float64)
        return np.where(f > 0,
                        self.cfg.backoff_base_s * 2.0 ** np.maximum(f - 1, 0),
                        0.0)
