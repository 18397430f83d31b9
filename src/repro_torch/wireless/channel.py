"""Wireless uplink simulation (paper §V-A: Rayleigh channel, SNR = 5 dB,
40 communication rounds).

Block Rayleigh fading per client per round: channel gain |h|² ~ Exp(1),
instantaneous SNR γ = γ̄·|h|².  Achievable rate follows Shannon capacity
R = W·log2(1+γ).  A client is in *outage* for the round when γ falls below
``outage_snr_db`` — its update is lost (the server reuses the previous global
for that slot).  Upload delay = payload bits / R.

The port's copy of ``repro.wireless.channel`` (numpy only); its test holds it against
the original draw for draw.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ChannelReport:
    snr_db: float
    rate_bps: float
    delay_s: float
    outage: bool
    bytes_sent: float
    energy_j: float = 0.0     # transmit energy; filled by comms.ChannelBudget


@dataclasses.dataclass
class RayleighChannel:
    mean_snr_db: float = 5.0
    bandwidth_hz: float = 1e6
    outage_snr_db: float = -5.0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.RandomState(self.seed)

    def realize(self, n_clients: int) -> np.ndarray:
        """Per-client |h|² draws for one round."""
        return self._rng.exponential(1.0, size=n_clients)

    def snr(self, gain):
        """Gain draw(s) → (snr_db, snr_linear); scalar or vectorized — the
        ONE place the fading → SNR mapping lives (``uplink`` and
        ``outage_weights`` must agree on it)."""
        snr_lin = 10 ** (self.mean_snr_db / 10.0) * np.asarray(gain)
        snr_db = 10 * np.log10(np.maximum(snr_lin, 1e-12))
        return snr_db, snr_lin

    def outage_weights(self, gains: np.ndarray) -> np.ndarray:
        """Vectorized 1/0 alive-weight vector for one round of ``gains`` —
        the cohort engine's aggregation weights (0 = outage, the client's
        update is dropped from the weighted mean).  Same decision as the
        per-client ``uplink``."""
        snr_db, _ = self.snr(gains)
        return (snr_db >= self.outage_snr_db).astype(np.float32)

    def uplink(self, payload_bytes: float, gain: Optional[float] = None
               ) -> ChannelReport:
        """``payload_bytes`` may be fractional (entropy-coded payloads —
        see the codecs of ``comms``); delay charges the exact bit count."""
        if gain is None:
            gain = float(self._rng.exponential(1.0))
        snr_db, snr_lin = self.snr(gain)
        rate = self.bandwidth_hz * np.log2(1.0 + snr_lin)
        outage = snr_db < self.outage_snr_db
        delay = np.inf if outage else payload_bytes * 8.0 / max(rate, 1.0)
        return ChannelReport(snr_db=float(snr_db), rate_bps=float(rate),
                             delay_s=float(delay), outage=bool(outage),
                             bytes_sent=0 if outage else payload_bytes)
