"""Bits → wireless budget: the port of ``repro.comms.codec.ChannelBudget``.

The payload codecs of the JAX module (stochastic-rounding quantizers,
sketches, checksums) are not ported yet (ROADMAP queue 1, ``comms``); the
round loop charges raw ``tree_bytes`` through this bridge.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.wireless.channel import ChannelReport, RayleighChannel


@dataclasses.dataclass(frozen=True)
class ChannelBudget:
    """Encoded payload bits become per-client delay/outage through
    ``RayleighChannel.uplink`` and transmit energy ``tx_power_w · delay``."""
    channel: RayleighChannel
    tx_power_w: float = 0.5

    def report(self, payload_bits: float, gain: float) -> ChannelReport:
        rep = self.channel.uplink(float(payload_bits) / 8.0, gain=gain)
        energy = 0.0 if rep.outage else self.tx_power_w * rep.delay_s
        return dataclasses.replace(rep, energy_j=energy)

    def round_reports(self, bits_per_client: Sequence[float], gains) -> list:
        return [self.report(b, g) for b, g in zip(bits_per_client, gains)]

    def tx_seconds(self, payload_bits: float, gain: float) -> float:
        """Airtime of ``payload_bits`` at the *realized* Rayleigh rate — no
        outage infinity: a failed attempt still occupied the channel (and
        burned energy) for this long.  Same ``max(rate, 1)`` floor as
        ``RayleighChannel.uplink``."""
        _, snr_lin = self.channel.snr(gain)
        rate = self.channel.bandwidth_hz * np.log2(1.0 + snr_lin)
        return float(payload_bits) / float(max(rate, 1.0))

    def attempt_report(self, payload_bits: float, gain: float, *,
                       tx_time_s: float, arrival_s: float,
                       delivered: bool) -> ChannelReport:
        """Per-attempt ledger entry for the continuous-time round: energy
        is charged for the attempt's airtime whether or not the server
        accepted it (outage, checksum NACK, deadline miss and quorum abort
        all still transmitted), bytes only count on delivery, and the delay
        is the scheduled arrival time within the round window."""
        snr_db, snr_lin = self.channel.snr(gain)
        rate = self.channel.bandwidth_hz * np.log2(1.0 + snr_lin)
        return ChannelReport(
            snr_db=float(snr_db), rate_bps=float(rate),
            delay_s=float(arrival_s) if delivered else float("inf"),
            outage=not delivered,
            bytes_sent=float(payload_bits) / 8.0 if delivered else 0,
            energy_j=self.tx_power_w * float(tx_time_s))
