"""Bits → wireless budget: the port of ``repro.comms.codec.ChannelBudget``.

The payload codecs of the JAX module (stochastic-rounding quantizers,
sketches, checksums) are not ported yet (ROADMAP queue 1, ``comms``); the
round loop charges raw ``tree_bytes`` through this bridge.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

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
