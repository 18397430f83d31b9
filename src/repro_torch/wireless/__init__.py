"""Wireless uplink simulation: the Rayleigh channel (a copy of the JAX
package's, numpy only) and the communication ledger."""
from repro_torch.wireless.channel import ChannelReport, RayleighChannel  # noqa: F401
from repro_torch.wireless.cost import CommLedger, tree_bytes  # noqa: F401
