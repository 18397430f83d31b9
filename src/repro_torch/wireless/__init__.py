"""Wireless uplink simulation: the Rayleigh channel, the communication
ledger, seeded fault plans and continuous-time arrivals (copies of the JAX
package's, numpy only)."""
from repro_torch.wireless.arrivals import ArrivalModel, DeadlineConfig  # noqa: F401
from repro_torch.wireless.channel import ChannelReport, RayleighChannel  # noqa: F401
from repro_torch.wireless.cost import CommLedger, tree_bytes  # noqa: F401
from repro_torch.wireless.faults import FaultPlan, FaultTrace, RoundFaults  # noqa: F401
