"""Uplink accounting.  Only ``ChannelBudget`` is ported so far; the codecs
(quantizers, sketches, factored aggregation) come with ROADMAP queue 1's
``comms`` item."""
from repro_torch.comms.codec import ChannelBudget  # noqa: F401
