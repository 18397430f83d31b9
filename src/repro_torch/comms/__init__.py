"""The wireless uplink's payload codecs (the port of ``repro.comms``).

``codec`` — tree-level encode/decode, bit accounting and ``ChannelBudget``;
``quantize`` — stochastic-rounding int8/int4 per-channel quantization;
``sketch`` — top-k and count-sketch codecs; ``streams`` — the
counter-based random streams they draw from; ``factored_agg`` — the SVD
re-projection of LoRA factor pairs (no densification).
"""
from repro_torch.comms.codec import (CODEC_NAMES, ChannelBudget,  # noqa: F401
                                     CountSketchCodec, QuantCodec, TopKCodec,
                                     get_codec, payload_bits_upper_bound,
                                     payload_checksum, roundtrip)
from repro_torch.comms.factored_agg import (dense_rank_r_oracle,  # noqa: F401
                                            factored_fedavg_tree, svd_reproject)
