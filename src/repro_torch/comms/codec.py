"""Uplink payload codecs, the port of ``repro.comms.codec``: a codec is a
single-client encode→decode pair over a trainable tree plus a bit-accounting
rule, and ``ChannelBudget`` turns the encoded bits into the wireless
delay, outage and energy of each upload.

Codec contract (the JAX module's):

* ``encode_leaf(delta, leaf_seed, noise) -> enc`` / ``decode_leaf(enc,
  shape, leaf_seed) -> deltâ``, leafwise.  ``noise(leaf_seed, shape)`` gives
  the leaf's uniforms on [0, 1) (only the quantizers draw them).
* ``leaf_bits(enc, delta_shape, weight) -> f32 scalar``: the quantizers
  charge empirical-entropy bits plus 16 per per-channel scale; the sketches
  their static payload.
* Clients code the **delta against the server-known reference** (``ref=``,
  the round-input value of the uploaded subtree); ``bit_weights`` (PFIT's
  sparsity masks) zero the delta of entries that are never uploaded and
  exclude them from the charge.  Leaves that are not worth coding
  (non-float, or under ``MIN_CODED_SIZE`` elements, like LoRA's
  ``(repeats, 1, 1)`` enable masks) ride raw at ``RAW_BITS`` an element.

The cohort engine (``core/cohort.py``) runs ``roundtrip`` for each client
after its local training; the server aggregates the lossy decode.  The
leaf index that keys each leaf's uniforms and count-sketch hashes counts
every leaf, coded or not, in the JAX package's order (nested, dict keys
sorted: ``trees.flatten``'s).

The uniforms come from a hook in place of JAX's keys (``PRNGKey(seed)`` →
``fold_in 0x0C0DEC`` → round → client → leaf): ``codec_uniforms``, the
default, is a counter-based stream keyed by (seed, round, client, leaf), a
pure function of them computed on the upload's device, so the card and the
CPU code alike and a resumed run replays the same draws; the parity tests
pass the JAX package's own.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import trees
from repro_torch.comms import quantize, sketch, streams
from repro_torch.wireless.channel import ChannelReport, RayleighChannel

MIN_CODED_SIZE = 16    # leaves smaller than this ride raw (enable masks…)
SCALE_BITS = 16        # per-channel scales transmitted as bf16
RAW_BITS = 32          # uncoded float element
CODEC_STREAM = 0x0C0DEC   # the JAX package's fold_in tag of the codec keys


def codec_uniforms(seed: int, rnd: int, client: int, leaf: int, shape,
                   device=None) -> torch.Tensor:
    """The default codec noise: f32 uniforms on [0, 1) of ``shape`` on
    ``device``, a counter-based stream keyed by (seed, round, client, leaf)
    (``comms.streams``): the same values on the card and the CPU."""
    return streams.uniforms(streams.stream_key(seed, CODEC_STREAM, rnd, client, leaf),
                            shape, device)


def round_noises(codec_noise, rnd: int, n_clients: int) -> list:
    """Each client's uniform hook ``noise(leaf, shape)`` of round ``rnd``,
    from a run's ``codec_noise(round, client, leaf, shape)`` (the round
    steps' ``codec_noises``)."""
    return [lambda leaf, shape, ci=ci: codec_noise(rnd, ci, leaf, shape)
            for ci in range(n_clients)]


def _no_noise(leaf_seed, shape):
    raise ValueError("a stochastic-rounding codec needs noise= (the leaves' uniforms)")


@dataclasses.dataclass(frozen=True)
class QuantCodec:
    """Stochastic-rounding int8/int4 per-channel quantization
    (``comms.quantize``)."""
    name: str
    qbits: int
    entropy_coded: bool = True

    def encode_leaf(self, delta, leaf_seed: int, noise):
        u = torch.as_tensor(noise(leaf_seed, tuple(delta.shape)), dtype=torch.float32,
                            device=delta.device)
        return quantize.sr_quantize(delta, self.qbits, u)

    def decode_leaf(self, enc, shape, leaf_seed: int):
        return quantize.sr_dequantize(enc)

    def leaf_bits(self, enc, delta_shape, weight):
        if self.entropy_coded:
            data = quantize.symbol_entropy_bits(enc["q"], self.qbits, weight)
        else:
            data = torch.broadcast_to(weight, delta_shape).float().sum() * float(self.qbits)
        # scales ride only for channels that transmit at all (a fully masked
        # leaf or channel sends nothing)
        ind = torch.broadcast_to(weight, delta_shape)
        scale = enc["scale"]
        if scale.dim() == 0:
            nch = (ind.amax() > 0).float()
        else:
            for ax, s in enumerate(scale.shape):
                if s == 1:
                    ind = ind.amax(dim=ax, keepdim=True)
            nch = (ind > 0).float().sum()
        return data + nch * SCALE_BITS


@dataclasses.dataclass(frozen=True)
class TopKCodec:
    """Top-k sparsification: the k largest-|delta| entries as (f16 value,
    int32 index) pairs (``comms.sketch``).  Static payload."""
    name: str = "sketch"
    frac: float = 0.1
    value_bits: int = 16
    index_bits: int = 32

    def encode_leaf(self, delta, leaf_seed: int, noise):
        return sketch.topk_encode(delta, self.frac)

    def decode_leaf(self, enc, shape, leaf_seed: int):
        return sketch.topk_decode(enc, shape)

    def leaf_bits(self, enc, delta_shape, weight):
        # at most k pairs, and never more than the transmittable elements
        nnz = (torch.broadcast_to(weight, delta_shape) > 0).float().sum()
        return torch.clamp(nnz, max=float(enc["idx"].shape[0])) * float(
            self.value_bits + self.index_bits)


@dataclasses.dataclass(frozen=True)
class CountSketchCodec:
    """Count-sketch projection into ``rows`` hash rows (``comms.sketch``);
    the hashes derive from the leaf's tree position.  ``hashes(leaf_seed,
    size, rows, buckets) -> (h, sgn)`` replaces the port's streams (the
    parity tests pass the JAX package's)."""
    name: str = "countsketch"
    ratio: float = 0.25
    rows: int = 3
    hashes: Optional[Callable] = dataclasses.field(default=None, compare=False)

    def _hashes(self, leaf_seed, size):
        if self.hashes is None:
            return None
        return self.hashes(leaf_seed, size, self.rows,
                           sketch.cs_buckets(size, self.rows, self.ratio))

    def encode_leaf(self, delta, leaf_seed: int, noise):
        return sketch.count_sketch_encode(delta, leaf_seed=leaf_seed, rows=self.rows,
                                          ratio=self.ratio,
                                          hashes=self._hashes(leaf_seed, delta.numel()))

    def decode_leaf(self, enc, shape, leaf_seed: int):
        return sketch.count_sketch_decode(enc, shape, leaf_seed=leaf_seed,
                                          hashes=self._hashes(leaf_seed, int(np.prod(shape))))

    def leaf_bits(self, enc, delta_shape, weight):
        # a fully masked leaf projects nothing: no sketch on the air
        any_tx = (torch.broadcast_to(weight, delta_shape).amax() > 0).float()
        return any_tx * float(enc["table"].numel() * 32)


def get_codec(name: Optional[str], **kw):
    """Codec registry: none | int8 | int4 | sketch (top-k) | countsketch."""
    if name is None or name == "none":
        return None
    if name == "int8":
        return QuantCodec(name="int8", qbits=8, **kw)
    if name == "int4":
        return QuantCodec(name="int4", qbits=4, **kw)
    if name in ("sketch", "topk"):
        return TopKCodec(name="sketch", **kw)
    if name == "countsketch":
        return CountSketchCodec(**kw)
    raise ValueError(f"unknown uplink codec {name!r}; choose from "
                     "none,int8,int4,sketch,countsketch")


CODEC_NAMES = ("none", "int8", "int4", "sketch", "countsketch")


def _codable(x) -> bool:
    return x.dim() >= 1 and x.is_floating_point() and x.numel() >= MIN_CODED_SIZE


def roundtrip(codec, tree, *, ref=None, bit_weights=None, noise=_no_noise, record=None):
    """Encode→decode one client's upload tree: ``(decoded_tree,
    payload_bits)``, the bits an f32 scalar on the tree's device.

    ``ref`` (same structure, or None for zeros): leaves are coded as ``leaf
    - ref`` and decoded as ``ref + deltâ``.  ``bit_weights`` (same structure
    of broadcastable 0/1 masks, or None): weight-0 elements are not sent —
    their delta is zeroed (decode keeps ``ref`` there under the quantizers
    and top-k) and they are not charged.  ``noise(leaf_index, shape)``: the
    leaf's uniforms (the quantizers).  ``record`` (a dict) receives each
    coded leaf's encoding by path."""
    flat = trees.flatten(tree)
    rflat = {} if ref is None else trees.flatten(ref)
    wflat = {} if bit_weights is None else trees.flatten(bit_weights)
    out, bits = {}, []
    for i, (p, x) in enumerate(flat.items()):
        rf = rflat[p] if p in rflat else torch.zeros((), dtype=x.dtype, device=x.device)
        bwb = torch.broadcast_to(torch.as_tensor(wflat.get(p, 1.0), device=x.device),
                                 x.shape).float()
        if not _codable(x):
            bits.append(bwb.sum() * RAW_BITS)
            # untransmitted (weight-0) lanes keep the server-known reference
            out[p] = torch.where(bwb > 0, x, rf).to(x.dtype)
            continue
        delta = (x - rf).float() * (bwb > 0)
        enc = codec.encode_leaf(delta, i, noise)
        if record is not None:
            record[p] = enc
        bits.append(codec.leaf_bits(enc, x.shape, bwb))
        out[p] = (rf + codec.decode_leaf(enc, x.shape, i)).to(x.dtype)
    total = torch.zeros((), dtype=torch.float32,
                        device=next(iter(flat.values())).device if flat else None)
    for b in bits:           # f32, in leaf order, as the JAX package sums
        total = total + b
    return trees.map_with_path(lambda p, _: out[p], tree), total


def _scale_count(shape) -> int:
    """Number of per-channel scales ``channel_scale`` gives a leaf."""
    if len(shape) < 2:
        return 1
    return int(np.prod(shape)) // shape[quantize.channel_axis(shape)]


def payload_bits_upper_bound(codec, tree) -> float:
    """Static (shape-only) worst-case payload bits: the flat charge before
    entropy coding (the deadline round's first scheduling size)."""
    total = 0.0
    for x in trees.flatten(tree).values():
        n = x.numel()
        if not _codable(x):
            total += n * RAW_BITS
        elif isinstance(codec, QuantCodec):
            total += n * codec.qbits + _scale_count(tuple(x.shape)) * SCALE_BITS
        elif isinstance(codec, TopKCodec):
            total += sketch.topk_k(n, codec.frac) * (codec.value_bits + codec.index_bits)
        elif isinstance(codec, CountSketchCodec):
            total += codec.rows * sketch.cs_buckets(n, codec.rows, codec.ratio) * 32
        else:
            total += n * RAW_BITS
    return float(total)


def _leaf_bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:   # numpy has no bf16: the same 2 bytes
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def payload_checksum(tree) -> int:
    """CRC-32 over a payload tree: each leaf's path, then its raw bytes, in
    sorted flat-path order (the JAX package's integer for the same bytes).
    The server checks it before merging a delivery."""
    crc = 0
    for p, x in sorted(trees.flatten(tree).items(), key=lambda kv: kv[0]):
        crc = zlib.crc32(p.encode(), crc)
        crc = zlib.crc32(_leaf_bytes(x), crc)
    return crc & 0xFFFFFFFF


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
