"""The port's uplink codecs (``repro_torch.comms``) against the JAX
package's ``repro.comms``, on the CPU, leaf by leaf and tree by tree, with
JAX's own uniforms (``jax.random.uniform`` under each leaf's key) and
count-sketch hashes injected through the port's hooks.

Gates: stochastic-rounding symbols equal but where ``x/scale + u`` lands
within float32 rounding of an integer (one step apart, counted, ≤ 1e-6 of
the elements); entropy bits 1e-6 relative; top-k equal; count-sketch tables
1e-6 (scatter-add order) and decode exact from the same table; every
codec's ``roundtrip`` decoded tree and bits; ``payload_bits_upper_bound``
and ``payload_checksum`` equal; ``svd_reproject`` products within 1e-5 of
JAX's and of the dense oracle; ``tree_bytes(itemsize=)`` and the host int8
path equal.  The JAX package's f32 entropy histogram saturates past 2²⁴
elements in a bin; the port counts in float64 and is held to a float64
numpy recount, JAX's value recorded beside it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro import trees as jtrees
from repro.comms import codec as jcodec
from repro.comms import factored_agg as jfagg
from repro.comms import quantize as jquant
from repro.comms import sketch as jsketch
from repro.core import async_agg as jasync
from repro.wireless import cost as jcost
from repro_torch import trees
from repro_torch.comms import codec, factored_agg, quantize, sketch, streams
from repro_torch.core import aggregation, async_agg
from repro_torch.wireless import cost

KEY = jax.random.PRNGKey(5)


def _np(tree):
    return {k: np.asarray(v) for k, v in jtrees.flatten(tree).items()}


def _torch(flat):
    return trees.unflatten({k: torch.from_numpy(np.array(v)) for k, v in flat.items()})


def _jax(flat):
    return trees.unflatten({k: jnp.asarray(v) for k, v in flat.items()})


def jax_noise(key):
    """The port's noise hook fed with JAX's draws: leaf i's uniforms under
    ``fold_in(key, i)``, as ``repro.comms.codec.roundtrip`` draws them."""
    return lambda i, shape: np.array(jax.random.uniform(jax.random.fold_in(key, i), shape))


def jax_hashes(leaf_seed, size, rows, buckets):
    return tuple(np.array(a) for a in jsketch._cs_hashes(leaf_seed, size, rows, buckets))


def _one_step(got, want, n):
    """Symbols (or decoded values) equal but for elements one step apart,
    at most 1e-6 of ``n`` of them: where ``x/scale + u`` lands within f32
    rounding of an integer, the two packages' roundings may differ."""
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (diff[diff > 0] <= 1).all()
    assert (diff > 0).sum() <= 1e-6 * n


# --------------------------------------------------------------- quantize
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(6, 33), (33, 6), (50,), (2, 40, 8), (3, 1, 1, 20)])
def test_sr_quantize_matches_jax(bits, shape):
    """Scales bitwise; symbols and decode equal (one-step rule) under the
    same uniforms, a zero channel included."""
    x = (np.random.RandomState(0).randn(*shape) * 0.3).astype(np.float32)
    if len(shape) >= 2:
        x[..., 0] = 0.0                       # an all-zero channel or row
    u = np.array(jax.random.uniform(KEY, shape))
    want = jquant.sr_quantize(KEY, jnp.asarray(x), bits)
    got = quantize.sr_quantize(torch.from_numpy(x), bits, torch.from_numpy(u))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    _one_step(got["q"].numpy(), np.asarray(want["q"]), x.size)
    assert quantize.qmax_for(bits) == jquant.qmax_for(bits)
    np.testing.assert_array_equal(quantize.sr_dequantize(got).numpy(),
                                  np.asarray(jquant.sr_dequantize(
                                      {"q": jnp.asarray(got["q"].numpy()),
                                       "scale": want["scale"]})))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_symbol_entropy_bits_matches_jax(bits, masked):
    rng = np.random.RandomState(1)
    qm = jquant.qmax_for(bits)
    q = np.clip(np.round(rng.randn(40, 24) * qm / 3), -qm, qm).astype(np.int8)
    w = (rng.rand(40, 1) > 0.3).astype(np.float32) if masked else None
    want = float(jquant.symbol_entropy_bits(jnp.asarray(q), bits,
                                            None if w is None else jnp.asarray(w)))
    got = quantize.symbol_entropy_bits(torch.from_numpy(q), bits,
                                       None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def _recount_bits(q, bits, weight=None):
    """Float64 numpy recount: n·H over the weighted symbol histogram."""
    sym = q.astype(np.int64).reshape(-1) + 2 ** bits // 2
    w = None if weight is None else np.broadcast_to(weight, q.shape).reshape(-1)
    hist = np.bincount(sym, weights=w, minlength=2 ** bits).astype(np.float64)
    n = hist.sum()
    p = hist[hist > 0] / max(n, 1.0)
    return -n * float((p * np.log2(p)).sum())


def test_entropy_histogram_counts_past_2_24():
    """2²⁴ + 2²⁰ int4 symbols, all but 2¹⁹ of them 0: the port's bits agree
    with a float64 numpy recount (1e-6 relative).  The JAX package counts
    in float32, where the zero bin stops at 2²⁴ (adding 1.0 no longer moves
    it), so its charge falls short; its value is recorded, not copied."""
    n = 2 ** 24 + 2 ** 20
    q = np.zeros(n, np.int8)
    q[: 2 ** 19] = np.random.RandomState(2).randint(-7, 8, size=2 ** 19)
    want = _recount_bits(q, 4)
    got = float(quantize.symbol_entropy_bits(torch.from_numpy(q), 4))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    jax_bits = float(jquant.symbol_entropy_bits(jnp.asarray(q), 4))
    assert abs(jax_bits - want) > 1e-3 * want     # JAX's saturated histogram


# --------------------------------------------------------------- sketches
def test_topk_matches_jax():
    x = np.random.RandomState(3).randn(7, 30).astype(np.float32)
    want = jsketch.topk_encode(jnp.asarray(x), 0.1)
    got = sketch.topk_encode(torch.from_numpy(x), 0.1)
    assert sketch.topk_k(x.size, 0.1) == jsketch.topk_k(x.size, 0.1)
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))
    np.testing.assert_array_equal(got["val"].numpy(), np.asarray(want["val"]))
    np.testing.assert_array_equal(sketch.topk_decode(got, x.shape).numpy(),
                                  np.asarray(jsketch.topk_decode(want, x.shape)))


@pytest.mark.parametrize("rows", [3, 4])
def test_count_sketch_matches_jax(rows):
    """With JAX's hashes: the table within 1e-6 (scatter-add order), and
    the decode (median over rows; the mean of the two middle estimates at
    an even count) exactly JAX's from the same table."""
    x = np.random.RandomState(4).randn(12, 25).astype(np.float32)
    x[np.abs(x) < 1.5] *= 0.01                          # heavy hitters
    want = jsketch.count_sketch_encode(jnp.asarray(x), leaf_seed=3, rows=rows, ratio=0.25)
    b = sketch.cs_buckets(x.size, rows, 0.25)
    hs = jax_hashes(3, x.size, rows, b)
    got = sketch.count_sketch_encode(torch.from_numpy(x), leaf_seed=3, rows=rows, ratio=0.25,
                                     hashes=hs)
    np.testing.assert_allclose(got["table"].numpy(), np.asarray(want["table"]), rtol=1e-6,
                               atol=1e-6)
    dec = sketch.count_sketch_decode({"table": torch.from_numpy(np.array(want["table"]))},
                                     x.shape, leaf_seed=3, hashes=hs)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(
        jsketch.count_sketch_decode(want, x.shape, leaf_seed=3)))


def test_port_hash_streams_match_numpy():
    """The counter-based streams against a numpy uint64 murmur3 finalizer
    (so no int64 product overflows), the uniforms in [0, 1), the hashes in
    range and their signs ±1; a stream is a pure function of its key."""
    def fmix(x):
        x = x ^ (x >> np.uint64(16))
        x = (x * np.uint64(0x85EBCA6B)) & np.uint64(0xFFFFFFFF)
        x = x ^ (x >> np.uint64(13))
        x = (x * np.uint64(0xC2B2AE35)) & np.uint64(0xFFFFFFFF)
        return x ^ (x >> np.uint64(16))

    key = streams.stream_key(1, 2, 3)
    pos = np.arange(5000, dtype=np.uint64)
    want = fmix(fmix(pos ^ np.uint64(key)) ^ np.uint64((key * 0x9E3779B9) & 0xFFFFFFFF))
    np.testing.assert_array_equal(streams.hash32(key, 5000).numpy(), want.astype(np.int64))
    u = codec.codec_uniforms(0, 1, 2, 3, (50, 100))
    assert u.dtype == torch.float32 and 0 <= float(u.min()) and float(u.max()) < 1
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert torch.equal(u, codec.codec_uniforms(0, 1, 2, 3, (50, 100)))
    assert not torch.equal(u, codec.codec_uniforms(0, 1, 3, 3, (50, 100)))
    h, sgn = sketch.cs_hashes(7, 1000, 3, 40, "cpu")
    assert h.shape == (3, 1000) and int(h.min()) >= 0 and int(h.max()) < 40
    assert set(sgn.unique().tolist()) == {-1.0, 1.0}


# --------------------------------------------------------------- tree level
def _upload_tree(seed=6):
    """A fedlora-shaped upload (factors, a tiny enable mask that rides raw,
    a head, a 1-D leaf) with its reference and sparsity masks: one leaf
    partly masked, one wholly."""
    rng = np.random.RandomState(seed)
    flat = {"lora/0/wq/a": rng.randn(2, 32, 4), "lora/0/wq/b": rng.randn(2, 4, 32),
            "lora/0/wq/mask": np.ones((2, 1, 1)), "head": rng.randn(32, 6),
            "bias": rng.randn(40), "emb": rng.randn(20, 16)}
    flat = {k: (v * 0.1).astype(np.float32) for k, v in flat.items()}
    ref = {k: (v + rng.randn(*v.shape).astype(np.float32) * 0.01) for k, v in flat.items()}
    masks = {k: np.ones((1,) * v.ndim, np.float32) for k, v in flat.items()}
    masks["head"] = (rng.rand(32, 1) > 0.5).astype(np.float32)
    masks["emb"] = np.zeros((1, 1), np.float32)             # never uploaded
    return flat, ref, masks


def _jcodec(name):
    return jcodec.get_codec(name)


def _codec(name):
    return codec.get_codec(name, **({"hashes": jax_hashes} if name == "countsketch" else {}))


@pytest.mark.parametrize("name", ["int8", "int4", "sketch", "countsketch"])
@pytest.mark.parametrize("masked", [False, True])
def test_roundtrip_matches_jax(name, masked):
    """One client's upload coded against its reference: decoded tree and
    bits against JAX's (bits 1e-6 relative; the quantizers' decode equal but
    one-step elements; the sketches 1e-6), and weight-0 elements keep the
    reference exactly (quantizers, top-k)."""
    flat, ref, masks = _upload_tree()
    kw = {"bit_weights": masks} if masked else {}
    jdec, jbits = jcodec.roundtrip(_jcodec(name), KEY, _jax(flat), ref=_jax(ref),
                                   **{k: _jax(v) for k, v in kw.items()})
    dec, bits = codec.roundtrip(_codec(name), _torch(flat), ref=_torch(ref),
                                noise=jax_noise(KEY), **{k: _torch(v) for k, v in kw.items()})
    assert bits.dtype == torch.float32 and bits.dim() == 0
    np.testing.assert_allclose(float(bits), float(jbits), rtol=1e-6)
    got, want = trees.flatten(dec), _np(jdec)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if name.startswith("int"):   # ref + q·scale: equal where the symbols are
            assert (got[k].numpy() != v).sum() <= 1e-6 * v.size, k
        else:
            np.testing.assert_allclose(got[k].numpy(), v, atol=1e-6, err_msg=k)
    if masked and name != "countsketch":
        out = got["emb"].numpy()
        np.testing.assert_array_equal(out, ref["emb"])


@pytest.mark.parametrize("name", ["int8", "int4", "sketch", "countsketch"])
def test_fully_masked_leaf_charges_zero_bits(name):
    """A leaf whose mask is all zero sends nothing: 0 bits, as in JAX."""
    x = {"w": np.random.RandomState(7).randn(16, 8).astype(np.float32)}
    m = {"w": np.zeros((16, 1), np.float32)}
    _, jbits = jcodec.roundtrip(_jcodec(name), KEY, _jax(x), bit_weights=_jax(m))
    _, bits = codec.roundtrip(_codec(name), _torch(x), bit_weights=_torch(m),
                              noise=jax_noise(KEY))
    assert float(bits) == float(jbits) == 0.0


@pytest.mark.parametrize("name", ["int8", "int4", "sketch", "countsketch"])
def test_payload_bits_upper_bound_matches_jax(name):
    flat, _, _ = _upload_tree()
    assert codec.payload_bits_upper_bound(_codec(name), _torch(flat)) == \
        jcodec.payload_bits_upper_bound(_jcodec(name), _jax(flat))


def test_payload_checksum_matches_jax():
    """The same integer for the same bytes: f32, int8 and bf16 leaves."""
    flat, _, _ = _upload_tree()
    flat["q"] = np.arange(-20, 20, dtype=np.int8).reshape(5, 8)
    t = _torch(flat)
    t["half"] = torch.linspace(-1, 1, 12).to(torch.bfloat16)
    j = _jax(flat)
    j["half"] = jnp.asarray(t["half"].float().numpy()).astype(jnp.bfloat16)
    assert codec.payload_checksum(t) == jcodec.payload_checksum(j)
    assert codec.CODEC_NAMES == jcodec.CODEC_NAMES
    assert (codec.MIN_CODED_SIZE, codec.SCALE_BITS, codec.RAW_BITS) == (
        jcodec.MIN_CODED_SIZE, jcodec.SCALE_BITS, jcodec.RAW_BITS)


# --------------------------------------------------------------- factored agg
@pytest.mark.parametrize("weights", [None, [1.0, 2.0, 0.0, 1.0], [0.0, 0.0, 0.0, 0.0]])
def test_svd_reproject_matches_jax_and_oracle(weights):
    """Stacked rank-4 factors of 4 clients over 2 layers: A'·B' within 1e-5
    of JAX's A'·B' and of the dense rank-r oracle (products, not factors:
    the signs of an SVD are ambiguous); a zero-weight client leaves L
    rank-deficient, all-zero weights give a zero product."""
    rng = np.random.RandomState(8)
    a = (rng.randn(4, 2, 24, 4) * 0.3).astype(np.float32)
    b = (rng.randn(4, 2, 4, 20) * 0.3).astype(np.float32)
    ja, jb = jfagg.svd_reproject(jnp.asarray(a), jnp.asarray(b), weights)
    ta, tb = factored_agg.svd_reproject(torch.from_numpy(a), torch.from_numpy(b), weights)
    want = np.asarray(ja @ jb)
    oracle = factored_agg.dense_rank_r_oracle(torch.from_numpy(a), torch.from_numpy(b),
                                              weights).numpy()
    np.testing.assert_allclose((ta @ tb).numpy(), want, atol=1e-5)
    np.testing.assert_allclose((ta @ tb).numpy(), oracle, atol=1e-5)
    np.testing.assert_allclose(oracle, np.asarray(jfagg.dense_rank_r_oracle(
        jnp.asarray(a), jnp.asarray(b), weights)), atol=1e-5)
    assert ta.shape == a.shape[1:] and tb.shape == b.shape[1:]


def test_factored_fedavg_tree_matches_jax():
    """Factor pairs by the re-projection (products within 1e-5), every
    other leaf the plain weighted mean; ``factored_fedavg_stacked`` is the
    same function."""
    rng = np.random.RandomState(9)
    flat = {"l/0/wq/a": rng.randn(3, 2, 16, 4), "l/0/wq/b": rng.randn(3, 2, 4, 12),
            "l/0/wq/mask": np.ones((3, 2, 1, 1)), "head": rng.randn(3, 12, 4)}
    flat = {k: (v * 0.2).astype(np.float32) for k, v in flat.items()}
    w = [0.5, 1.0, 0.0]
    want = _np(jfagg.factored_fedavg_tree(_jax(flat), jnp.asarray(w)))
    got = trees.flatten(aggregation.factored_fedavg_stacked(_torch(flat), torch.tensor(w)))
    np.testing.assert_allclose((got["l/0/wq/a"] @ got["l/0/wq/b"]).numpy(),
                               want["l/0/wq/a"] @ want["l/0/wq/b"], atol=1e-5)
    for k in ("l/0/wq/mask", "head"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6)


# --------------------------------------------------------------- bytes, int8
def test_tree_bytes_itemsize_matches_jax():
    flat, _, masks = _upload_tree()
    t, j = _torch(flat), _jax(flat)
    per_leaf = {"head": 0.5, "bias": None, "emb": 1}
    for kw in ({}, {"itemsize": 1}, {"itemsize": 0.5},
               {"itemsize": trees.unflatten(per_leaf)}):
        assert cost.tree_bytes(t, **kw) == jcost.tree_bytes(j, **kw), kw
    assert cost.tree_bytes(t, nonzero_mask=_torch(masks), itemsize=0.5) == \
        jcost.tree_bytes(j, nonzero_mask=_jax(masks), itemsize=0.5)


def test_quantize_update_matches_jax():
    """The host int8 path: symbols, scales, the rebuilt tree (on the
    template's dtype) and the payload bytes equal; a zero leaf stays zero."""
    flat, _, _ = _upload_tree()
    flat["zero"] = np.zeros((4, 4), np.float32)
    jq, js = jasync.quantize_update(_jax(flat))
    q, s = async_agg.quantize_update(_torch(flat))
    assert q.keys() == jq.keys() and s == js
    for k in q:
        np.testing.assert_array_equal(q[k], jq[k], err_msg=k)
    want = _np(jasync.dequantize_update(jq, js, _jax(flat)))
    got = trees.flatten(async_agg.dequantize_update(q, s, _torch(flat)))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert async_agg.quantized_bytes(q) == jasync.quantized_bytes(jq)
