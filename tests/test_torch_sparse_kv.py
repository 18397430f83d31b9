"""The sparse decode variants in the port against the JAX package, on the
CPU in f32 with numpy-seeded inputs: the sparse-KV cache (layout, in-place
write, plain decode, the card path's ranges merged by their log-sum-exp),
the flash-decode plain version's LSE, ``sparse_gather_decode`` and reduced
gpt2 decoded from a sparse-KV cache.  The sweep is
``tests/test_perf_opts.py``'s (S 256, block 16, local 2, sink 1, stride 4,
8 query heads on 4 kv heads of 32).  Tolerance 2e-5 (``test_perf_opts``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro import trees as jtrees
from repro.configs import get_config as jget_config
from repro.configs.base import SparseAttnConfig as JSparse
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.sharding import MeshCtx
from repro_torch import bridge
from repro_torch.configs import SparseAttnConfig, get_config
from repro_torch.kernels.decode_attn.ops import decode_attention, decode_ranges
from repro_torch.kernels.decode_attn.ref import decode_ref
from repro_torch.models import attention
from repro_torch.models.transformer import Model

TOL = 2e-5
S = 256
PATTERN = dict(block_size=16, local_blocks=2, sink_blocks=1, stride=4)


def _qkv(seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, S, 8, 32).astype(np.float32),
            rng.randn(2, S, 4, 32).astype(np.float32),
            rng.randn(2, S, 4, 32).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seq,pattern", [(S, PATTERN), (1000, PATTERN),
                                         (4096, dict(block_size=128, local_blocks=4,
                                                     sink_blocks=1, stride=8))])
def test_sparse_kv_layout_matches_jax(seq, pattern):
    got = attention.sparse_kv_layout(seq, SparseAttnConfig(**pattern))
    want = jattn.sparse_kv_layout(seq, JSparse(**pattern))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_sparse_kv_write_and_decode_match_jax():
    """Every position of the sweep: the port's in-place ``sparse_kv_write``
    leaves the cache JAX's functional write returns (exactly), and the plain
    ``sparse_kv_decode`` is within 2e-5 of JAX's at every position."""
    q, k, v = _qkv()
    cfg, jcfg = SparseAttnConfig(**PATTERN), JSparse(**PATTERN)
    _, _, ring, n_pers = attention.sparse_kv_layout(S, cfg)
    names = [("k_pers", n_pers), ("v_pers", n_pers), ("k_ring", ring), ("v_ring", ring)]
    jc = {n: jnp.zeros((2, sz, 4, 32)) for n, sz in names}
    tc = {n: torch.zeros(2, sz, 4, 32) for n, sz in names}
    jwrite = jax.jit(functools.partial(jattn.sparse_kv_write, cfg=jcfg, seq_len=S))
    jdecode = jax.jit(functools.partial(jattn.sparse_kv_decode, cfg=jcfg, seq_len=S))
    for pos in range(S):
        jc = jwrite(jc, jnp.asarray(k[:, pos:pos + 1]), jnp.asarray(v[:, pos:pos + 1]),
                    pos=jnp.asarray(pos))
        attention.sparse_kv_write(tc, _t(k[:, pos:pos + 1]), _t(v[:, pos:pos + 1]), pos,
                                  cfg, S)
        want = jdecode(jnp.asarray(q[:, pos:pos + 1]), jc, pos=jnp.asarray(pos))
        got = attention.sparse_kv_decode(_t(q[:, pos:pos + 1]), tc, pos, cfg, S)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=1e-4,
                                   err_msg=f"pos={pos}")
    for n, _ in names:
        np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))


def test_range_lse_merge_matches_plain_decode():
    """The card path's arithmetic on the CPU: ``decode_ranges`` (one
    flash-decode call a slot range, its LSE, the exact merge) within 2e-5 of
    the plain ``sparse_kv_decode`` at every position; the ranges are at most
    three, disjoint, and cover exactly the slots the plain version's masks
    keep (the persistent prefix, the ring's cyclic interval)."""
    q, k, v = _qkv(5)
    cfg = SparseAttnConfig(**PATTERN)
    pers_blocks, _, ring, n_pers = attention.sparse_kv_layout(S, cfg)
    tc = {n: torch.zeros(2, sz, 4, 32) for n, sz in
          (("k_pers", n_pers), ("v_pers", n_pers), ("k_ring", ring), ("v_ring", ring))}
    bs = cfg.block_size
    for pos in range(S):
        attention.sparse_kv_write(tc, _t(k[:, pos:pos + 1]), _t(v[:, pos:pos + 1]), pos,
                                  cfg, S)
        ranges = attention.sparse_kv_ranges(pos, cfg, S)
        assert 1 <= len(ranges) <= 3 and all(c > 0 for _, _, c in ranges)
        qblk = pos // bs
        read = {"pers": set(), "ring": set()}
        for reg, end, count in ranges:
            assert not read[reg] & set(range(end - count, end))
            read[reg] |= set(range(end - count, end))
        pers = {s for s in range(n_pers)
                if pers_blocks[s // bs] <= qblk - cfg.local_blocks - 1}
        band = range(max(0, (qblk - cfg.local_blocks) * bs), pos + 1)
        assert read["pers"] == pers and read["ring"] == {p % ring for p in band}
        qt = _t(q[:, pos:pos + 1])
        np.testing.assert_allclose(decode_ranges(qt, tc, ranges).numpy(),
                                   attention.sparse_kv_decode(qt, tc, pos, cfg, S).numpy(),
                                   atol=TOL, rtol=1e-4, err_msg=f"pos={pos}")


@pytest.mark.parametrize("cache_len,window,sparse", [(200, 0, False), (1, 0, False),
                                                     (150, 64, False), (180, 0, True),
                                                     (256, 40, False)])
def test_decode_ref_lse_matches_logsumexp(cache_len, window, sparse):
    """``decode_ref(..., return_lse=True)``: the output is the plain
    version's, and the LSE equals ``torch.logsumexp`` of hd^-1/2·q·k over
    exactly the positions read (window, sparse mask), within 1e-5."""
    q, k, v = _qkv(7)
    cfg = SparseAttnConfig(**PATTERN) if sparse else None
    qt, kt, vt = _t(q[:, :1]), _t(k), _t(v)
    out, lse = decode_ref(qt, kt, vt, cache_len, window=window, sparse=cfg, return_lse=True)
    assert torch.equal(out, decode_attention(qt, kt, vt, cache_len, window=window,
                                             sparse=cfg))
    pos = torch.arange(S)
    keep = pos < cache_len
    if window:
        keep &= pos >= cache_len - window
    if cfg is not None:
        keep &= attention.sparse_position_mask(pos, cache_len, cfg)
    logits = torch.einsum("bhd,bthd->bht", qt[:, 0].double(),
                          kt.repeat_interleave(2, dim=2).double()) * 32 ** -0.5
    want = torch.logsumexp(logits[..., keep], -1)
    assert lse.shape == (2, 8) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_sparse_gather_decode_matches_jax():
    """The copy of JAX's gather-based decode at ``test_perf_opts``'s
    positions, within 2e-5; there (Sc / block a multiple of the stride) it
    equals the masked ``decode_attention`` the model runs for it."""
    q, k, v = _qkv()
    cfg, jcfg = SparseAttnConfig(**PATTERN), JSparse(**PATTERN)
    for pos in (0, 17, 100, 255):
        want = jattn.sparse_gather_decode(jnp.asarray(q[:, pos:pos + 1]), jnp.asarray(k),
                                          jnp.asarray(v), jnp.asarray(pos), jcfg)
        got = attention.sparse_gather_decode(_t(q[:, pos:pos + 1]), _t(k), _t(v), pos, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=1e-4)
        masked = decode_attention(_t(q[:, pos:pos + 1]), _t(k), _t(v), pos + 1, sparse=cfg)
        np.testing.assert_allclose(got.numpy(), masked.numpy(), atol=TOL, rtol=1e-4)


def test_gpt2_decode_from_sparse_kv_cache_matches_jax():
    """Reduced gpt2-small (d 64, 2 layers) with ``impl="sparse"`` and
    ``opts={"sparse_kv_seq": 128}``: 128 teacher-forced decode steps from
    ``init_cache`` against JAX's jitted ``decode_step`` with the same
    options, logits within 1e-4 at every step (``test_torch_sparse``'s model
    tolerance); the caches hold the sparse layout on both sides.  With
    ``sparse_gather_decode`` the port's prefill + decode equals its masked
    decode bit for bit (the same launches)."""
    seq = 128
    jcfg = jget_config("gpt2-small").reduced(d_model=64, repeats=2)
    cfg = get_config("gpt2-small").reduced(d_model=64, repeats=2)
    opts = {"sparse_kv_seq": seq}
    jm = JModel(jcfg, meshctx=MeshCtx.single_device(), impl="sparse", opts=opts)
    jp = jm.init(jax.random.PRNGKey(0), max_seq=seq)
    flat = {kk: np.array(vv) for kk, vv in jtrees.flatten(jp).items()}
    m = Model(cfg, device="cpu", impl="sparse", opts=opts)
    p = bridge.params_from_numpy(flat, cfg)
    toks = np.random.RandomState(4).randint(6, cfg.vocab_size, size=(2, seq))
    jc, tc = jm.init_cache(2, seq), m.init_cache(2, seq)
    assert set(tc["stages"][0][0]) == {"k_pers", "v_pers", "k_ring", "v_ring"}
    jdec = jax.jit(jm.decode_step)
    for t in range(seq):
        nxt = toks[:, t:t + 1]
        jlog, jc = jdec(jp, jc, jnp.asarray(nxt))
        tlog, tc = m.decode_step(p, tc, _t(nxt))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=0,
                                   err_msg=f"position {t}")
    for name, buf in tc["stages"][0][0].items():
        np.testing.assert_allclose(buf.numpy(), np.asarray(jc["stages"][0][0][name]),
                                   atol=1e-5, rtol=0, err_msg=name)
    gather = Model(cfg, device="cpu", impl="sparse", opts={"sparse_gather_decode": True})
    plain = Model(cfg, device="cpu", impl="sparse")
    outs = []
    for mm in (gather, plain):
        lg, c = mm.prefill(p, _t(toks[:, :32]), 40)
        for t in range(32, 36):
            lg, c = mm.decode_step(p, c, _t(toks[:, t:t + 1]))
        outs.append(lg)
    assert torch.equal(*outs)


def test_model_opts():
    """Unknown options raise; the mesh options are accepted (without a mesh
    they fall back to the single-device mixers, ``tests/test_torch_tp.py``);
    ``causal_skip`` is accepted; ``sparse_kv_seq``
    leaves ``prefill``'s cache plain (as the JAX package's)."""
    cfg = get_config("gpt2-small").reduced(d_model=64)
    with pytest.raises(ValueError, match="unknown Model opts"):
        Model(cfg, device="cpu", opts={"bogus": 1})
    for name in ("mamba_sp", "moe_a2a"):
        assert Model(cfg, device="cpu", opts={name: True}).opts == {name: True}
    m = Model(cfg, device="cpu", impl="sparse",
              opts={"causal_skip": True, "sparse_kv_seq": 64})
    p = m.init(torch.Generator().manual_seed(0), max_seq=64)
    _, c = m.prefill(p, torch.zeros(1, 16, dtype=torch.long), 64)
    assert set(c["stages"][0][0]) == {"k", "v"}
