"""Every head width in the port: the plan that routes a call's row widths
to the attention kernels' compiled tiles (whole chunks, elements, the
prefill kernels' split of a head over a thread block cluster, the decode
kernel's slices past 256), each plan's cover in plain torch against the JAX
package's attention, decode and block-sparse attention, gemma3-12b's heads
of 240 and gpt2-small's heads of 18 served against the JAX package on the
CPU (f32, numpy-seeded LoRA, the JAX package's own weights carried across
the bridge), and the launcher's arch round at ``--fl-dmodel 72`` against
JAX's ``run_arch_round``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

import repro.core.arch_round as jar
from repro import trees as jtrees
from repro.configs import LK as JLK
from repro.configs import SparseAttnConfig as JSparse
from repro.configs import Stage as JStage
from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.models import peft as jpeft
from repro.sharding import MeshCtx
from repro_torch import bridge
from repro_torch.configs import LK, SparseAttnConfig, Stage, get_config
from repro_torch.core import arch_round
from repro_torch.kernels.block_sparse_attn.ops import block_sparse_attention
from repro_torch.kernels.decode_attn.ops import decode_attention
from repro_torch.kernels.flash_attn.ops import (RANK_TILE, SPLIT_MAX, SQUARE, WIDTHS,
                                                AttnPlan, Cluster, flash_attention, instance,
                                                plan, workspace)
from repro_torch.kernels.flash_attn.ref import cover_ref
from repro_torch.launch import train
from repro_torch.models.attention import make_mask, sparse_block_table, sparse_position_mask
from repro_torch.models.transformer import Model

TOL = 1e-5
PROMPT, STEPS = 80, 8


# ---------------------------------------------------------------- routing
@pytest.mark.parametrize("dk,dv,want", [
    ((240, 240, (256, 256))), (16, 16, (32, 32)), (32, 16, (32, 32)),
    (80, 64, (96, 64)), (48, 32, (64, 64)), (120, 120, (128, 128)),
    *[(dk, dv, (dk, dv)) for dk, dv in WIDTHS]])
def test_instance_picks_the_smallest_tile(dk, dv, want):
    """A call's (dk, dv) runs in the smallest compiled tile that holds it:
    gemma3's 240 in 256, the launcher's default heads of 16 (and its MLA's
    (32, 16)) in 32, every compiled pair in itself; f32 and bf16 alike."""
    assert instance(dk, dv) == want
    assert instance(dk, dv, itemsize=2) == want
    if dk == dv:
        assert instance(dk, dv, widths=SQUARE) == want


R128 = (128, 128)


@pytest.mark.parametrize("dk,dv,itemsize,want", [
    # rows wider than 256: split over rank tiles of 128 (the decode kernel
    # slices q·k over 256-wide slices and v into 256-column planes)
    (260, 260, 4, AttnPlan((256, 256), True, 2, 2, Cluster(R128, 3))),
    (288, 288, 4, AttnPlan((256, 256), True, 2, 2, Cluster(R128, 3))),
    (264, 128, 4, AttnPlan((256, 256), True, 2, 1, Cluster(R128, 3))),
    (528, 512, 4, AttnPlan((256, 256), True, 3, 2, Cluster(R128, 5))),
    (1000, 1000, 2, AttnPlan((256, 256), True, 4, 4, Cluster(R128, 8))),
    (1001, 1001, 2, AttnPlan((256, 256), False, 4, 4, Cluster(R128, 8))),
    (274, 274, 4, AttnPlan((256, 256), False, 2, 2, Cluster(R128, 3))),
    # not whole 16-byte chunks: elements, the smallest square tile
    (18, 18, 4, AttnPlan((32, 32), False)), (34, 32, 4, AttnPlan((64, 64), False)),
    (32, 2, 4, AttnPlan((32, 32), False)), (12, 12, 2, AttnPlan((32, 32), False)),
    (36, 36, 2, AttnPlan((64, 64), False)), (240, 20, 2, AttnPlan((256, 256), False)),
    (1, 1, 4, AttnPlan((32, 32), False)), (34, 18, 4, AttnPlan((64, 64), False)),
    # whole chunks keep their tiles
    (240, 240, 4, AttnPlan((256, 256), True)), (80, 64, 4, AttnPlan((96, 64), True))])
def test_plan_covers_every_width(dk, dv, itemsize, want):
    """Every width ≥ 1 has a plan: whole 16-byte chunks up to 256 run the
    tile they ran before (the chunk path), other rows up to 256 element by
    element in the smallest square tile holding both widths, wider rows
    split from (256, 256) (chunk reads where whole) and sliced by the decode
    kernel; the C entry points' path number and the decode planes follow."""
    got = plan(dk, dv, itemsize)
    assert got == want and instance(dk, dv, itemsize) == want.tile
    assert got.path == (2 if max(dk, dv) > 256 else 0 if want.aligned else 1)
    planes = got.planes(dv)
    assert planes[0][0] == 0 and planes[-1][1] == dv and len(planes) == got.dv_slices
    assert all(e - a <= got.tile[1] and a == (z * got.tile[1])
               for z, (a, e) in enumerate(planes))
    assert got.dk_slices * got.tile[0] >= dk > (got.dk_slices - 1) * got.tile[0]
    if dk == dv:
        assert plan(dk, dv, itemsize, SQUARE) == want


# (dk, dv) → (ranks, k_per, v_per): rows past 256 in ranks of (128, 128);
# past 16 ranks of 128 a rank loops over its slices
@pytest.mark.parametrize("dk,dv,want", [
    (257, 257, (3, 1, 1)), (260, 128, (3, 1, 1)), (272, 272, (3, 1, 1)),
    (288, 272, (3, 1, 1)), (512, 512, (4, 1, 1)), (528, 512, (5, 1, 1)),
    (128, 384, (3, 1, 1)), (1024, 1024, (8, 1, 1)), (1040, 1040, (9, 1, 1)),
    (2048, 2048, (16, 1, 1)), (2080, 2080, (9, 2, 2)), (2080, 128, (9, 2, 1)),
    (64, 4096, (16, 1, 2)), (5000, 5000, (14, 3, 3))])
def test_cluster_route(dk, dv, want):
    """The prefill kernels' split of rows past 256: the rank tile, the
    ranks and the slices a rank loops over, each rank's contiguous q/k dims
    and v/o columns covering the rows once in rank order, at most a tile's
    width a slice; a rank with no v columns ((528, 512): rank 4; (260, 128))
    or no q/k dims ((128, 384), (64, 4096)); chunk reads where the rows are
    whole; the f32 workspace only where a rank owns more than one v slice."""
    p = plan(dk, dv)
    c = p.cluster
    assert c.tile == RANK_TILE and (c.ranks, c.k_per, c.v_per) == want
    assert c.ranks <= SPLIT_MAX and c.loops == (want[1] > 1 or want[2] > 1)
    for ranges, width, w in ((c.dims(dk), dk, c.tile[0] * c.k_per),
                             (c.cols(dv), dv, c.tile[1] * c.v_per)):
        assert len(ranges) == c.ranks and ranges[0][0] == 0 and ranges[-1][1] == width
        assert all(a <= e and e - a <= w for a, e in ranges)
        assert all(ranges[r][1] == ranges[r + 1][0] for r in range(c.ranks - 1))
        assert max(e - a for a, e in ranges) == min(w, width)
    assert p.aligned == (dk % 4 == 0 and dv % 4 == 0)
    q = torch.zeros(2, 3, 4, dk)
    work = workspace(q, dv, p)
    assert (work is None) == (want[2] == 1)
    if work is not None:
        assert work.shape == (2, 3, 4, dv) and work.dtype == torch.float32
    if dk == 528:
        assert c.cols(dv)[4] == (512, 512) and c.dims(dk)[4] == (512, 528)


def test_one_block_tiles_do_not_split():
    """Every compiled tile, (32, 32) to (256, 256) with MLA's (96, 64) and
    (192, 128), and element rows up to 256 run in one block a (batch·head,
    q tile): no cluster; past 256 every row splits."""
    for dk, dv in [*WIDTHS, (18, 18), (80, 64), (120, 120), (130, 120), (240, 240),
                   (250, 250), (160, 128)]:
        assert plan(dk, dv).cluster is None, (dk, dv)
        assert plan(dk, dv, 2).cluster is None, (dk, dv)
    assert all(plan(d, d).cluster is not None for d in (257, 260, 300))


@pytest.mark.parametrize("dk,dv", [(0, 0), (0, 8), (8, 0)])
def test_plan_refuses_width_zero(dk, dv):
    """Width 0 raises, naming it (the JAX package has no such rows either);
    the wrappers raise so on the CPU and the card alike."""
    with pytest.raises(ValueError, match=f"head width {dk}"):
        plan(dk, dv)
    q, v = torch.zeros(1, 4, 2, dk), torch.zeros(1, 4, 2, dv)
    with pytest.raises(ValueError, match=f"head width {dk}"):
        flash_attention(q, q, v)


def test_decode_takes_square_tiles_only():
    """The decode kernel's layouts are the square tiles: heads of 96 run at
    128 and heads of 192 at 256, as in the prefill kernels (whose MLA tiles
    (96, 64) and (192, 128) hold no v of 96 or 192)."""
    assert instance(96, 96, widths=SQUARE) == instance(96, 96) == (128, 128)
    assert instance(192, 192, widths=SQUARE) == instance(192, 192) == (256, 256)


# ---------------------------------------------------------------- covers
COVER_WIDTHS = [(d, d) for d in (1, 2, 18, 34, 240, 256, 272, 288, 512, 528, 1000, 2080)] + [
    (34, 18), (288, 272), (528, 512), (192, 128)]
JSP = dict(block_size=16, local_blocks=2, sink_blocks=1, stride=2)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _j_bsa(q, k, v, cfg, q_offset):
    """JAX's block-sparse attention, v zero-padded to q's width and the
    output cut back where v is narrower (JAX's reshapes v with q's width:
    ROADMAP queue 3, ``tests/test_torch_mla.py::_j_bsa_v_padded``)."""
    dv = v.shape[-1]
    vp = jnp.concatenate([v, jnp.zeros(v.shape[:3] + (q.shape[-1] - dv,), v.dtype)], -1)
    return jattn.block_sparse_attention(q, k, vp, JSparse(**cfg), q_offset=q_offset)[..., :dv]


def _sparse_allowed(sq, sk, cfg, q_offset):
    """The block-sparse kernels' (Sq, Sk) mask: a q block's valid kv blocks,
    causal inside them."""
    bs = cfg.block_size
    idx, valid = sparse_block_table(sq // bs, sk // bs, cfg, q_offset // bs)
    allowed = torch.zeros(sq, sk, dtype=torch.bool)
    for i in range(idx.shape[0]):
        for j in idx[i][valid[i]]:
            allowed[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = True
    qpos = torch.arange(sq)[:, None] + q_offset
    return allowed & (torch.arange(sk)[None, :] <= qpos)


@pytest.mark.parametrize("dk,dv", COVER_WIDTHS)
def test_prefill_covers_match_jax(dk, dv):
    """Each width's cover (``cover_ref``: partial q·k dots per rank of the
    plan's cluster added in rank order, P once, each rank's v columns) and
    the wrappers' CPU path against JAX's dense attention (causal with a window
    and GQA 2, non-causal) and block-sparse attention (block 16, q offset
    32), numpy-seeded f32 inputs, within 1e-5."""
    rng = np.random.RandomState(dk + 7 * dv)
    p = plan(dk, dv)
    q, k, v = _rand(rng, 2, 48, 4, dk), _rand(rng, 2, 48, 2, dk), _rand(rng, 2, 48, 2, dv)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    for causal, window in ((True, 20), (False, 0)):
        want = np.asarray(jattn.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                causal=causal, window=window))
        mask = make_mask(48, 48, causal=causal, window=window, device="cpu")
        for got in (cover_ref(tq, tk, tv, p, mask, dk ** -0.5),
                    flash_attention(tq, tk, tv, causal=causal, window=window)):
            np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    cfg = SparseAttnConfig(**JSP)
    kk, vv = _rand(rng, 2, 80, 2, dk), _rand(rng, 2, 80, 2, dv)
    tkk, tvv = torch.from_numpy(kk), torch.from_numpy(vv)
    want = np.asarray(_j_bsa(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv), JSP, 32))
    for got in (cover_ref(tq, tkk, tvv, p, _sparse_allowed(48, 80, cfg, 32), dk ** -0.5),
                block_sparse_attention(tq, tkk, tvv, cfg, q_offset=32)):
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("d", sorted({d for d, dv in COVER_WIDTHS if d == dv}))
def test_decode_covers_match_jax(d):
    """The decode plan's cover (square widths: k and v of one width, as in
    JAX; past 256 the dot over 256-wide slices, v in 256-column planes) and the wrapper's CPU path against JAX's ``decode_attention``,
    GQA 2: dense, windowed, and under the sparse mask, within 1e-5."""
    rng = np.random.RandomState(d)
    p = plan(d, d, widths=SQUARE)
    q, kc, vc = _rand(rng, 2, 1, 4, d), _rand(rng, 2, 80, 2, d), _rand(rng, 2, 80, 2, d)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, kc, vc))
    pos = torch.arange(80)
    for cache_len, window, sparse in ((70, 0, False), (70, 30, False), (75, 0, True)):
        want = np.asarray(jattn.decode_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), cache_len, window=window,
            sparse=JSparse(**JSP) if sparse else None))
        cfg = SparseAttnConfig(**JSP) if sparse else None
        allowed = (pos < cache_len) & ((pos >= cache_len - window) if window else True)
        if sparse:
            allowed &= sparse_position_mask(pos, cache_len, cfg)
        for got in (cover_ref(tq, tk, tv, p, allowed, d ** -0.5, decode=True),
                    decode_attention(tq, tk, tv, cache_len, window=window, sparse=cfg)):
            np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


# ---------------------------------------------------------------- gemma3
def _gemma3_cut(get, lk, stage):
    """gemma3-12b at heads of 240: 2 query heads on 1 KV head, d 480, one
    ``local`` (window 64) and one global layer, vocab 512."""
    cfg = get("gemma3-12b").reduced(d_model=480, repeats=1, vocab=512)
    return dataclasses.replace(cfg, n_heads=2, n_kv_heads=1, head_dim=240, window=64,
                               stages=(stage((lk("local", "mlp"), lk("attn", "mlp")), 1),))


def _serve_against_jax(jcfg, cfg, impl):
    """Prefill of PROMPT tokens and STEPS teacher-forced decode steps of the
    port against JAX's ``prefill``/``decode_step`` from JAX's weights and
    nonzero numpy-seeded rank-4 LoRA on the default targets: logits within
    1e-5 at every step → (port cache, JAX cache) after the last step."""
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jm = JModel(jcfg, meshctx=MeshCtx.single_device(), impl=impl)
    key = jax.random.PRNGKey(0)
    jp = jm.init(key, max_seq=PROMPT + STEPS)
    pc = jpeft.PEFTConfig(lora_rank=4, lora_alpha=8.0)
    jl0 = jpeft.init_lora(key, jp, pc)
    rng = np.random.RandomState(1)
    flat_l = {k: (np.asarray(v) if k.endswith("/mask")
                  else (rng.randn(*v.shape) * 0.1).astype(np.float32))
              for k, v in jtrees.flatten(jl0).items()}
    jl = jtrees.map_with_path(lambda p, v: jnp.asarray(flat_l[p]), jl0)
    flat_p = {k: np.asarray(v) for k, v in jtrees.flatten(jp).items()}
    m = Model(cfg, device="cpu", impl=impl)
    tp, tl = bridge.params_from_numpy(flat_p, cfg), bridge.lora_from_numpy(flat_l, cfg)
    toks = np.random.RandomState(2).randint(6, cfg.vocab_size, size=(2, PROMPT + STEPS))
    cl, scale = PROMPT + STEPS, jpeft.lora_scale(pc)
    jlog, jc = jm.prefill(jp, jnp.asarray(toks[:, :PROMPT]), cl, lora=jl, lora_scale=scale)
    tlog, tc = m.prefill(tp, torch.from_numpy(toks[:, :PROMPT]), cl, lora=tl,
                         lora_scale=scale)
    for t in range(STEPS + 1):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL, rtol=0,
                                   err_msg=f"step {t}")
        if t == STEPS:
            break
        nxt = toks[:, PROMPT + t:PROMPT + t + 1]
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), lora=jl, lora_scale=scale)
        tlog, tc = m.decode_step(tp, tc, torch.from_numpy(nxt), lora=tl, lora_scale=scale)
    assert tc["pos"] == int(jc["pos"]) == cl
    return tc, jc


@pytest.mark.parametrize("impl", ["auto", "sparse"])
def test_gemma3_head_width_240_serving_matches_jax(impl):
    """Prefill of 80 tokens (the 64-slot ring wraps) and 8 teacher-forced
    decode steps against JAX's ``prefill``/``decode_step`` with nonzero LoRA
    on wq and wv: logits within 1e-5 at every step, and the caches after the
    last within 1e-4 (RoPE's frequency table, below).  ``impl="sparse"`` runs the global layer block-sparse (block 16,
    local 2, sink 1, stride 4), the local layer keeps its window."""
    jcfg, cfg = _gemma3_cut(jget_config, JLK, JStage), _gemma3_cut(get_config, LK, Stage)
    assert cfg.hd == jcfg.hd == 240
    tc, jc = _serve_against_jax(jcfg, cfg, impl)
    cl = PROMPT + STEPS
    for pi, kind in enumerate(cfg.stages[0].pattern):
        for name, buf in tc["stages"][0][pi].items():
            want = np.asarray(jc["stages"][0][pi][name])
            assert buf.shape == want.shape and buf.shape[-1] == 240
            assert buf.shape[2] == (cfg.window if kind.mixer == "local" else cl)
            # 1e-4: the port's RoPE frequencies are the correctly rounded
            # exp, JAX's XLA exp is an ulp off at some of the 120
            # (test_torch_zoo.py::test_rope_matches_jax), so pos·f differs
            # by up to ~1e-5 at these positions: k is stored rotated, and the
            # global layer's k and v see the local layer's output
            np.testing.assert_allclose(buf.numpy(), want, atol=1e-4, rtol=0,
                                       err_msg=f"layer {pi} {name}")


@pytest.mark.parametrize("impl", ["auto", "sparse"])
def test_gpt2_heads_of_18_serving_matches_jax(impl):
    """gpt2-small at ``.reduced(d_model=72)``: 4 heads of 18, rows that are
    not whole 16-byte chunks (the kernels' element path on the card),
    dense and block-sparse (block 16): logits within 1e-5 of JAX's at every
    step, the caches within 1e-5."""
    jcfg = jget_config("gpt2-small").reduced(d_model=72, vocab=512)
    cfg = get_config("gpt2-small").reduced(d_model=72, vocab=512)
    assert cfg.hd == 18 and cfg.n_heads == 4
    tc, jc = _serve_against_jax(jcfg, cfg, impl)
    for name, buf in tc["stages"][0][0].items():
        want = np.asarray(jc["stages"][0][0][name])
        assert buf.shape == want.shape and buf.shape[-1] == 18
        np.testing.assert_allclose(buf.numpy(), want, atol=TOL, rtol=0, err_msg=name)


# ---------------------------------------------------------------- launcher
def test_launcher_arch_round_heads_of_18_matches_jax(monkeypatch):
    """``launch.train --arch gpt2-small --fl-clients 4 --fl-rounds 2
    --assert-fused --fl-dmodel 72 --device cpu`` (heads of 18) from the JAX
    package's draws (params at ``PRNGKey(0)``, each client's factors at
    ``fold_in(key, 100 + ci)``): the launcher's fused-path checks pass and
    its losses are within 1e-5 of JAX's ``run_arch_round`` on the same
    config."""
    argv = ["--arch", "gpt2-small", "--fl-clients", "4", "--fl-rounds", "2",
            "--assert-fused", "--fl-dmodel", "72", "--device", "cpu"]
    cfg = train.arch_round_config(train.parse_args(argv))
    jcfg = jar.ArchRoundConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                                  if k != "device"})
    mcfg = jget_config(cfg.arch).reduced(d_model=cfg.d_model, repeats=cfg.repeats)
    assert mcfg.hd == 18
    key = jax.random.PRNGKey(cfg.seed)
    params = JModel(mcfg, meshctx=MeshCtx.single_device()).init(key, max_seq=cfg.seq_len)
    pc = jpeft.PEFTConfig(lora_rank=cfg.lora_rank, lora_alpha=2.0 * cfg.lora_rank,
                          lora_targets=jar.arch_lora_targets(mcfg))
    flat = lambda t: {k: np.asarray(v) for k, v in jtrees.flatten(t).items()}  # noqa: E731
    init = {"params": flat(params),
            "lora": [flat(jpeft.init_lora(jax.random.fold_in(key, 100 + ci), params, pc))
                     for ci in range(cfg.n_clients)]}
    want = jar.run_arch_round(jcfg)
    run = arch_round.run_arch_round
    monkeypatch.setattr(arch_round, "run_arch_round",
                        lambda c, **kw: run(c, init=init, **kw))
    got = train.main(argv)
    assert got["dense_merges_in_engine"] == 0 and got["oracle_loss_max_err"] <= 1e-5
    np.testing.assert_allclose(got["loss_per_round"], want["loss_per_round"], atol=TOL, rtol=0)
