"""deepseek-v2's multi-head latent attention in the port against the JAX
package, on the CPU in f32 with numpy-seeded inputs: ``mla_seq`` and the
absorbed ``mla_decode`` with nonzero factors on the four MLA targets (dense
and block-sparse), ``effective_weight``, attention zero-padded to the
compiled tile that runs it (the kernels' zero-fill) with an explicit scale, ``FlashAttention``'s backward at a value width apart from
the q/k width, and the reduced deepseek-v2's loss, prefill and decode.

JAX's eager prefill and decode of deepseek-v2 raise on one device (ROADMAP
queue 3: the prefill cache write), so the model-level oracles are JAX's
jitted ``prefill`` and its full-sequence ``forward`` at each decode
position.  Tolerance 1e-5 throughout (f32; only the order of the sums
differs)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro import trees as jtrees
from repro.configs import get_config as jget_config
from repro.configs.base import MLAConfig as JMLA
from repro.configs.base import SparseAttnConfig as JSparse
from repro.core.arch_round import arch_lora_targets
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.models import mla as jmla
from repro.models import peft as jpeft
from repro.sharding import MeshCtx
from repro_torch import bridge, trees
from repro_torch.configs import MLAConfig, SparseAttnConfig, get_config
from repro_torch.kernels.block_sparse_attn.ops import block_sparse_attention
from repro_torch.kernels.flash_attn.ops import FlashAttention, flash_attention, instance
from repro_torch.kernels.flash_attn.ref import attention_ref
from repro_torch.models import mla, peft
from repro_torch.models.rope import rope_cos_sin
from repro_torch.models.transformer import AUX_WEIGHT, Model
from repro_torch.optim import value_and_grad

TOL = 1e-5
MESH = MeshCtx.single_device()
THETA, EPS = 10_000.0, 1e-5
SPARSE = dict(block_size=16, local_blocks=2, sink_blocks=1, stride=4)
TARGETS = ("wq_a", "wq_b", "wkv_a", "wkv_b")


def _np_tree(t):
    return {k: np.array(v) for k, v in jtrees.flatten(t).items()}


_J_BSA = jattn.block_sparse_attention


def _j_bsa_v_padded(q, k, v, cfg, q_offset=0):
    """JAX's block-sparse attention with v zero-padded to the q/k width and
    the output sliced back: JAX's own reshapes v with q's width and raises
    at v ≠ q/k widths (MLA under ``impl="sparse"``; ROADMAP queue 3)."""
    dv = v.shape[-1]
    vp = jnp.concatenate([v, jnp.zeros(v.shape[:3] + (q.shape[-1] - dv,), v.dtype)], -1)
    return _J_BSA(q, k, vp, cfg, q_offset=q_offset)[..., :dv]


@pytest.fixture
def jax_bsa_substitute(monkeypatch):
    monkeypatch.setattr(jattn, "block_sparse_attention", _j_bsa_v_padded)


def _mla_case(widths, seed=0):
    """JAX's ``init_mla`` (nonzero norm scales) and rank-4 factors with
    nonzero B on the four targets (the last repeat of two masked off), as
    flat numpy, plus the two packages' configs."""
    nope, rope, dv = widths
    kw = dict(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=rope, nope_head_dim=nope,
              v_head_dim=dv)
    p = _np_tree(jmla.init_mla(jax.random.PRNGKey(seed), 64, 4, JMLA(**kw), jnp.float32))
    rng = np.random.RandomState(seed + 1)
    for k in ("q_norm/scale", "kv_norm/scale"):
        p[k] = (rng.randn(*p[k].shape) * 0.1).astype(np.float32)
    lora = {}
    for t in TARGETS:
        din, dout = p[t].shape
        lora[t] = {"a": (rng.randn(din, 4) * din ** -0.5).astype(np.float32),
                   "b": (rng.randn(4, dout) * 0.1).astype(np.float32),
                   "mask": np.ones((1, 1), np.float32)}
    return JMLA(**kw), MLAConfig(**kw), trees.unflatten(p), lora


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("widths", [(64, 16, 64), (16, 16, 16)],
                         ids=["qk80-padded-96", "qk32"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_mla_seq_and_decode_match_jax(widths, sparse, jax_bsa_substitute):
    """``mla_seq`` (causal; under the sparse pattern block-sparse) and
    ``mla_decode`` at every position of a 48-token sequence against JAX's,
    with nonzero factors on the four targets: outputs, c_kv and k_pe within
    1e-5.  (64, 16, 64) runs q/k 80 in the compiled (96, 64) tile.  JAX's sparse
    ``mla_seq`` runs its block-sparse attention with v padded
    (``_j_bsa_v_padded``)."""
    jcfg, cfg, p, lora = _mla_case(widths)
    scale = 2.0
    b, s, h = 2, 48, 4
    x = np.random.RandomState(7).randn(b, s, 64).astype(np.float32)
    jsp = JSparse(**SPARSE) if sparse else None
    tsp = SparseAttnConfig(**SPARSE) if sparse else None
    jp, jl = _to_jax(p), _to_jax(lora)
    tp, tl = _to_torch(p), _to_torch(lora)
    pos = jnp.arange(s)
    jy, (jckv, jkpe) = jmla.mla_seq(jnp.asarray(x), jp, jcfg, h, pos, THETA, EPS,
                                    impl="sparse" if sparse else "dense", sparse_cfg=jsp,
                                    lora=jl, scale=scale)
    rot = rope_cos_sin(torch.arange(s), widths[1], THETA)
    ty, (tckv, tkpe) = mla.mla_seq(torch.from_numpy(x), tp, cfg, h, rot, EPS, sparse=tsp,
                                   lora=tl, scale=scale)
    for got, want in ((ty, jy), (tckv, jckv), (tkpe, jkpe)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    if sparse:
        assert instance(widths[0] + widths[1], widths[2])[0] >= widths[0] + widths[1]
    m0 = peft.dense_merge_count()
    for t in range(s):
        want = jmla.mla_decode(jnp.asarray(x[:, t:t + 1]), jp, jcfg, h, t, THETA, EPS,
                               jckv, jkpe, sparse_cfg=jsp, lora=jl, scale=scale)
        got = mla.mla_decode(torch.from_numpy(x[:, t:t + 1].copy()), tp, cfg, h,
                             rope_cos_sin(torch.tensor([t]), widths[1], THETA), EPS,
                             tckv, tkpe, t + 1, sparse=tsp, lora=tl, scale=scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0,
                                   err_msg=f"position {t}")
    assert peft.dense_merge_count() == m0


@pytest.mark.parametrize("mask", [1.0, 0.0])
def test_effective_weight_matches_jax(mask):
    """``W + s·A·(mask·B)`` within 1e-6 of JAX's; no factors → W itself;
    the mask carries no gradient; ``dense_merge_count`` does not move."""
    rng = np.random.RandomState(3)
    w, a, b = rng.randn(32, 96), rng.randn(32, 4), rng.randn(4, 96)
    lf = {"a": a, "b": b, "mask": np.full((1, 1), mask)}
    lf = {k: v.astype(np.float32) for k, v in lf.items()}
    want = jpeft.effective_weight(jnp.asarray(w, jnp.float32),
                                  {k: jnp.asarray(v) for k, v in lf.items()}, 2.0)
    tlf = {k: torch.from_numpy(v).requires_grad_(k == "mask") for k, v in lf.items()}
    m0 = peft.dense_merge_count()
    got = peft.effective_weight(torch.from_numpy(w.astype(np.float32)), tlf, 2.0)
    assert peft.dense_merge_count() == m0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert not got.requires_grad
    tw = torch.zeros(3)
    assert peft.effective_weight(tw, None, 2.0) is tw
    assert peft.effective_weight(tw, {"a": None}, 2.0) is tw


@pytest.mark.parametrize("dk,dv", [(80, 64), (48, 32)])
@pytest.mark.parametrize("kind", ["causal", "non-causal", "block-sparse"])
def test_padded_attention_matches_dense(dk, dv, kind):
    """q and k zero-padded to the q/k width of the tile ``instance(dk, dv)``
    picks and v to its v width, with the scale of dk, then the first dv
    columns (what the kernels' zero-fill computes on the card), against
    JAX's ``dense_attention`` (and ``block_sparse_attention``, v padded:
    ``_j_bsa_v_padded``) of the unpadded operands, within 1e-5."""
    rng = np.random.RandomState(dk)
    b, s, h = 2, 64, 4
    q, k = (rng.randn(b, s, h, dk).astype(np.float32) for _ in range(2))
    v = rng.randn(b, s, h, dv).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    if kind == "block-sparse":
        want = _j_bsa_v_padded(jq, jk, jv, JSparse(**SPARSE))
    else:
        want = jattn.dense_attention(jq, jk, jv, causal=kind == "causal")
    wk, wv = instance(dk, dv)
    assert (wk, wv) == ((96, 64) if dk == 80 else (64, 64))
    tq, tk = (torch.cat([torch.from_numpy(t), torch.zeros(b, s, h, wk - dk)], -1)
              for t in (q, k))
    tv = torch.cat([torch.from_numpy(v), torch.zeros(b, s, h, wv - dv)], -1)
    if kind == "block-sparse":
        got = block_sparse_attention(tq, tk, tv, SparseAttnConfig(**SPARSE),
                                     scale=dk ** -0.5)
    else:
        got = flash_attention(tq, tk, tv, causal=kind == "causal", scale=dk ** -0.5)
    assert got.shape == (b, s, h, wv)
    got = got[..., :dv]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5)])
def test_flash_function_backward_value_width_apart(causal, window):
    """``FlashAttention``'s backward with v narrower than q/k (q/k 80, v
    64, as MLA passes them at the reduced d 256; scale 80^-1/2, GQA 4 on 2)
    against ``jax.grad`` of the JAX package's dense attention: dq, dk, dv
    within 1e-5."""
    rng = np.random.RandomState(11)
    b, s, h, kh, dk, dv = 2, 20, 4, 2, 80, 64
    q = rng.randn(b, s, h, dk).astype(np.float32)
    k = rng.randn(b, s, kh, dk).astype(np.float32)
    v = rng.randn(b, s, kh, dv).astype(np.float32)
    g = rng.randn(b, s, h, dv).astype(np.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(jattn.dense_attention(
        q, k, v, causal=causal, window=window) * jnp.asarray(g)), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = FlashAttention.apply(attention_ref, tq, tk, tv, causal, window, dk ** -0.5)
    (out * torch.from_numpy(g)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)


# ---------------------------------------------------------------- the model
def _setup(d_model=64, repeats=2, max_seq=64):
    jcfg = jget_config("deepseek-v2-236b").reduced(d_model=d_model, repeats=repeats)
    cfg = get_config("deepseek-v2-236b").reduced(d_model=d_model, repeats=repeats)
    jm = JModel(jcfg, meshctx=MESH)
    key = jax.random.PRNGKey(0)
    jp = jm.init(key, max_seq=max_seq)
    pc = jpeft.PEFTConfig(lora_rank=4, lora_alpha=8.0, lora_targets=arch_lora_targets(jcfg))
    jl0 = jpeft.init_lora(key, jp, pc)
    rng = np.random.RandomState(1)
    flat_l = {k: (v if k.endswith("/mask") else (rng.randn(*v.shape) * 0.1).astype(np.float32))
              for k, v in _np_tree(jl0).items()}
    return dict(cfg=cfg, jm=jm, jp=jp, scale=jpeft.lora_scale(pc), flat_l=flat_l,
                jl=jtrees.map_with_path(lambda p, v: jnp.asarray(flat_l[p]), jl0),
                m=Model(cfg, device="cpu"), p=bridge.params_from_numpy(_np_tree(jp), cfg),
                tl=bridge.lora_from_numpy(flat_l, cfg))


@pytest.mark.parametrize("impl", ["auto", "sparse"])
def test_prefill_and_decode_match_jax(impl, jax_bsa_substitute):
    """Reduced deepseek-v2 (d 64, 2 repeats: the dense-FF prologue, two
    MLA + MoE layers) with nonzero factors on the MLA targets: prefill of 32
    tokens against JAX's jitted ``prefill`` (logits and the {"ckv", "kpe"}
    caches within 1e-5), then 4 teacher-forced decode steps against JAX's
    jitted full-sequence ``forward`` at each position (logits within 1e-5;
    queue 3's substitute for JAX's decode, whose MLA cache write raises).
    ``impl="sparse"``: block-sparse prefill (JAX's with v padded,
    ``_j_bsa_v_padded``) and the sparse position mask in the absorbed
    decode, on both sides."""
    st = _setup()
    cfg, sc = st["cfg"], st["scale"]
    rng = np.random.RandomState(3)
    toks = rng.randint(6, cfg.vocab_size, size=(2, 48))   # the forward: 3 sparse blocks
    jpre = jax.jit(lambda p, t, l: st["jm"].prefill(p, t, 40, impl=impl, lora=l,
                                                    lora_scale=sc))
    jlog, jc = jpre(st["jp"], jnp.asarray(toks[:, :32]), st["jl"])
    jfwd = jax.jit(lambda p, t, l: st["jm"].forward(p, t, impl=impl, lora=l,
                                                    lora_scale=sc)[0])
    h = jfwd(st["jp"], jnp.asarray(toks), st["jl"])
    m0 = peft.dense_merge_count()
    tlog, tc = st["m"].prefill(st["p"], torch.from_numpy(toks[:, :32]), 40, impl=impl,
                               lora=st["tl"], lora_scale=sc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL, rtol=0)
    for si, stage in enumerate(cfg.stages):
        for name in ("ckv", "kpe"):
            np.testing.assert_allclose(tc["stages"][si][0][name].numpy(),
                                       np.asarray(jc["stages"][si][0][name]),
                                       atol=TOL, rtol=0, err_msg=f"{si} {name}")
    for t in range(32, 36):
        tlog, tc = st["m"].decode_step(st["p"], tc, torch.from_numpy(toks[:, t:t + 1]),
                                       impl=impl, lora=st["tl"], lora_scale=sc)
        want = np.asarray(st["jm"].logits(st["jp"], h[:, t]))
        np.testing.assert_allclose(tlog.numpy(), want, atol=TOL, rtol=0,
                                   err_msg=f"position {t}")
    assert tc["pos"] == 36
    assert peft.dense_merge_count() == m0      # MoE ff carries no factors here


def test_lm_loss_and_factor_grads_match_jax():
    """``lm_loss`` with ``AUX_WEIGHT · aux`` (the MoE layers' balance
    loss) within 1e-5 of JAX's jitted loss, and every factor's gradient on
    the four MLA targets within 1e-5, on a ragged mask."""
    st = _setup(repeats=1)
    cfg = st["cfg"]
    rng = np.random.RandomState(2)
    b, s = 3, 12
    toks = rng.randint(6, cfg.vocab_size, size=(b, s + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32),
             "mask": (rng.rand(b, s) < 0.8).astype(np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jg = jax.jit(jax.value_and_grad(lambda lf: st["jm"].lm_loss(
        st["jp"], jb, lora=lf, lora_scale=st["scale"])))(st["jl"])
    _, jaux = jax.jit(lambda: st["jm"].forward(st["jp"], jb["tokens"], lora=st["jl"],
                                               lora_scale=st["scale"]))()
    assert float(jaux) > 0 and AUX_WEIGHT == 0.01
    got, tg = value_and_grad(lambda lf: st["m"].lm_loss(
        st["p"], {k: torch.from_numpy(v) for k, v in batch.items()}, lora=lf,
        lora_scale=st["scale"]), st["tl"])
    assert abs(float(got) - float(want)) <= TOL
    jg, tg = _np_tree(jg), bridge.to_numpy(tg)
    assert {p for p in jg if not p.endswith("/mask")} == set(tg)
    assert {p.split("/")[-2] for p in tg} == set(TARGETS)
    for path, g in tg.items():
        np.testing.assert_allclose(g, jg[path], atol=TOL, rtol=0, err_msg=path)


def test_published_widths_run_the_compiled_instance():
    """At deepseek-v2's published widths q/k are 192 and v 128, a compiled
    tile of their own; at the reduced d 256 (80, 64) runs in the (96, 64)
    tile, at d 128 (48, 32) in (64, 64), at the launcher's d 64 (32, 16) in
    (32, 32)."""
    full = get_config("deepseek-v2-236b").mla
    assert instance(full.nope_head_dim + full.rope_head_dim, full.v_head_dim) == (192, 128)
    for d, want in ((256, (96, 64)), (128, (64, 64)), (64, (32, 32))):
        m = get_config("deepseek-v2-236b").reduced(d_model=d).mla
        assert instance(m.nope_head_dim + m.rope_head_dim, m.v_head_dim) == want
    cut = dataclasses.replace(get_config("deepseek-v2-236b").reduced(d_model=64),
                              mla=MLAConfig(kv_lora_rank=16, q_lora_rank=24,
                                            rope_head_dim=8, nope_head_dim=16,
                                            v_head_dim=16))
    out = Model(cut, device="cpu")
    assert out.init(torch.Generator().manual_seed(0))["stages"][0]["layers"][0][
        "mixer"]["wkv_b"].shape == (1, 16, 4 * 32)
