"""The decoder arch zoo in the port against the JAX package, on the CPU in
f32 with numpy-seeded inputs: the configs, RoPE, the MoE feed-forward, the
seven newly ported architectures' losses, factor gradients, prefill and
decode (gemma3's ring caches, internvl2's prefix), the refusals of what is
not ported yet, and ``SSDScan``'s backward."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro import trees as jtrees
from repro.configs import get_config as jget_config
from repro.configs import list_configs as jlist_configs
from repro.core.arch_round import arch_lora_targets
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro.models import peft as jpeft
from repro.models import rope as jrope
from repro.sharding import MeshCtx
from repro_torch import bridge, configs, trees
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_chunk.ops import SSDScan
from repro_torch.kernels.ssd_chunk.ref import ssd_ref
from repro_torch.models import moe, peft, rope
from repro_torch.models.transformer import Model
from repro_torch.optim import value_and_grad

NEW = ("llama3.2-1b", "tinyllama-1.1b", "deepseek-67b", "gemma3-12b", "internvl2-26b",
       "dbrx-132b", "jamba-v0.1-52b")
MESH = MeshCtx.single_device()


def _np_tree(t):
    return {k: np.array(v) for k, v in jtrees.flatten(t).items()}


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("name", jlist_configs())
def test_config_matches_jax(name):
    """Every config and its reduced variants equal the JAX package's, field
    for field; the registry and the ASSIGNED / PAPER_OWN / SHAPES tables
    are the same."""
    assert configs.list_configs() == jlist_configs()
    j = jget_config(name)
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(j)
    for kw in ({}, dict(d_model=32, repeats=2), dict(d_model=256, repeats=2, n_experts=2)):
        assert dataclasses.asdict(get_config(name).reduced(**kw)) == \
            dataclasses.asdict(j.reduced(**kw))
    from repro.configs import base as jbase
    assert configs.ASSIGNED == jbase.ASSIGNED and configs.PAPER_OWN == jbase.PAPER_OWN
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}


# ---------------------------------------------------------------- RoPE
@pytest.mark.parametrize("theta", [1e4, 5e5, 1e6])
def test_rope_matches_jax(theta):
    """The frequency table is the correctly rounded f32 exp of JAX's f32
    exponent and within one ulp of JAX's (XLA's CPU exp is not correctly
    rounded at a few i).  ``apply_rope`` at positions 0–4096, (S,) and
    (B, S): within 1e-6 of JAX's on every pair whose frequency equals
    JAX's; on the others within what the two f32 angles pos·f differ by,
    |Δangle|·(|x1| + |x2|) + 1e-6."""
    half, hd = 32, 64
    jarg = np.asarray(-jnp.log(theta) * jnp.arange(half, dtype=jnp.float32) / half)
    jf = np.asarray(jnp.exp(jnp.asarray(jarg)))
    tf = rope._freqs(half, float(theta), torch.device("cpu")).numpy()
    np.testing.assert_array_equal(tf, np.exp(jarg.astype(np.float64)).astype(np.float32))
    np.testing.assert_array_max_ulp(tf, jf, maxulp=1)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4097, 3, hd).astype(np.float32)
    for pos in (np.arange(4097), rng.randint(0, 4097, size=(2, 4097))):
        want = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
        got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
        same = np.concatenate([tf == jf] * 2)                        # (hd,)
        err = np.abs(got - want)
        assert err[..., same].max() <= 1e-6
        p = (pos if pos.ndim == 2 else np.broadcast_to(pos, (2, 4097))).astype(np.float32)
        dang = np.abs((p[..., None] * tf).astype(np.float64) - p[..., None] * jf)
        dang = np.concatenate([dang] * 2, -1)[..., None, :]          # (2, S, 1, hd)
        amp = np.abs(x) + np.abs(np.concatenate([x[..., half:], x[..., :half]], -1))
        assert (err <= dang * amp * 1.01 + 1e-6).all()


# ---------------------------------------------------------------- MoE
def _moe_case(seed, b, s, d, e, k, f, shared):
    cfg = dataclasses.replace(jget_config("dbrx-132b").moe, n_experts=e, top_k=k, d_ff=f,
                              n_shared_experts=shared, capacity_factor=1.25)
    params = _np_tree(jmoe.init_moe(jax.random.PRNGKey(seed), d, cfg, "swiglu", jnp.float32))
    x = np.random.RandomState(seed).randn(b, s, d).astype(np.float32)
    return cfg, params, x


@pytest.mark.parametrize("case", ["dropless", "dropless-shared", "dropping"])
def test_moe_ffn_matches_jax(case):
    """``moe_ffn`` against JAX's at ``MeshCtx.single_device()``: y within
    1e-5 and the balance loss within 1e-6.  Dropless (T·k ≤ 4096: C = T·k)
    with and without a shared expert, and capacity dropping (B 2, S 1100, k
    2, E 4: T·k 4400 > 4096, C 1376, the router biased to expert 0 so that
    it overflows): the dispatch table equals the one
    JAX's sort-based ``_bucket_table`` builds from the same choices, so the
    same (token, slot) pairs drop, and some do."""
    b, s = (2, 1100) if case == "dropping" else (2, 24)
    cfg, params, x = _moe_case(1, b, s, 32, 4, 2, 48, int(case == "dropless-shared"))
    if case == "dropping":      # expert 0 favoured: over its capacity, some drop
        params["router"][:, 0] += 0.3
        x += 0.5
    want_y, want_aux = jax.jit(lambda x, p: jmoe.moe_ffn(x, p, cfg, MESH, "swiglu"))(
        jnp.asarray(x), trees.unflatten({k: jnp.asarray(v) for k, v in params.items()}))
    tp = trees.unflatten({k: torch.from_numpy(v) for k, v in params.items()})
    got_y, got_aux = moe.moe_ffn(torch.from_numpy(x), tp, cfg, "swiglu")
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5, rtol=0)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6
    t = b * s
    c = moe._capacity(t, cfg)
    assert c == jmoe._capacity(t, cfg) == (t * 2 if case != "dropping" else 1376)
    _, w, idx = moe.route(torch.from_numpy(x).reshape(t, -1), tp["router"], cfg)
    table, _ = moe.dispatch(idx, w, cfg.n_experts, c)
    jtable = np.asarray(jmoe._bucket_table(jnp.asarray(idx.reshape(-1).numpy()),
                                           cfg.n_experts, c)) // cfg.top_k
    np.testing.assert_array_equal(table.numpy(), jtable)
    kept = int((table < t).sum())
    assert (kept < t * cfg.top_k) == (case == "dropping")


# ---------------------------------------------------------------- per arch
def _random_factors(flat_lora, seed):
    rng = np.random.RandomState(seed)
    return {k: (v if k.endswith("/mask") else (rng.randn(*v.shape) * 0.1).astype(np.float32))
            for k, v in flat_lora.items()}


def _setup(arch, d_model=32, repeats=2, max_seq=128, extra_targets=()):
    """Reduced configs of both packages, JAX's params in both, and nonzero
    numpy-seeded LoRA factors (JAX tree ``jl``, flat ``flat_l``) on the
    arch round's targets plus ``extra_targets``."""
    jcfg = jget_config(arch).reduced(d_model=d_model, repeats=repeats)
    cfg = get_config(arch).reduced(d_model=d_model, repeats=repeats)
    jm = JModel(jcfg, meshctx=MESH)
    key = jax.random.PRNGKey(0)
    jp = jm.init(key, max_seq=max_seq)
    pc = jpeft.PEFTConfig(lora_rank=4, lora_alpha=8.0,
                          lora_targets=arch_lora_targets(jcfg) + tuple(extra_targets))
    jl0 = jpeft.init_lora(key, jp, pc)
    flat_l = _random_factors(_np_tree(jl0), 1)
    flat_p = _np_tree(jp)
    return dict(cfg=cfg, jm=jm, jp=jp, flat_l=flat_l, scale=jpeft.lora_scale(pc),
                jl=jtrees.map_with_path(lambda p, v: jnp.asarray(flat_l[p]), jl0),
                m=Model(cfg, device="cpu"), p=bridge.params_from_numpy(flat_p, cfg))


@pytest.mark.parametrize("arch", NEW)
def test_lm_loss_and_factor_grads_match_jax(arch):
    """``lm_loss`` (the MoE balance loss included, AUX_WEIGHT 0.01) within
    1e-5 of JAX's and every LoRA factor's gradient within 1e-5, with
    nonzero factors on the arch round's targets (and on the MoE experts'
    ``wg``, which both packages dense-merge per layer); a ragged mask, and
    internvl2's patches."""
    moe_arch = get_config(arch).moe is not None
    st = _setup(arch, extra_targets=("ff/wg",) if moe_arch else ())
    cfg = st["cfg"]
    rng = np.random.RandomState(2)
    b, s = 3, 12
    toks = rng.randint(6, cfg.vocab_size, size=(b, s + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32),
             "mask": (rng.rand(b, s) < 0.8).astype(np.float32)}
    if cfg.n_prefix_tokens:
        batch["patches"] = rng.randn(b, cfg.n_prefix_tokens, cfg.prefix_dim).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # jitted: JAX's eager gradient through jamba's mamba layer raises a
    # ShardingTypeError at its cache write (ROADMAP queue 3's first site)
    want, jg = jax.jit(jax.value_and_grad(lambda lf: st["jm"].lm_loss(
        st["jp"], jb, lora=lf, lora_scale=st["scale"])))(st["jl"])
    tl = bridge.lora_from_numpy(st["flat_l"], cfg)
    m0 = peft.dense_merge_count()
    got, tg = value_and_grad(lambda lf: st["m"].lm_loss(
        st["p"], {k: torch.from_numpy(v) for k, v in batch.items()}, lora=lf,
        lora_scale=st["scale"]), tl)
    assert (peft.dense_merge_count() > m0) == moe_arch
    assert abs(float(got) - float(want)) <= 1e-5
    jg = _np_tree(jg)
    tg = bridge.to_numpy(tg)
    for path, g in tg.items():
        np.testing.assert_allclose(g, jg[path], atol=1e-5, rtol=0, err_msg=path)
    assert {p for p in jg if not p.endswith("/mask")} == set(tg)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-12b", "internvl2-26b"])
def test_prefill_decode_matches_jax(arch):
    """Prefill of 70 tokens (cache prefix + 76) and 6 teacher-forced decode
    steps against JAX's ``prefill``/``decode_step`` with nonzero LoRA:
    logits within 1e-5 at every step; the caches within 1e-5 after the last
    step (gemma3's two ``local`` layers hold rings of 64 slots, wrapped in
    prefill and decode, position p at slot p mod 64); ``pos`` counts
    internvl2's 8 prefix positions."""
    st = _setup(arch)
    cfg = st["cfg"]
    rng = np.random.RandomState(3)
    b, s, steps = 2, 70, 6
    toks = rng.randint(6, cfg.vocab_size, size=(b, s + steps))
    jkw, tkw = {}, {}
    if cfg.n_prefix_tokens:
        pa = rng.randn(b, cfg.n_prefix_tokens, cfg.prefix_dim).astype(np.float32)
        jkw["patches"], tkw["patches"] = jnp.asarray(pa), torch.from_numpy(pa)
    cl = cfg.n_prefix_tokens + s + steps
    jl = st["jl"]
    tl = bridge.lora_from_numpy(st["flat_l"], cfg)
    lk = dict(lora_scale=st["scale"])
    jlog, jc = st["jm"].prefill(st["jp"], jnp.asarray(toks[:, :s]), cl, lora=jl, **lk, **jkw)
    tlog, tc = st["m"].prefill(st["p"], torch.from_numpy(toks[:, :s]), cl, lora=tl, **lk, **tkw)
    for t in range(steps + 1):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5, rtol=0)
        if t == steps:
            break
        nxt = toks[:, s + t:s + t + 1]
        jlog, jc = st["jm"].decode_step(st["jp"], jc, jnp.asarray(nxt), lora=jl, **lk)
        tlog, tc = st["m"].decode_step(st["p"], tc, torch.from_numpy(nxt), lora=tl, **lk)
    assert tc["pos"] == int(jc["pos"]) == cl
    for pi, kind in enumerate(cfg.stages[0].pattern):
        for name, buf in tc["stages"][0][pi].items():
            want = np.asarray(jc["stages"][0][pi][name])
            assert buf.shape == want.shape
            assert buf.shape[2] == (min(cl, cfg.window) if kind.mixer == "local" else cl)
            np.testing.assert_allclose(buf.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ["dbrx-132b", "jamba-v0.1-52b"])
def test_decode_matches_jax_forward(arch):
    """MoE and the hybrid: JAX's prefill cannot write their caches (its
    cache write raises on one device, ROADMAP queue 3), so the port's
    prefill of 33 tokens and 2 decode steps are held to JAX's full-sequence
    ``forward`` logits at those positions at ``test_configs_smoke.py``'s
    2e-4 / 2e-3."""
    st = _setup(arch)
    cfg = st["cfg"]
    toks = np.random.RandomState(4).randint(6, cfg.vocab_size, size=(2, 35))
    # one causal forward over all 35 tokens: position t's logits are those
    # of the forward over the first t + 1 (MoE is dropless at these sizes)
    h, _ = st["jm"].forward(st["jp"], jnp.asarray(toks))
    tlog, tc = st["m"].prefill(st["p"], torch.from_numpy(toks[:, :33]), 64)
    for t in range(33, 36):
        want = np.asarray(st["jm"].logits(st["jp"], h[:, t - 1]))
        np.testing.assert_allclose(tlog.numpy(), want, atol=2e-4, rtol=2e-3)
        if t < 35:
            tlog, tc = st["m"].decode_step(st["p"], tc, torch.from_numpy(toks[:, t:t + 1]))
    assert tc["pos"] == 35


@pytest.mark.parametrize("arch", ["dbrx-132b", "internvl2-26b", "jamba-v0.1-52b"])
def test_bridge_round_trip_of_new_leaves(arch):
    """The new leaves — the f32 router, the (E, …) expert slabs, the
    projector, factors on the experts — cross the bridge bit-exactly, and
    the port's own init has JAX's paths, shapes and dtypes."""
    st = _setup(arch, extra_targets=("ff/wg",))
    flat_p = _np_tree(st["jp"])
    for flat, load in ((flat_p, bridge.params_from_numpy), (st["flat_l"], bridge.lora_from_numpy)):
        back = bridge.to_numpy(load(flat, st["cfg"]))
        assert back.keys() == flat.keys()
        for k, v in flat.items():
            assert back[k].dtype == v.dtype
            np.testing.assert_array_equal(back[k], v)
    own = bridge.to_numpy(st["m"].init(torch.Generator().manual_seed(0), max_seq=128))
    assert {k: (v.shape, v.dtype) for k, v in own.items()} == \
        {k: (v.shape, v.dtype) for k, v in flat_p.items()}


def test_unported_archs_name_the_next_slice():
    """Every config builds, deepseek-v2 (MLA) and whisper (an
    encoder-decoder stack) included, and the port's own init of those two
    has the JAX package's paths, shapes and dtypes (whisper's ``enc_pos``,
    ``enc_norm`` and ``dec`` layers' ``cross``/``norm_x``; MLA's seven
    leaves)."""
    for arch in configs.list_configs():
        Model(get_config(arch).reduced(), device="cpu")
    for arch in ("deepseek-v2-236b", "whisper-base"):
        jcfg = jget_config(arch).reduced(d_model=32, repeats=2)
        want = _np_tree(JModel(jcfg, meshctx=MESH).init(jax.random.PRNGKey(0), max_seq=64))
        own = bridge.to_numpy(Model(get_config(arch).reduced(d_model=32, repeats=2),
                                    device="cpu").init(torch.Generator().manual_seed(0),
                                                       max_seq=64))
        assert {k: (v.shape, v.dtype) for k, v in own.items()} == \
            {k: (v.shape, v.dtype) for k, v in want.items()}


# ---------------------------------------------------------------- SSDScan
def test_ssd_scan_function_backward_matches_autograd():
    """``SSDScan`` with ``ssd_ref`` as its forward: the input gradients
    (x, dt, a, h0, and B/C through their stride-0 broadcast of one conv row
    over the heads, as the mixer passes them) within 1e-6 of autograd of
    ``ssd_ref``, for cotangents on both outputs; with h0 absent too."""
    g = torch.Generator().manual_seed(0)
    b, s, h, p, n, chunk = 2, 40, 4, 16, 16, 16
    row = torch.randn(b, s, h * p + 2 * n, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=g))
    a = -torch.exp(torch.randn(h, generator=g) * 0.3)
    h0 = torch.randn(b, h, p, n, generator=g) * 0.5
    gy = torch.randn(b, s, h, p, generator=g)
    gh = torch.randn(b, h, p, n, generator=g)

    def grads(fn, with_h0):
        ins = [t.clone().requires_grad_() for t in (row, dt, a, h0)]
        r = ins[0]
        x = r[..., :h * p].reshape(b, s, h, p)
        bm = r[..., h * p:h * p + n].reshape(b, s, 1, n).expand(b, s, h, n)
        cm = r[..., h * p + n:].reshape(b, s, 1, n).expand(b, s, h, n)
        y, hf = fn(x, ins[1], ins[2], bm, cm, ins[3] if with_h0 else None)
        wrt = ins if with_h0 else ins[:3]
        return torch.autograd.grad((y * gy).sum() + (hf * gh).sum(), wrt)

    for with_h0 in (True, False):
        got = grads(lambda *t: SSDScan.apply(ssd_ref, chunk, *t), with_h0)
        want = grads(lambda x, d, aa, bm, cm, hh: ssd_ref(x, d, aa, bm, cm, chunk=chunk,
                                                          h0=hh), with_h0)
        for gt, gw in zip(got, want):
            np.testing.assert_allclose(gt.numpy(), gw.numpy(), atol=1e-6, rtol=0)
