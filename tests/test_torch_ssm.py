"""The port's Mamba-2 path against the JAX package's, in f32 on the CPU with
numpy-seeded inputs: the SSD scan (plain version vs the JAX chunked scan
with an initial state and ragged lengths, and vs the Pallas kernel in
interpret mode; the CUDA kernel's state-passing decomposition against
both), the decode recurrence, the mixer with LoRA factors, and reduced
mamba2-1.3b served end to end.  Tolerances: 5e-4 / 1e-3 for the
scan (``tests/test_kernels.py``), 1e-4 for mixer outputs, logits and
caches (``test_mixer_factored.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import trees as jtrees
from repro.configs import get_config as jget_config
from repro.kernels.ssd_chunk.ops import ssd_scan as j_ssd_kernel
from repro.models import Model as JModel
from repro.models import peft as jpeft
from repro.models import ssm as j_ssm
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_chunk.ops import ssd_scan
from repro_torch.kernels.ssd_chunk.ref import ssd_state_passing_ref
from repro_torch.models import ssm
from repro_torch.models.transformer import Model

ATOL = 1e-4
PROMPT, N_DECODE = 80, 4     # 2.5 scan chunks of 32 in the reduced config


def _scan_inputs(seed, b, s, h, p, n, h0=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h))).astype(np.float32)   # softplus
    a = (-np.exp(rng.randn(h) * 0.3)).astype(np.float32)
    bm = (rng.randn(b, s, h, n) * 0.5).astype(np.float32)
    cm = (rng.randn(b, s, h, n) * 0.5).astype(np.float32)
    state = (rng.randn(b, h, p, n) * 0.5).astype(np.float32) if h0 else None
    return x, dt, a, bm, cm, state


def _close(got, want, atol=5e-4, rtol=1e-3):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def test_segsum_matches_jax():
    a = np.random.RandomState(0).randn(3, 7).astype(np.float32)
    np.testing.assert_allclose(ssm.segsum(torch.from_numpy(a)).numpy(),
                               np.asarray(j_ssm.segsum(jnp.asarray(a))), atol=1e-6)


@pytest.mark.parametrize("s,chunk,h0", [(128, 32, False), (100, 32, True), (80, 32, False),
                                        (20, 64, True), (300, 256, True)])
def test_ssd_chunk_scan_matches_jax(s, chunk, h0):
    x, dt, a, bm, cm, state = _scan_inputs(1, 2, s, 3, 16, 8, h0=h0)
    jy, jh = j_ssm.ssd_chunk_scan(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk,
                                  h0=None if state is None else jnp.asarray(state))
    y, hf = ssm.ssd_chunk_scan(*map(torch.from_numpy, (x, dt, a, bm, cm)), chunk,
                               h0=None if state is None else torch.from_numpy(state))
    _close(y.numpy(), jy)
    _close(hf.numpy(), jh)


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("p,n", [(16, 8), (32, 16)])
def test_ssd_scan_matches_pallas_kernel(chunk, p, n):
    """The wrapper (its plain version on CPU tensors) against the TPU kernel
    in interpret mode, at the shapes of ``test_ssd_chunk_sweep``."""
    x, dt, a, bm, cm, _ = _scan_inputs(3, 2, 128, 2, p, n)
    jy, jh = j_ssd_kernel(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk=chunk)
    before = ssd_scan.launches
    y, hf = ssd_scan(*map(torch.from_numpy, (x, dt, a, bm, cm)), chunk=chunk)
    assert ssd_scan.launches == before
    _close(y.numpy(), jy)
    _close(hf.numpy(), jh)


def test_ssd_scan_reads_strided_views():
    """B and C as a stride-0 broadcast of one group (the mixer's layout) and
    x as a slice of a wider row give the same result as dense copies."""
    x, dt, a, bm, cm, _ = _scan_inputs(4, 2, 40, 4, 16, 8)
    wide = torch.from_numpy(np.concatenate([x.reshape(2, 40, 64)] * 2, -1))
    xs = wide[..., :64].reshape(2, 40, 4, 16)
    b1 = torch.from_numpy(bm[:, :, :1]).expand(2, 40, 4, 8)
    c1 = torch.from_numpy(cm[:, :, :1]).expand(2, 40, 4, 8)
    assert b1.stride(2) == 0 and not xs.is_contiguous()
    y, hf = ssd_scan(xs, torch.from_numpy(dt), torch.from_numpy(a), b1, c1, chunk=16)
    y2, h2 = ssd_scan(torch.from_numpy(x), torch.from_numpy(dt), torch.from_numpy(a),
                      b1.contiguous(), c1.contiguous(), chunk=16)
    torch.testing.assert_close(y, y2, atol=0, rtol=0)
    torch.testing.assert_close(hf, h2, atol=0, rtol=0)


def _shared_bc(bm, cm):
    """B and C as one group broadcast over the heads: the numpy arrays with
    head 0 repeated (for JAX) and the torch stride-0 views (the mixer's)."""
    b, s, h, n = bm.shape
    np_b, np_c = (np.repeat(t[:, :, :1], h, 2) for t in (bm, cm))
    t_b, t_c = (torch.from_numpy(t[:, :, :1].copy()).expand(b, s, h, n) for t in (bm, cm))
    return np_b, np_c, t_b, t_c


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_state_passing_ref_matches_pallas_kernel(chunk, shared):
    """The CUDA kernel's decomposition (chunk states, state pass, outputs
    from the starting states; C·Bᵀ once per (batch, chunk) when shared)
    against the TPU kernel in interpret mode."""
    x, dt, a, bm, cm, _ = _scan_inputs(9, 2, 128, 3, 16, 8)
    tb, tc = torch.from_numpy(bm), torch.from_numpy(cm)
    if shared:
        bm, cm, tb, tc = _shared_bc(bm, cm)
    jy, jh = j_ssd_kernel(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk=chunk)
    y, hf = ssd_state_passing_ref(torch.from_numpy(x), torch.from_numpy(dt),
                                  torch.from_numpy(a), tb, tc, chunk=chunk, shared_cb=shared)
    _close(y.numpy(), jy)
    _close(hf.numpy(), jh)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("s,chunk,h0", [(100, 256, True), (300, 256, True), (300, 256, False),
                                        (40, 64, False), (512, 32, False), (512, 32, True),
                                        (200, 64, True)])
def test_state_passing_ref_matches_jax_scan(s, chunk, h0, shared):
    """The decomposition against the JAX chunked scan with an initial
    state, ragged lengths (100 and 300 at chunk 256), S < chunk (100, 40)
    and 16 chunks (512 at 32)."""
    x, dt, a, bm, cm, state = _scan_inputs(10, 2, s, 3, 16, 8, h0=h0)
    tb, tc = torch.from_numpy(bm), torch.from_numpy(cm)
    if shared:
        bm, cm, tb, tc = _shared_bc(bm, cm)
    jy, jh = j_ssm.ssd_chunk_scan(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk,
                                  h0=None if state is None else jnp.asarray(state))
    y, hf = ssd_state_passing_ref(torch.from_numpy(x), torch.from_numpy(dt),
                                  torch.from_numpy(a), tb, tc, chunk=chunk,
                                  h0=None if state is None else torch.from_numpy(state),
                                  shared_cb=shared)
    _close(y.numpy(), jy)
    _close(hf.numpy(), jh)


def test_ssd_decode_step_matches_jax():
    rng = np.random.RandomState(5)
    xt, dtt = rng.randn(2, 3, 16).astype(np.float32), np.abs(rng.randn(2, 3)).astype(np.float32)
    a = -np.abs(rng.randn(3)).astype(np.float32)
    bt, ct = rng.randn(2, 3, 8).astype(np.float32), rng.randn(2, 3, 8).astype(np.float32)
    h = rng.randn(2, 3, 16, 8).astype(np.float32)
    jy, jh = j_ssm.ssd_decode_step(*map(jnp.asarray, (xt, dtt, a, bt, ct, h)))
    y, hn = ssm.ssd_decode_step(*map(torch.from_numpy, (xt, dtt, a, bt, ct, h)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(hn.numpy(), np.asarray(jh), atol=1e-5)


@pytest.fixture(scope="module")
def mixer():
    """One reduced mamba2 mixer's JAX-initialized params (nonzero conv bias,
    dt bias and a_log) and nonzero LoRA factors on in_proj and out_proj."""
    cfg = get_config("mamba2-1.3b").reduced(d_model=64).ssm
    key = jax.random.PRNGKey(0)
    jp = j_ssm.init_mamba(key, 64, cfg, jnp.float32)
    rng = np.random.RandomState(6)
    flat = {k: np.asarray(v) + (0 if k in ("in_proj", "conv_w", "out_proj")
                                else (rng.randn(*np.shape(v)) * 0.1).astype(np.float32))
            for k, v in jtrees.flatten(jp).items()}
    flat_l = {}
    for w, (din, dout) in (("in_proj", flat["in_proj"].shape),
                           ("out_proj", flat["out_proj"].shape)):
        flat_l[f"{w}/a"] = (rng.randn(din, 4) * din ** -0.5).astype(np.float32)
        flat_l[f"{w}/b"] = (rng.randn(4, dout) * 0.05).astype(np.float32)
        flat_l[f"{w}/mask"] = np.ones((1, 1), np.float32)
    x = rng.randn(2, 40, 64).astype(np.float32)
    return cfg, flat, flat_l, x


def _as(flat, fn):
    from repro_torch import trees
    return trees.unflatten({k: fn(v) for k, v in flat.items()})


def test_causal_conv_matches_jax(mixer):
    _, flat, _, x = mixer
    c = flat["conv_w"].shape[1]
    xbc = np.random.RandomState(7).randn(2, 9, c).astype(np.float32)
    want = j_ssm._causal_conv(jnp.asarray(xbc), jnp.asarray(flat["conv_w"]),
                              jnp.asarray(flat["conv_b"]))
    got = ssm._causal_conv(torch.from_numpy(xbc), torch.from_numpy(flat["conv_w"]),
                           torch.from_numpy(flat["conv_b"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_mamba_seq_and_decode_with_factors_match_jax(mixer):
    """The full mixer over 40 tokens (a tail chunk), then two decode steps
    from its state and conv inputs."""
    cfg, flat, flat_l, x = mixer
    jp, jl = _as(flat, jnp.asarray), _as(flat_l, jnp.asarray)
    tp, tl = _as(flat, torch.from_numpy), _as(flat_l, torch.from_numpy)
    jy, (jh, jconv) = j_ssm.mamba_seq(jnp.asarray(x), jp, cfg, 64, 1e-5, lora=jl,
                                      scale=2.0, backend="pallas")
    y, (h, conv) = ssm.mamba_seq(torch.from_numpy(x), tp, cfg, 64, 1e-5, lora=tl, scale=2.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(conv.numpy(), np.asarray(jconv), atol=ATOL)
    xt = np.random.RandomState(8).randn(2, 1, 64).astype(np.float32)
    for _ in range(2):
        jy, (jh, jconv) = j_ssm.mamba_decode(jnp.asarray(xt), jp, cfg, 64, 1e-5, jh, jconv,
                                             lora=jl, scale=2.0, backend="pallas")
        y, (h, conv) = ssm.mamba_decode(torch.from_numpy(xt), tp, cfg, 64, 1e-5, h, conv,
                                        lora=tl, scale=2.0)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)
        np.testing.assert_allclose(conv.numpy(), np.asarray(jconv), atol=ATOL)
        xt = np.array(jy)


def test_mamba_seq_continues_from_state(mixer):
    """A prompt split in two — the second half seeded with the first half's
    SSM state and conv inputs (``h0``, ``conv0``) — gives the one-pass
    output, as in the JAX mixer."""
    cfg, flat, _, x = mixer
    tp = _as(flat, torch.from_numpy)
    y, (h, conv) = ssm.mamba_seq(torch.from_numpy(x), tp, cfg, 64, 1e-5)
    y1, (h1, c1) = ssm.mamba_seq(torch.from_numpy(x[:, :24]), tp, cfg, 64, 1e-5)
    y2, (h2, c2) = ssm.mamba_seq(torch.from_numpy(x[:, 24:]), tp, cfg, 64, 1e-5, h0=h1,
                                 conv0=c1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=ATOL, rtol=0)
    torch.testing.assert_close(h2, h, atol=ATOL, rtol=0)
    jy2, (jh2, _) = j_ssm.mamba_seq(jnp.asarray(x[:, 24:]), _as(flat, jnp.asarray), cfg, 64,
                                    1e-5, h0=jnp.asarray(h1.numpy()),
                                    conv0=jnp.asarray(c1.numpy()))
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), atol=ATOL)


@pytest.fixture(scope="module")
def mamba_setup():
    jcfg = jget_config("mamba2-1.3b").reduced(repeats=2)
    cfg = get_config("mamba2-1.3b").reduced(repeats=2)
    jmodel = JModel(jcfg, opts={"lora_backend": "pallas"})
    key = jax.random.PRNGKey(0)
    jparams = jmodel.init(key, max_seq=PROMPT + N_DECODE)
    pc = jpeft.PEFTConfig(lora_rank=4, lora_alpha=8.0)
    jlora0 = jpeft.init_lora(key, jparams, pc)
    rng = np.random.RandomState(1)
    flat_l = {k: (np.asarray(v) if k.endswith("/mask")
                  else (rng.randn(*v.shape) * 0.05).astype(np.float32))
              for k, v in jtrees.flatten(jlora0).items()}
    jlora = jtrees.map_with_path(lambda p, v: jnp.asarray(flat_l[p]), jlora0)
    flat_p = {k: np.asarray(v) for k, v in jtrees.flatten(jparams).items()}
    prompts = np.random.RandomState(2).randint(6, jcfg.vocab_size, size=(2, PROMPT))
    scale = jpeft.lora_scale(pc)
    jlg, jcache = jmodel.prefill(jparams, jnp.asarray(prompts), cache_len=PROMPT + N_DECODE,
                                 lora=jlora, lora_scale=scale)
    steps = [(jlg, jcache)]
    for _ in range(N_DECODE):
        tok = np.asarray(jnp.argmax(jlg, -1))[:, None].astype(np.int32)
        jlg, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok), lora=jlora,
                                         lora_scale=scale)
        steps.append((jlg, jcache))
    return dict(cfg=cfg, flat_p=flat_p, flat_l=flat_l, jparams=jparams, prompts=prompts,
                scale=scale,
                steps=[(np.asarray(lg), [{n: np.asarray(t) for n, t in e.items()}
                                         for e in c["stages"][0]]) for lg, c in steps])


def test_mamba_serving_matches_jax(mamba_setup):
    """Reduced mamba2-1.3b (2 layers, d 256, 32 heads of 16, state 16, chunk
    32): prefill over an 80-token prompt and 4 decode steps, logits and the
    h / conv caches, with nonzero LoRA factors on in_proj and out_proj."""
    s = mamba_setup
    cfg = s["cfg"]
    model = Model(cfg, device="cpu")
    params = bridge.params_from_numpy(s["flat_p"], cfg)
    lora = bridge.lora_from_numpy(s["flat_l"], cfg)
    assert {p.rsplit("/", 2)[-2] for p in s["flat_l"]} == {"in_proj", "out_proj"}
    lg, cache = model.prefill(params, torch.from_numpy(s["prompts"]), PROMPT + N_DECODE,
                              lora=lora, lora_scale=s["scale"])
    bufs = [(e["h"].data_ptr(), e["conv"].data_ptr()) for e in cache["stages"][0]]
    for t in range(N_DECODE + 1):
        if t:
            tok = torch.from_numpy(s["steps"][t - 1][0].argmax(-1)[:, None])
            lg, cache = model.decode_step(params, cache, tok, lora=lora,
                                          lora_scale=s["scale"])
        jlg, jentries = s["steps"][t]
        np.testing.assert_allclose(lg.numpy(), jlg, atol=ATOL)
        for e, je in zip(cache["stages"][0], jentries):
            assert e["h"].dtype == torch.float32
            for name in ("h", "conv"):
                np.testing.assert_allclose(e[name].numpy(), je[name], atol=ATOL)
    # the states are updated in place
    assert bufs == [(e["h"].data_ptr(), e["conv"].data_ptr()) for e in cache["stages"][0]]


def test_mamba_init_mirrors_jax_tree(mamba_setup):
    """The port's own init has the JAX tree's paths, shapes and dtypes (no
    position table: mamba2 reads no positions) and its constant leaves."""
    s = mamba_setup
    mine = bridge.to_numpy(Model(s["cfg"], device="cpu").init(torch.Generator().manual_seed(0)))
    assert {k: (v.shape, v.dtype) for k, v in mine.items()} == {
        k: (v.shape, v.dtype) for k, v in s["flat_p"].items()}
    for k, v in mine.items():
        if k.endswith(("a_log", "d_skip", "dt_bias", "conv_b", "scale")):
            np.testing.assert_array_equal(v, s["flat_p"][k], err_msg=k)
