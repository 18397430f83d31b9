"""Any LoRA rank and any SSD state shape in the port, against the JAX
package on the CPU (f32, numpy-seeded inputs, the JAX package's own
weights carried across the bridge):

* ``lora_matmul`` above rank 32 against the TPU kernel in interpret mode,
  within 1e-5 relative (of the largest output, and elementwise);
* reduced llama3.2-1b served by ``launch/serve.py`` with rank-64 LoRA on
  wq/wv against JAX's prefill and decode, logits within 1e-5
  (``test_torch_widths.py``'s tolerance);
* one ``make_peft_step`` at rank 64 against JAX's: loss and trainables
  within 1e-5 (AdamW's first step exempts elements whose gradient is below
  1e-7 in magnitude, as ``test_torch_tp.py`` does: rounding alone moves
  them by up to lr);
* the SSD cover (``ssd_cover`` with the plain scan as its per-block
  function) at (P, N) outside the compiled pairs against the TPU kernel in
  interpret mode (no initial state; the kernel takes none) and the JAX
  chunked scan (with h0), B and C the mixer's stride-0 broadcast: y and
  h_final within 1e-5 of the largest magnitude;
* the cover rule's choices and its padded work."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro import trees as jtrees
from repro.configs import get_config as jget_config
from repro.kernels.lora_fused.kernel import lora_fused_kernel
from repro.kernels.ssd_chunk.ops import ssd_scan as j_ssd_kernel
from repro.launch import steps as jsteps
from repro.models import Model as JModel
from repro.models import peft as jpeft
from repro.models import ssm as j_ssm
from repro.sharding import MeshCtx
from repro_torch import bridge, trees
from repro_torch.configs import get_config
from repro_torch.kernels.lora_fused.ops import lora_matmul
from repro_torch.kernels.ssd_chunk.ops import SHAPES, cover, padded_work, ssd_cover
from repro_torch.kernels.ssd_chunk.ref import ssd_ref
from repro_torch.launch import serve, steps
from repro_torch.models import peft
from repro_torch.models.transformer import Model

TOL = 1e-5
RANK = 64
PROMPT, STEPS = 8, 4


def _np(tree):
    return {k: np.asarray(v) for k, v in jtrees.flatten(tree).items()}


def _close_rel(got, want, tol=TOL, what=""):
    """Within ``tol`` of the largest magnitude of ``want``, and ``tol``
    relative elementwise beyond it."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=what)


# ---------------------------------------------------------------- lora
@pytest.mark.parametrize("r", [33, 64, 100])
def test_lora_matmul_above_rank_32_matches_jax_kernel(r):
    """Ranks past the 32 that every branch's main loop holds run on the
    CPU (the plain version) and match the TPU kernel, which takes any
    rank."""
    rng = np.random.RandomState(r)
    m, k, n = 24, 80, 48
    x = rng.randn(m, k).astype(np.float32)
    w, a, b = ((rng.randn(*s) * 0.1).astype(np.float32) for s in ((k, n), (k, r), (r, n)))
    want = lora_fused_kernel(*map(jnp.asarray, (x, w, a, b)), scale=0.25, bm=8, bn=16,
                             bk=16, interpret=True)
    before = lora_matmul.launches
    got = lora_matmul(*map(torch.from_numpy, (x, w, a, b)), scale=0.25)
    assert lora_matmul.launches == before
    _close_rel(got.numpy(), want)


# ---------------------------------------------------------------- llama
def _llama_weights():
    """Reduced llama3.2-1b: JAX's model, its init and rank-64 LoRA on wq/wv
    with numpy-seeded A and B (JAX trees and flat numpy), and the LoRA
    config."""
    jcfg = jget_config("llama3.2-1b").reduced()
    key = jax.random.PRNGKey(0)
    jm = JModel(jcfg, meshctx=MeshCtx.single_device())
    jp = jm.init(key, max_seq=PROMPT + STEPS)
    pc = jpeft.PEFTConfig(lora_rank=RANK, lora_targets=("mixer/wq", "mixer/wv"))
    jl0 = jpeft.init_lora(key, jp, pc)
    rng = np.random.RandomState(1)
    flat_l = {k: (v if k.endswith("/mask") else (rng.randn(*v.shape) * 0.05).astype(np.float32))
              for k, v in _np(jl0).items()}
    jl = jtrees.map_with_path(lambda p, v: jnp.asarray(flat_l[p]), jl0)
    return jcfg, jm, jp, jl, flat_l, pc


def test_serve_llama_rank64_matches_jax():
    """``serve.build``/``generate`` at ``--lora-rank 64`` (reduced
    llama3.2-1b, batch 2) with JAX's weights: the prefill's and every greedy
    step's logits against JAX's ``prefill``/``decode_step`` fed the same
    tokens."""
    jcfg, jm, jp, jl, flat_l, pc = _llama_weights()
    args = serve.parse_args(["--arch", "llama3.2-1b", "--reduced", "--batch", "2",
                             "--prompt-len", str(PROMPT), "--gen", str(STEPS),
                             "--lora-rank", str(RANK), "--device", "cpu"])
    model, _, lora, scale, prompts, _, _ = serve.build(args)
    assert scale == jpeft.lora_scale(pc) == 0.25
    cfg = model.cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    params = bridge.params_from_numpy(_np(jp), cfg)
    tl = bridge.lora_from_numpy(flat_l, cfg)
    assert trees.flatten(tl).keys() <= trees.flatten(lora).keys()
    res = serve.generate(model, params, prompts, STEPS, lora=tl, lora_scale=scale)

    toks = res["tokens"].numpy()
    jlog, jc = jm.prefill(jp, jnp.asarray(prompts.numpy()), PROMPT + STEPS, lora=jl,
                          lora_scale=scale)
    for t in range(STEPS + 1):
        np.testing.assert_allclose(res["logits"][t].numpy(), np.asarray(jlog), atol=TOL,
                                   rtol=0, err_msg=f"step {t}")
        if t < STEPS:
            jlog, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]), lora=jl,
                                      lora_scale=scale)


def test_peft_step_rank64_matches_jax():
    """One ``make_peft_step`` (adapters and rank-64 LoRA on wq/wv, the LM
    loss) of reduced llama3.2-1b against JAX's: the loss and every
    trainable."""
    jcfg, jm, jp, jl, flat_l, _ = _llama_weights()
    pcfg = dict(lora_rank=RANK, adapter_dim=8, lora_targets=("mixer/wq", "mixer/wv"))
    jpc = jpeft.PEFTConfig(**pcfg)
    jparams = jpeft.init_adapters(jax.random.PRNGKey(3), jp, jcfg, jpc)
    rng = np.random.RandomState(4)
    flat_p = {k: (rng.randn(*v.shape).astype(np.float32) * 0.1 if k.endswith("adapter/wu")
                  else v) for k, v in _np(jparams).items()}
    jparams = jtrees.map_with_path(lambda p, v: jnp.asarray(flat_p[p]), jparams)
    toks = rng.randint(6, jcfg.vocab_size, size=(2, 13)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": (rng.rand(2, 12) < 0.7).astype(np.float32)}
    cfg = get_config("llama3.2-1b").reduced()
    model = Model(cfg, device="cpu")
    params = bridge.params_from_numpy(flat_p, cfg)

    jstep, jopt = jsteps.make_peft_step(jm, jpc, lr=1e-3)
    tstep, topt = steps.make_peft_step(model, peft.PEFTConfig(**pcfg), lr=1e-3)
    jt = {"adapters": jtrees.select(jparams, jpeft.is_adapter_path), "lora": jl}
    tt = {"adapters": trees.select(params, peft.is_adapter_path),
          "lora": bridge.lora_from_numpy(flat_l, cfg)}
    jt, js, jloss = jax.jit(jstep)(jt, jparams, jopt.init(jt),
                                   {k: jnp.asarray(v) for k, v in batch.items()})
    tt, _, tloss = tstep(tt, params, topt.init(tt), {k: torch.from_numpy(v)
                                                      for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), atol=TOL)
    got, want, mu = bridge.to_numpy(tt), _np(jt), _np(js["mu"])
    assert got.keys() == want.keys() and any(k.endswith("/a") for k in want)
    exempt = 0
    for k, v in want.items():
        settled = np.abs(mu[k] / 0.1) >= 1e-7       # AdamW's first moment: 0.1·g
        exempt += int((~settled).sum())
        np.testing.assert_allclose(got[k][settled], v[settled], atol=TOL, err_msg=k)
    assert exempt <= 0.01 * sum(v.size for v in want.values())


# ---------------------------------------------------------------- ssd cover
def _scan_inputs(seed, b, s, h, p, n, with_h0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h))).astype(np.float32)   # softplus
    a = (-np.exp(rng.randn(h) * 0.3)).astype(np.float32)
    bg = (rng.randn(b, s, 1, n) * 0.5).astype(np.float32)       # one group
    cg = (rng.randn(b, s, 1, n) * 0.5).astype(np.float32)
    h0 = (rng.randn(b, h, p, n) * 0.5).astype(np.float32) if with_h0 else None
    return x, dt, a, bg, cg, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("p,n", [(48, 96), (128, 128), (16, 64), (8, 8)])
def test_ssd_cover_matches_jax(p, n, with_h0):
    """The cover, run with ``ssd_ref`` as its per-block function on B and C
    that are a stride-0 broadcast of one group over the heads (so every
    block's call keeps C·Bᵀ once per (batch, chunk)), against the TPU kernel
    in interpret mode, or with h0 the JAX chunked scan."""
    b, s, h, chunk = 2, 64, 3, 16
    x, dt, a, bg, cg, h0 = _scan_inputs(p + n, b, s, h, p, n, with_h0)
    calls = []

    def block(xb, dtb, ab, bb, cb, *, chunk, h0):
        assert bb.stride(2) == 0 and cb.stride(2) == 0 and xb.shape[-1] in (16, 32, 64)
        assert (xb.shape[-1], bb.shape[-1]) in SHAPES
        calls.append((xb.shape[-1], bb.shape[-1]))
        return ssd_ref(xb, dtb, ab, bb, cb, chunk=chunk, h0=h0)

    bt, ct = (torch.from_numpy(t).expand(b, s, h, n) for t in (bg, cg))
    y, hf = ssd_cover(block, torch.from_numpy(x), torch.from_numpy(dt), torch.from_numpy(a),
                      bt, ct, chunk=chunk, h0=None if h0 is None else torch.from_numpy(h0))
    pi, ni, n_p, n_n = cover(p, n, chunk=chunk, heads=h, groups=1)
    assert calls == [(pi, ni)] * (n_p * n_n)
    bm, cm = (np.broadcast_to(t, (b, s, h, n)) for t in (bg, cg))
    if h0 is None:
        jy, jh = j_ssd_kernel(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk=chunk)
    else:
        jy, jh = j_ssm.ssd_chunk_scan(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk,
                                      h0=jnp.asarray(h0))
    assert y.shape == (b, s, h, p) and hf.shape == (b, h, p, n)
    _close_rel(y.numpy(), jy, what="y")
    _close_rel(hf.numpy(), jh, what="h_final")


@pytest.mark.parametrize("p,n,chunk,heads,groups,want", [
    (48, 96, 256, 32, 1, (64, 128, 1, 1)),      # padded into one launch
    (128, 128, 256, 64, 1, (64, 128, 2, 1)),    # two head-dim blocks
    (64, 256, 256, 32, 1, (64, 128, 1, 2)),     # two state blocks
    (16, 64, 256, 32, 1, (16, 16, 1, 4)),       # four state blocks, no padding
    (8, 8, 32, 2, 1, (16, 16, 1, 1)),           # padded
    (48, 96, 16, 4, 4, (16, 16, 3, 6)),         # short chunks: padding costs most
    (100, 200, 64, 8, 1, (64, 128, 2, 2)),
])
def test_cover_rule(p, n, chunk, heads, groups, want):
    """The pair of least padded work, and its padded work against every
    other compiled pair's; a compiled pair covers itself in one launch."""
    assert cover(p, n, chunk=chunk, heads=heads, groups=groups) == want
    work = {pair: padded_work(p, n, *pair, chunk=chunk, heads=heads, groups=groups)
            for pair in SHAPES}
    assert work[want[:2]] == min(work.values())
    pi, ni = want[:2]
    assert work[want[:2]] == want[2] * want[3] * (heads * (chunk * pi + 4 * pi * ni)
                                                   + groups * chunk * ni)
    for pair in SHAPES:
        assert cover(*pair, chunk=chunk, heads=heads, groups=groups) == (*pair, 1, 1)
