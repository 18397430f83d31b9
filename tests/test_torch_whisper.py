"""whisper's encoder-decoder in the port against the JAX package, on the CPU
in f32 with numpy-seeded inputs (reduced config, 2 repeats): the encoder's
memory, prefill and cached decode (the ``dec`` layers' self- and
cross-attention caches), the loss and its factor gradients, and the serving
launcher's draws.  JAX's eager prefill and decode of whisper run, so they
are the oracle.  Tolerance 1e-5 (f32; only the order of the sums differs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro import trees as jtrees
from repro.configs import get_config as jget_config
from repro.core.arch_round import arch_lora_targets
from repro.models import Model as JModel
from repro.models import peft as jpeft
from repro.sharding import MeshCtx
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import peft
from repro_torch.models.transformer import Model
from repro_torch.optim import value_and_grad

TOL = 1e-5
MESH = MeshCtx.single_device()


def _np_tree(t):
    return {k: np.array(v) for k, v in jtrees.flatten(t).items()}


def _setup(d_model=64, repeats=2, max_seq=64, impl="auto"):
    """Both packages' reduced whisper, JAX's params in both, nonzero
    numpy-seeded factors on ``mixer/wq``/``mixer/wv`` (the encoder's and the
    decoder's self-attention) and on the decoder's ``cross/wq``."""
    jcfg = jget_config("whisper-base").reduced(d_model=d_model, repeats=repeats)
    cfg = get_config("whisper-base").reduced(d_model=d_model, repeats=repeats)
    jm = JModel(jcfg, meshctx=MESH, impl=impl)
    key = jax.random.PRNGKey(0)
    jp = jm.init(key, max_seq=max_seq)
    pc = jpeft.PEFTConfig(lora_rank=4, lora_alpha=8.0,
                          lora_targets=arch_lora_targets(jcfg) + ("cross/wq",))
    jl0 = jpeft.init_lora(key, jp, pc)
    rng = np.random.RandomState(1)
    flat_l = {k: (v if k.endswith("/mask") else (rng.randn(*v.shape) * 0.1).astype(np.float32))
              for k, v in _np_tree(jl0).items()}
    assert any("/cross/wq/" in k for k in flat_l)
    return dict(cfg=cfg, jm=jm, jp=jp, scale=jpeft.lora_scale(pc), flat_l=flat_l,
                jl=jtrees.map_with_path(lambda p, v: jnp.asarray(flat_l[p]), jl0),
                m=Model(cfg, device="cpu", impl=impl),
                p=bridge.params_from_numpy(_np_tree(jp), cfg),
                tl=bridge.lora_from_numpy(flat_l, cfg))


def _frames(cfg, b, seed):
    return np.random.RandomState(seed).randn(b, cfg.encoder_seq, cfg.d_model).astype(
        np.float32)


def test_encode_matches_jax():
    """The encoder's memory (``_encode``: frames + ``enc_pos``, the encoder
    stage, ``enc_norm``) within 1e-5 of JAX's, with factors."""
    st = _setup()
    fr = _frames(st["cfg"], 3, 5)
    want = st["jm"]._encode(st["jp"], jnp.asarray(fr), dict(lora_scale=st["scale"]),
                            lora=st["jl"])
    got = st["m"]._encode(st["p"], torch.from_numpy(fr), "auto", st["tl"], st["scale"])
    assert got.shape == (3, st["cfg"].encoder_seq, st["cfg"].d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("impl", ["auto", "sparse"])
def test_prefill_and_decode_match_jax(impl):
    """Prefill of 32 tokens (cache 40) and 4 teacher-forced decode steps
    against JAX's eager ``prefill``/``decode_step`` with factors: logits
    within 1e-5 at every step, and the caches after the last — self k/v
    and the cross ``xk``/``xv`` of the memory, kept whole — within 1e-5;
    the encoder stage's cache is None on both sides.  ``impl="sparse"``:
    the ``dec`` layers' self-attention block-sparse in prefill and masked
    in decode, on both sides."""
    st = _setup(impl=impl)
    cfg, sc = st["cfg"], st["scale"]
    rng = np.random.RandomState(3)
    toks = rng.randint(6, cfg.vocab_size, size=(2, 36))
    fr = _frames(cfg, 2, 4)
    jlog, jc = st["jm"].prefill(st["jp"], jnp.asarray(toks[:, :32]), 40,
                                frames=jnp.asarray(fr), lora=st["jl"], lora_scale=sc)
    tlog, tc = st["m"].prefill(st["p"], torch.from_numpy(toks[:, :32]), 40,
                               frames=torch.from_numpy(fr), lora=st["tl"], lora_scale=sc)
    for t in range(32, 37):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL, rtol=0,
                                   err_msg=f"position {t}")
        if t == 36:
            break
        nxt = toks[:, t:t + 1]
        jlog, jc = st["jm"].decode_step(st["jp"], jc, jnp.asarray(nxt), lora=st["jl"],
                                        lora_scale=sc)
        tlog, tc = st["m"].decode_step(st["p"], tc, torch.from_numpy(nxt), lora=st["tl"],
                                       lora_scale=sc)
    assert tc["pos"] == int(jc["pos"]) == 36
    assert tc["stages"][0] is None and jc["stages"][0] is None
    entry = tc["stages"][1][0]
    assert set(entry) == {"k", "v", "xk", "xv"}
    assert entry["xk"].shape == (2, 2, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)
    for name, buf in entry.items():
        np.testing.assert_allclose(buf.numpy(), np.asarray(jc["stages"][1][0][name]),
                                   atol=TOL, rtol=0, err_msg=name)


def test_lm_loss_and_factor_grads_match_jax():
    """``lm_loss`` with the frames in the batch within 1e-5 of JAX's and
    every factor's gradient (encoder and decoder ``mixer/wq``/``wv``, the
    decoder's ``cross/wq``) within 1e-5, on a ragged mask; no dense merge."""
    st = _setup(repeats=1)
    cfg = st["cfg"]
    rng = np.random.RandomState(2)
    b, s = 3, 12
    toks = rng.randint(6, cfg.vocab_size, size=(b, s + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32),
             "mask": (rng.rand(b, s) < 0.8).astype(np.float32),
             "frames": _frames(cfg, b, 6)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jg = jax.value_and_grad(lambda lf: st["jm"].lm_loss(
        st["jp"], jb, lora=lf, lora_scale=st["scale"]))(st["jl"])
    m0 = peft.dense_merge_count()
    got, tg = value_and_grad(lambda lf: st["m"].lm_loss(
        st["p"], {k: torch.from_numpy(v) for k, v in batch.items()}, lora=lf,
        lora_scale=st["scale"]), st["tl"])
    assert peft.dense_merge_count() == m0
    assert abs(float(got) - float(want)) <= TOL
    jg, tg = _np_tree(jg), bridge.to_numpy(tg)
    assert {p for p in jg if not p.endswith("/mask")} == set(tg)
    assert any(p.startswith("stages/0/") for p in tg) and any("/cross/" in p for p in tg)
    for path, g in tg.items():
        np.testing.assert_allclose(g, jg[path], atol=TOL, rtol=0, err_msg=path)


def test_serve_build_draws_like_the_jax_launcher(monkeypatch):
    """``serve.build`` draws frames, then the prompts, from one numpy
    ``RandomState(0)`` as the JAX launcher does: both equal the arrays the
    JAX launcher hands its ``prefill`` (captured there); the frames are
    (batch, encoder_seq, d) and ``generate`` takes them."""
    from repro.launch import serve as jserve
    seen = {}

    class Captured(Exception):
        pass

    def capture(self, params, tokens, cache_len, **kw):
        seen.update(tokens=np.asarray(tokens), frames=np.asarray(kw["frames"]))
        raise Captured

    monkeypatch.setattr(JModel, "prefill", capture)
    argv = ["--arch", "whisper-base", "--reduced", "--batch", "2", "--prompt-len", "8",
            "--gen", "2"]
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    with pytest.raises(Captured):
        jserve.main()
    model, params, lora, lscale, prompts, patches, frames = serve.build(
        serve.parse_args(argv + ["--device", "cpu"]))
    assert patches is None and lora is None
    np.testing.assert_array_equal(frames.numpy(), seen["frames"])
    np.testing.assert_array_equal(prompts.numpy(), seen["tokens"])
    res = serve.generate(model, params, prompts, 2, frames=frames)
    assert res["tokens"].shape == (2, 2)
