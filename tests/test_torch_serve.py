"""The port's serving slice against the JAX serving path.

Reduced gpt2-small (d_model 128, 2 repeats, vocab 512), f32, on the CPU:
the same JAX-initialized weights and numpy-seeded nonzero LoRA factors go
through JAX ``Model(opts={"lora_backend": "pallas"})`` (the Pallas LoRA
kernel in interpret mode) and through the port, whose kernel wrappers take
their plain versions on CPU tensors.  Tolerance atol 1e-4, that of
``test_mixer_factored.py::test_prefill_decode_parity``.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import trees as jtrees
from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models import peft as jpeft
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attn.ops import decode_attention
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.kernels.lora_fused.ops import lora_matmul
from repro_torch.launch import serve
from repro_torch.models import peft
from repro_torch.models.transformer import Model

ATOL = 1e-4
CACHE_LEN = 16
N_DECODE = 4


def _random_factors(flat_lora, seed):
    """init_lora zeros B; give A and B numpy-seeded values so the rank-r
    path is exercised (masks stay as initialized)."""
    rng = np.random.RandomState(seed)
    return {k: (v if k.endswith("/mask")
                else (rng.randn(*v.shape) * 0.05).astype(np.float32))
            for k, v in flat_lora.items()}


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("gpt2-small").reduced(d_model=128, repeats=2, vocab=512)
    cfg = get_config("gpt2-small").reduced(d_model=128, repeats=2, vocab=512)
    jmodel = JModel(jcfg, opts={"lora_backend": "pallas"})
    key = jax.random.PRNGKey(0)
    jparams = jmodel.init(key, max_seq=CACHE_LEN)
    pc = jpeft.PEFTConfig(lora_rank=4, lora_alpha=8.0)
    jlora0 = jpeft.init_lora(key, jparams, pc)
    flat_p = {k: np.asarray(v) for k, v in jtrees.flatten(jparams).items()}
    flat_l = _random_factors(
        {k: np.asarray(v) for k, v in jtrees.flatten(jlora0).items()}, seed=1)
    jlora = jtrees.map_with_path(lambda p, v: jnp.asarray(flat_l[p]), jlora0)
    prompts = np.random.RandomState(2).randint(6, 512, size=(2, 9))
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, jparams=jparams, jlora=jlora,
                pc=pc, flat_p=flat_p, flat_l=flat_l, prompts=prompts,
                scale=jpeft.lora_scale(pc))


def _port(setup):
    cfg = setup["cfg"]
    return (Model(cfg, device="cpu"),
            bridge.params_from_numpy(setup["flat_p"], cfg),
            bridge.lora_from_numpy(setup["flat_l"], cfg))


def _jax_cache_kv(jcache):
    return [(np.asarray(e["k"]), np.asarray(e["v"]))
            for e in jcache["stages"][0]]


def _check_cache(cache, jcache):
    assert cache["pos"] == int(jcache["pos"])
    for e, (jk, jv) in zip(cache["stages"][0], _jax_cache_kv(jcache)):
        np.testing.assert_allclose(e["k"].numpy(), jk, atol=ATOL)
        np.testing.assert_allclose(e["v"].numpy(), jv, atol=ATOL)


def test_config_copy_matches_reference():
    """The port's own config copies agree with the JAX package's on every
    field the two share (``SSMConfig`` and ``SparseAttnConfig`` included)
    and on the derived widths."""
    for arch, reduce in itertools.product(("gpt2-small", "mamba2-1.3b"), (False, True)):
        a, b = get_config(arch), jget_config(arch)
        if reduce:
            a, b = a.reduced(d_model=128, repeats=2), b.reduced(d_model=128, repeats=2)
        for f in a.__dataclass_fields__:  # dataclass reprs carry no module
            assert repr(getattr(a, f)) == repr(getattr(b, f)), f
        assert (a.hd, a.attention_free) == (b.hd, b.attention_free)
        if a.ssm is not None:
            assert (a.d_inner, a.ssm_heads) == (b.d_inner, b.ssm_heads)


def test_prefill_and_decode_match_jax_pallas_serving(setup):
    s = setup
    model, params, lora = _port(s)
    jmodel, jparams, jlora, scale = s["jmodel"], s["jparams"], s["jlora"], s["scale"]
    prompts = s["prompts"]

    jlg, jcache = jmodel.prefill(jparams, jnp.asarray(prompts), cache_len=CACHE_LEN,
                                 lora=jlora, lora_scale=scale)
    counts = (lora_matmul.launches, flash_attention.launches,
              decode_attention.launches)
    lg, cache = model.prefill(params, torch.from_numpy(prompts), CACHE_LEN,
                              lora=lora, lora_scale=scale)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL)
    _check_cache(cache, jcache)

    for _ in range(N_DECODE):
        tok = np.asarray(jnp.argmax(jlg, -1))[:, None].astype(np.int32)
        jlg, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok),
                                         lora=jlora, lora_scale=scale)
        lg, cache = model.decode_step(params, cache, torch.from_numpy(tok).long(),
                                      lora=lora, lora_scale=scale)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL)
        _check_cache(cache, jcache)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert counts == (lora_matmul.launches, flash_attention.launches,
                      decode_attention.launches)


def test_layer_adapters_match_jax(setup):
    """Bottleneck adapters riding in the layer params (PFTT's universal
    adapters) are applied as in the JAX layer."""
    s = setup
    jp = jpeft.init_adapters(jax.random.PRNGKey(3), s["jparams"], s["jcfg"],
                             jpeft.PEFTConfig(adapter_dim=16))
    rng = np.random.RandomState(4)   # wu starts at zero: give it values
    flat = {k: ((rng.randn(*np.shape(v)) * 0.05).astype(np.float32)
                if k.endswith("adapter/wu") else np.asarray(v))
            for k, v in jtrees.flatten(jp).items()}
    jp = jtrees.map_with_path(lambda p, v: jnp.asarray(flat[p]), jp)
    jlg, _ = s["jmodel"].prefill(jp, jnp.asarray(s["prompts"]), cache_len=CACHE_LEN)
    lg, _ = Model(s["cfg"], device="cpu").prefill(
        bridge.params_from_numpy(flat, s["cfg"]), torch.from_numpy(s["prompts"]),
        CACHE_LEN)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL)


def test_factored_matches_merged_oracle(setup):
    """Unmerged LoRA through lora_proj == the apply_lora-merged model."""
    model, params, lora = _port(setup)
    pc = peft.PEFTConfig(lora_rank=4, lora_alpha=8.0)
    merged = peft.apply_lora(params, lora, pc)
    toks = torch.from_numpy(setup["prompts"])
    lg_f, c_f = model.prefill(params, toks, CACHE_LEN, lora=lora,
                              lora_scale=peft.lora_scale(pc))
    lg_m, c_m = model.prefill(merged, toks, CACHE_LEN)
    torch.testing.assert_close(lg_f, lg_m, atol=1e-5, rtol=0)
    tok = lg_m.argmax(-1, keepdim=True)
    d_f, _ = model.decode_step(params, c_f, tok, lora=lora,
                               lora_scale=peft.lora_scale(pc))
    d_m, _ = model.decode_step(merged, c_m, tok)
    torch.testing.assert_close(d_f, d_m, atol=1e-5, rtol=0)


def test_merged_oracle_matches_jax_apply_lora(setup):
    s = setup
    _, params, lora = _port(s)
    merged = bridge.to_numpy(peft.apply_lora(params, lora, peft.PEFTConfig(
        lora_rank=4, lora_alpha=8.0)))
    jmerged = jtrees.flatten(jpeft.apply_lora(s["jparams"], s["jlora"], s["pc"]))
    assert merged.keys() == jmerged.keys()
    for k, v in merged.items():
        np.testing.assert_allclose(v, np.asarray(jmerged[k]), atol=1e-6, err_msg=k)


def test_stray_factors_raise(setup):
    model, params, lora = _port(setup)
    bad = dict(lora, embed={"a": torch.zeros(1), "b": torch.zeros(1),
                            "mask": torch.ones(())})
    with pytest.raises(ValueError, match="factored LoRA"):
        model.prefill(params, torch.from_numpy(setup["prompts"]), CACHE_LEN,
                      lora=bad)


def test_serve_cli_runs_on_cpu_when_asked(capsys):
    res = serve.main(["--arch", "gpt2-small", "--reduced", "--batch", "2",
                      "--prompt-len", "5", "--gen", "3", "--lora-rank", "4",
                      "--device", "cpu"])
    assert res["tokens"].shape == (2, 3)
    assert len(res["logits"]) == 4
    assert all(torch.isfinite(lg).all() for lg in res["logits"])
    assert "UNMERGED" in capsys.readouterr().out


def test_serve_cli_runs_mamba2_on_cpu():
    """The CLI of the verify recipe: reduced mamba2 with a rank-4 LoRA on
    in_proj and out_proj."""
    res = serve.main(["--arch", "mamba2-1.3b", "--reduced", "--batch", "2",
                      "--prompt-len", "40", "--gen", "3", "--lora-rank", "4",
                      "--device", "cpu"])
    assert res["tokens"].shape == (2, 3)
    assert all(torch.isfinite(lg).all() for lg in res["logits"])


def test_serve_build_passes_impl():
    args = serve.parse_args(["--arch", "gpt2-small", "--reduced", "--batch", "1",
                             "--prompt-len", "32", "--gen", "2", "--device", "cpu"])
    model, params, _, _, prompts, _, frames = serve.build(args, impl="sparse")
    assert frames is None
    assert model.impl == "sparse"
    assert serve.generate(model, params, prompts, 2)["tokens"].shape == (1, 2)


def test_serve_without_cuda_raises(monkeypatch):
    """No silent CPU fallback: the default device is CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "gpt2-small", "--reduced", "--batch", "1",
                    "--prompt-len", "4", "--gen", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(get_config("gpt2-small").reduced())


def test_unported_kinds_name_their_slice():
    """Every mixer of the JAX package is ported: MLA (with any ff),
    whisper's cross-attention decoder, MoE, the ``local`` window, the
    encoder, an encoder-decoder stack, rotary positions and VLM prefixes
    build, and an encoder-decoder serves from a reduced config; a ``none``
    mixer (the layer is its ff) builds and serves too (held against JAX in
    ``tests/test_torch_oracles_api.py``)."""
    import dataclasses
    from repro_torch.configs import LK, Stage
    cfg = get_config("gpt2-small").reduced()
    mla_cfg = get_config("deepseek-v2-236b").reduced()
    for kind in (LK("mla", "none"), LK("mla", "mlp"), LK("mla", "moe")):
        Model(dataclasses.replace(mla_cfg, stages=(Stage((kind,), 1),)), device="cpu")
    none = Model(dataclasses.replace(cfg, stages=(Stage((LK("none", "mlp"),), 1),)),
                 device="cpu")
    p = none.init(torch.Generator().manual_seed(0))
    logits, cache = none.prefill(p, torch.zeros((1, 4), dtype=torch.long), 6)
    assert cache["stages"][0] == [{}] and torch.isfinite(logits).all()
    moe = get_config("dbrx-132b").reduced()
    for kind in (LK("attn", "moe"), LK("local", "mlp")):
        Model(dataclasses.replace(moe, stages=(Stage((kind,), 1),)), device="cpu")
    Model(get_config("roberta-base").reduced(), device="cpu")
    whisper = get_config("whisper-base").reduced(d_model=64)
    enc_dec = dataclasses.replace(whisper, stages=(
        Stage((LK("enc", "mlp"),), 1, "encoder"), Stage((LK("dec", "mlp"),), 1)))
    res = serve.main(["--arch", "whisper-base", "--reduced", "--batch", "2",
                      "--prompt-len", "8", "--gen", "3", "--lora-rank", "4",
                      "--device", "cpu"])
    assert res["tokens"].shape == (2, 3)
    assert Model(enc_dec, device="cpu").cfg.is_encoder_decoder
    # rotary positions and VLM prefixes build
    Model(dataclasses.replace(cfg, pos="rope"), device="cpu")
    Model(get_config("internvl2-26b").reduced(), device="cpu")
    Model(get_config("mamba2-1.3b").reduced(), device="cpu")
