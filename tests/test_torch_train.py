"""The port's training path against the JAX package, in f32 on the CPU:
the reduced RoBERTa encoder (hidden states, ``cls_loss``, ``lm_loss`` and
their gradients), the backward formulas of the two kernels' autograd
Functions, AdamW and the schedules, the PEFT and full training steps, and
the ``--steps`` launcher.  Inputs come from numpy seeds; weights are
exported from the JAX package through ``bridge``.  Tolerances are those of
``tests/test_lora_factored.py`` (1e-5) for the model and ROADMAP's 1e-6 for
AdamW."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro import trees as jtrees
from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.models import peft as jpeft
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro_torch import bridge, trees
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attn.ops import FlashAttention
from repro_torch.kernels.flash_attn.ref import attention_ref
from repro_torch.kernels.lora_fused.ops import LoraMatmul
from repro_torch.kernels.lora_fused.ref import lora_ref
from repro_torch.launch import steps, train
from repro_torch.models import peft
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw, schedules, value_and_grad

TOL = 1e-5
PEFT = dict(lora_rank=4, adapter_dim=8, lora_targets=("mixer/wq", "mixer/wv"))


def _np(tree):
    return {k: np.asarray(v) for k, v in jtrees.flatten(tree).items()}


@pytest.fixture(scope="module")
def encoder():
    """A JAX-initialized reduced RoBERTa (d 64, 2 layers) with adapters and
    LoRA factors whose B and adapter ``wu`` are nonzero (numpy seed), as
    flat numpy trees."""
    jcfg = jget_config("roberta-base").reduced(d_model=64, repeats=2)
    key = jax.random.PRNGKey(0)
    pc = jpeft.PEFTConfig(**PEFT)
    params = jpeft.init_adapters(key, JModel(jcfg).init(key), jcfg, pc)
    lora = jpeft.init_lora(jax.random.PRNGKey(1), params, pc)
    rng = np.random.RandomState(3)
    flat_p = {k: (rng.randn(*v.shape).astype(np.float32) * 0.1 if k.endswith("adapter/wu")
                  else v) for k, v in _np(params).items()}
    flat_l = {k: (rng.randn(*v.shape).astype(np.float32) * 0.1 if k.endswith("/b")
                  else v) for k, v in _np(lora).items()}
    toks = rng.randint(6, 512, size=(5, 16)).astype(np.int32)
    batch = {"tokens": toks, "label": rng.randint(0, 4, size=5).astype(np.int32),
             "valid": np.array([1, 1, 1, 0, 0], np.float32),
             "labels": rng.randint(6, 512, size=(5, 16)).astype(np.int32),
             "mask": (rng.rand(5, 16) < 0.3).astype(np.float32)}
    return jcfg, flat_p, flat_l, batch


def test_reduced_roberta_config_matches_jax():
    want = jget_config("roberta-base").reduced(d_model=128, repeats=2)
    got = get_config("roberta-base").reduced(d_model=128, repeats=2)
    for f in ("name", "family", "d_model", "n_heads", "n_kv_heads", "hd", "d_ff",
              "vocab_size", "norm", "act", "pos", "max_position", "n_classes",
              "n_layers", "is_encoder_only"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.n_heads, got.hd, got.vocab_size, got.max_position) == (4, 32, 512, 1024)
    assert [(s.repeats, s.stream, [k.tag for k in s.pattern]) for s in got.stages] == \
        [(s.repeats, s.stream, [k.tag for k in s.pattern]) for s in want.stages]


def test_port_init_matches_jax_layout(encoder):
    """The port's own init, adapters and LoRA have the JAX trees' paths and
    shapes (cls_head, the 1024-row position table, adapters in every
    layer)."""
    jcfg, flat_p, flat_l, _ = encoder
    cfg = get_config("roberta-base").reduced(d_model=64, repeats=2)
    gen = torch.Generator().manual_seed(0)
    pc = peft.PEFTConfig(**PEFT)
    params = peft.init_adapters(gen, Model(cfg, device="cpu").init(gen), cfg, pc)
    lora = peft.init_lora(gen, params, pc)
    assert {k: v.shape for k, v in bridge.to_numpy(params).items()} == \
        {k: v.shape for k, v in flat_p.items()}
    assert {k: v.shape for k, v in bridge.to_numpy(lora).items()} == \
        {k: v.shape for k, v in flat_l.items()}
    assert not bridge.to_numpy(params)["stages/0/layers/0/adapter/wu"].any()


def test_encoder_hidden_and_losses_match_jax(encoder):
    """Hidden states, cls_loss (with a ragged ``valid``) and lm_loss, and
    their gradients over the adapters, the LoRA factors and cls_head."""
    jcfg, flat_p, flat_l, batch = encoder
    cfg = get_config("roberta-base").reduced(d_model=64, repeats=2)
    model, jmodel = Model(cfg, device="cpu"), JModel(jcfg)
    scale = peft.lora_scale(peft.PEFTConfig(**PEFT))
    params = bridge.params_from_numpy(flat_p, cfg)
    lora = bridge.lora_from_numpy(flat_l, cfg)
    jparams, jlora = _unflat_j(flat_p), _unflat_j(flat_l)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    got, _ = model.forward(params, tb["tokens"], lora=lora, lora_scale=scale)
    want, _ = jmodel.forward(jparams, jb["tokens"], lora=jlora, lora_scale=scale)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL)

    train_pred = lambda p: "adapter" in p or p.startswith("cls_head")  # noqa: E731
    for name in ("cls_loss", "lm_loss"):
        def jloss(tp, tl, name=name):
            full = jtrees.merge(jparams, tp)
            out = getattr(jmodel, name)(full, jb, lora=tl, lora_scale=scale)
            return out[0] if name == "cls_loss" else out

        jtp = jtrees.select(jparams, train_pred)
        jval, (jgp, jgl) = jax.value_and_grad(jloss, argnums=(0, 1))(jtp, jlora)

        def tloss(t, name=name):
            full = trees.merge(params, t["p"])
            out = getattr(model, name)(full, tb, lora=t["l"], lora_scale=scale)
            return out[0] if name == "cls_loss" else out

        val, g = value_and_grad(tloss, {"p": trees.select(params, train_pred),
                                        "l": lora})
        np.testing.assert_allclose(float(val), float(jval), atol=TOL, err_msg=name)
        want_g = {**{f"p/{k}": v for k, v in _np(jgp).items()},
                  **{f"l/{k}": v for k, v in _np(jgl).items()}}
        # a leaf the loss does not reach (the LoRA masks) has no gradient
        got_g = {k: v.numpy() for k, v in trees.flatten(g).items()}
        assert set(got_g) <= set(want_g)
        got_g.update({k: np.zeros_like(v) for k, v in want_g.items()
                      if k not in got_g})
        assert any(k.endswith("/a") for k in got_g) and any("cls_head" in k for k in got_g)
        for k, v in want_g.items():
            np.testing.assert_allclose(got_g[k], v, atol=TOL, err_msg=f"{name} {k}")
    # the ragged valid weighting: padded rows change neither loss nor accuracy
    loss_v, acc_v = model.cls_loss(params, tb, lora=lora, lora_scale=scale)
    cut = {k: v[:3] for k, v in tb.items() if k != "valid"}
    loss_c, acc_c = model.cls_loss(params, cut, lora=lora, lora_scale=scale)
    np.testing.assert_allclose(float(loss_v), float(loss_c), atol=1e-6)
    assert float(acc_v) == float(acc_c)


def _unflat_j(flat):
    """Flat numpy → the JAX package's nested tree (lists for stages and
    layers)."""
    tree = trees.unflatten({k: jnp.asarray(v) for k, v in flat.items()})
    tree["stages"] = [dict(tree["stages"][str(i)],
                           layers=[tree["stages"][str(i)]["layers"][str(j)]
                                   for j in range(len(tree["stages"][str(i)]["layers"]))])
                      for i in range(len(tree["stages"]))]
    return tree


@pytest.mark.parametrize("m,k,n,r,with_w", [(10, 48, 40, 4, False), (7, 32, 24, 8, True)])
def test_lora_function_backward_matches_jax(m, k, n, r, with_w):
    """``LoraMatmul``'s backward (run with the plain forward) against
    ``jax.grad`` of the JAX package's jnp factored projection; dW only when
    W requires grad."""
    rng = np.random.RandomState(m)
    x, w = rng.randn(2, m, k).astype(np.float32), (rng.randn(k, n) * 0.05).astype(np.float32)
    a, b = (rng.randn(k, r) * 0.05).astype(np.float32), (rng.randn(r, n) * 0.05).astype(np.float32)
    g = rng.randn(2, m, n).astype(np.float32)

    def jl(x, w, a, b):
        lf = {"a": a, "b": b, "mask": jnp.ones((), jnp.float32)}
        return jnp.sum(jpeft.lora_proj(x, w, lf, scale=2.0) * jnp.asarray(g))

    want = jax.grad(jl, argnums=(0, 1, 2, 3))(*(jnp.asarray(t) for t in (x, w, a, b)))
    xt, wt, at, bt = (torch.from_numpy(t) for t in (x, w, a, b))
    for t in (xt, at, bt) + ((wt,) if with_w else ()):
        t.requires_grad_()
    y = LoraMatmul.apply(lora_ref, xt, wt, at, bt, 2.0)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(
        jpeft.lora_proj(jnp.asarray(x), jnp.asarray(w),
                        {"a": jnp.asarray(a), "b": jnp.asarray(b), "mask": jnp.ones(())},
                        scale=2.0)), atol=TOL)
    (y * torch.from_numpy(g)).sum().backward()
    for got, ref in zip((xt.grad, wt.grad, at.grad, bt.grad), want):
        if got is None:
            assert not with_w
            continue
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("b,s,h,kh,d,causal,window", [
    (2, 16, 4, 4, 16, False, 0),    # the encoder's non-causal attention
    (2, 16, 4, 2, 16, False, 0),    # GQA: dK, dV summed over the query heads
    (1, 20, 4, 1, 8, True, 0),
    (2, 24, 2, 2, 16, True, 6)])
def test_flash_function_backward_matches_jax(b, s, h, kh, d, causal, window):
    """``FlashAttention``'s backward (softmax VJP by recomputation, run
    with the plain forward) against ``jax.grad`` of the JAX package's
    dense attention."""
    rng = np.random.RandomState(s + h)
    q, k, v = (rng.randn(b, s, n, d).astype(np.float32) for n in (h, kh, kh))
    g = rng.randn(b, s, h, d).astype(np.float32)

    def jl(q, k, v):
        out = jattn.dense_attention(q, k, v, causal=causal, window=window)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jl, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = FlashAttention.apply(attention_ref, qt, kt, vt, causal, window)
    (out * torch.from_numpy(g)).sum().backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_adamw_matches_jax():
    """Five AdamW steps with weight decay and an ``update_mask`` (the
    ``/mask`` leaves frozen, a ``None`` gradient read as zeros) against the
    JAX package's: params and the (mu, nu, step) state to 1e-6."""
    rng = np.random.RandomState(0)
    p0 = {"w": rng.randn(6, 5).astype(np.float32),
          "lora": {"a": rng.randn(5, 2).astype(np.float32),
                   "mask": np.ones((3, 1, 1), np.float32)}}
    grads = [{"w": rng.randn(6, 5).astype(np.float32),
              "lora": {"a": rng.randn(5, 2).astype(np.float32),
                       "mask": np.zeros((3, 1, 1), np.float32)}} for _ in range(5)]
    keep = lambda p: not p.endswith("/mask")  # noqa: E731
    jopt = jadamw(3e-3, weight_decay=0.01, update_mask=keep)
    topt = adamw(3e-3, weight_decay=0.01, update_mask=keep)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = trees.map_leaves(torch.from_numpy, p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        u, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jtrees.tree_add(jp, u)
        tg = trees.map_leaves(torch.from_numpy, g)
        tg["lora"]["mask"] = None
        u, ts = topt.update(tg, ts, tp)
        tp = trees.tree_add(tp, u)
    for (path, got), want in zip(sorted(trees.flatten({"p": tp, "s": ts}).items()),
                                 [v for _, v in sorted(_np({"p": jp, "s": js}).items())]):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, err_msg=path)
    np.testing.assert_array_equal(tp["lora"]["mask"].numpy(), p0["lora"]["mask"])


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_and_clipping_match_jax(momentum):
    """Three SGD steps (with and without momentum) on clipped gradients,
    and the global norm, against the JAX package's."""
    from repro.optim import optimizers as jopt_mod
    from repro_torch.optim import optimizers as opt_mod
    rng = np.random.RandomState(1)
    p0 = {"w": rng.randn(4, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    jopt, topt = jopt_mod.sgd(0.1, momentum=momentum), opt_mod.sgd(0.1, momentum=momentum)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = trees.map_leaves(torch.from_numpy, p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g = {"w": rng.randn(4, 3).astype(np.float32) * 3, "b": rng.randn(3).astype(np.float32)}
        jg, jn = jopt_mod.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g), 1.5)
        tg, tn = opt_mod.clip_by_global_norm(trees.map_leaves(torch.from_numpy, g), 1.5)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        u, js = jopt.update(jg, js, jp)
        jp = jtrees.tree_add(jp, u)
        u, ts = topt.update(tg, ts, tp)
        tp = trees.tree_add(tp, u)
    for k, v in _np(jp).items():
        np.testing.assert_allclose(trees.flatten(tp)[k].numpy(), v, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name,args", [("constant", (0.1,)),
                                       ("cosine_decay", (0.1, 7)),
                                       ("linear_warmup_cosine", (0.1, 3, 9))])
def test_schedules_match_jax(name, args):
    for step in range(12):
        want = getattr(jsched, name)(*args)(jnp.asarray(step, jnp.int32))
        got = getattr(schedules, name)(*args)(torch.tensor(step, dtype=torch.int32))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_peft_and_train_steps_match_jax(encoder):
    """Two ``make_peft_step`` steps (adapters + LoRA, MLM loss; losses and
    trainables) and ``make_train_step`` (every leaf, weight decay; gradients
    and three steps' losses) against the JAX package's step builders, to
    1e-5."""
    jcfg, flat_p, flat_l, batch = encoder
    cfg = get_config("roberta-base").reduced(d_model=64, repeats=2)
    model, jmodel = Model(cfg, device="cpu"), JModel(jcfg)
    mb = {k: batch[k] for k in ("tokens", "labels", "mask")}
    tb = {k: torch.from_numpy(v) for k, v in mb.items()}
    jb = {k: jnp.asarray(v) for k, v in mb.items()}
    params, jparams = bridge.params_from_numpy(flat_p, cfg), _unflat_j(flat_p)

    jstep, jopt = jsteps.make_peft_step(jmodel, jpeft.PEFTConfig(**PEFT), lr=1e-2)
    tstep, topt = steps.make_peft_step(model, peft.PEFTConfig(**PEFT), lr=1e-2)
    jt = {"adapters": jtrees.select(jparams, jpeft.is_adapter_path), "lora": _unflat_j(flat_l)}
    tt = {"adapters": trees.select(params, peft.is_adapter_path),
          "lora": bridge.lora_from_numpy(flat_l, cfg)}
    js, ts = jopt.init(jt), topt.init(tt)
    for _ in range(2):
        jt, js, jloss = jstep(jt, jparams, js, jb)
        tt, ts, tloss = tstep(tt, params, ts, tb)
        np.testing.assert_allclose(float(tloss), float(jloss), atol=TOL)
    got, want = bridge.to_numpy(tt), _np(jt)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=TOL, err_msg=k)

    # full fine-tuning: the gradients of every leaf, then the losses of three
    # steps (each reads every parameter the previous update wrote).  The
    # parameters themselves are not held elementwise: Adam divides each
    # gradient by its own magnitude, so an element whose gradient is at the
    # rounding level (|g| ~ eps) moves by up to lr on either side.
    jg = jax.grad(lambda p: jmodel.lm_loss(p, jb))(jparams)
    _, tg = value_and_grad(lambda p: model.lm_loss(p, tb), params)
    got = {k: v.numpy() for k, v in trees.flatten(tg).items()}
    want = _np(jg)
    assert got.keys() <= want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got.get(k, np.zeros_like(v)), v, atol=TOL, err_msg=k)
    jstep, jopt = jsteps.make_train_step(jmodel, lr=1e-3)
    tstep, topt = steps.make_train_step(model, lr=1e-3)
    js, ts = jopt.init(jparams), topt.init(params)
    for _ in range(3):
        jparams, js, jloss = jstep(jparams, js, jb)
        params, ts, tloss = tstep(params, ts, tb)
        np.testing.assert_allclose(float(tloss), float(jloss), atol=TOL)


def test_train_launcher_steps_on_cpu():
    """``--steps`` mode on the CPU: PEFT (``--lora-rank 8``) and the
    default full fine-tuning run; the PEFT trainables are the adapters and
    the LoRA factors; the uplink and population flags reach
    ``PFTTConfig``; unported modes raise by name."""
    argv = ["--arch", "roberta-base", "--reduced", "--steps", "4", "--batch", "4",
            "--seq", "16", "--device", "cpu"]
    losses = train.main(argv + ["--lora-rank", "8"])
    assert len(losses) == 4 and all(np.isfinite(losses))
    full = train.main(argv)
    assert len(full) == 4 and all(np.isfinite(full))
    tr = train.Trainer(train.parse_args(argv + ["--lora-rank", "8"]))
    assert set(tr.trainable) == {"adapters", "lora"}
    assert all("/adapter/" in p for p in trees.flatten(tr.trainable["adapters"]))
    cfg = train.pftt_config(train.parse_args(argv + ["--fault-plan", "dropout_p=0.5",
                                                     "--uplink-codec", "int8",
                                                     "--factored-agg"]))
    assert cfg.uplink_codec == "int8" and cfg.factored_agg
    pop = train.pftt_config(train.parse_args(argv + ["--uplink-codec", "int8",
                                                     "--population", "8"]))
    assert pop.population.population == 8 and pop.uplink_codec == "int8"
    with pytest.raises(SystemExit, match="roberta-base"):
        train.parse_args(["--arch", "gpt2-small", "--population", "8"])
    # another arch's --fl-clients is the arch round (tests/test_torch_arch_round.py);
    # MLA and the encoder-decoder train in --steps mode (whisper's batch
    # carries the frames, drawn after the tokens as the JAX launcher)
    assert train.arch_round_config(train.parse_args(
        ["--arch", "gpt2-small", "--fl-clients", "2", "--device", "cpu"])).arch == "gpt2-small"
    for arch in ("deepseek-v2-236b", "whisper-base"):
        got = train.main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
                          "--seq", "16", "--lora-rank", "0", "--device", "cpu"])
        assert len(got) == 2 and all(np.isfinite(got))
    tr = train.Trainer(train.parse_args(["--arch", "whisper-base", "--reduced",
                                         "--device", "cpu"]))
    assert tr.batch(np.random.RandomState(0))["frames"].shape == (8, 16, 256)
    # mamba trains: the SSD scan carries gradients (SSDScan on the card)
    mamba = train.main(["--arch", "mamba2-1.3b", "--reduced", "--steps", "2", "--batch", "2",
                        "--seq", "16", "--device", "cpu"])
    assert len(mamba) == 2 and all(np.isfinite(mamba))
