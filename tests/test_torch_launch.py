"""The launch surface against the JAX package, on the CPU:

* ``make_input_batch_shapes`` (and its alias ``input_specs``) against
  JAX's ``ShapeDtypeStruct``s for the plain, VLM and encoder-decoder
  branches;
* ``make_prefill_step``/``make_serve_step`` against JAX's on a reduced
  gpt2 (d 64) with nonzero LoRA factors: logits within 1e-5;
* ``make_fl_round_step`` against JAX's after one step on a reduced roberta
  with adapters and 3 clients' LoRA: the loss and every trainable within
  1e-5;
* ``Model(remat=True)`` against ``remat=False`` on a dense, a MoE and a
  Mamba config: the loss and every gradient within 1e-6;
* ``launch.train --steps --ckpt`` read back equal through
  ``checkpoint.load_checkpoint``; ``--data-axis`` and a mesh outside
  torchrun refused."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro import trees as jtrees
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models import Model as JModel
from repro.models import peft as jpeft
from repro_torch import bridge, trees
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import steps, train
from repro_torch.models import peft
from repro_torch.models.transformer import Model
from repro_torch.optim import value_and_grad

TOL = 1e-5
REMAT_TOL = 1e-6


def _np(tree):
    return {k: np.asarray(v) for k, v in jtrees.flatten(tree).items()}


@pytest.mark.parametrize("arch", ["gpt2-small", "internvl2-26b", "whisper-base"])
def test_input_batch_shapes_match_jax(arch):
    for name in ("train_4k", "prefill_32k"):
        want = jsteps.make_input_batch_shapes(jget_config(arch), JSHAPES[name])
        for fn in (steps.make_input_batch_shapes, steps.input_specs):
            got = fn(get_config(arch), SHAPES[name])
            assert got.keys() == want.keys()
            for k, v in want.items():
                assert tuple(got[k].shape) == tuple(v.shape), (arch, name, k)
                assert str(got[k].dtype).split(".")[-1] == str(v.dtype), (arch, name, k)
                assert got[k].device.type == "meta"
        f32 = steps.make_input_batch_shapes(get_config(arch), SHAPES[name], torch.float32)
        assert f32["mask"].dtype == torch.float32


def _factors(flat, seed):
    rng = np.random.RandomState(seed)
    return {k: v if k.endswith("/mask") else (rng.randn(*v.shape) * 0.05).astype(np.float32)
            for k, v in flat.items()}


def test_prefill_and_serve_steps_match_jax():
    jcfg = jget_config("gpt2-small").reduced(d_model=64, repeats=2, vocab=512)
    cfg = get_config("gpt2-small").reduced(d_model=64, repeats=2, vocab=512)
    key = jax.random.PRNGKey(0)
    jparams = JModel(jcfg).init(key, max_seq=16)
    pc = jpeft.PEFTConfig(lora_rank=4, lora_alpha=8.0)
    flat_l = _factors(_np(jpeft.init_lora(key, jparams, pc)), 1)
    jlora = jtrees.map_with_path(lambda p, v: jnp.asarray(flat_l[p]),
                                 jpeft.init_lora(key, jparams, pc))
    scale = jpeft.lora_scale(pc)
    prompts = np.random.RandomState(2).randint(6, 512, size=(2, 9))
    jpre = jax.jit(jsteps.make_prefill_step(JModel(jcfg), 16, lora_scale=scale))
    jserve = jax.jit(jsteps.make_serve_step(JModel(jcfg), lora_scale=scale))
    model = Model(cfg, device="cpu")
    params = bridge.params_from_numpy(_np(jparams), cfg)
    lora = bridge.lora_from_numpy(flat_l, cfg)
    pre = steps.make_prefill_step(model, 16, lora_scale=scale)
    serve = steps.make_serve_step(model, lora_scale=scale)
    jlg, jcache = jpre(jparams, {"tokens": jnp.asarray(prompts)}, lora=jlora)
    lg, cache = pre(params, {"tokens": torch.from_numpy(prompts)}, lora=lora)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=TOL)
    for _ in range(4):
        tok = np.asarray(jnp.argmax(jlg, -1))[:, None].astype(np.int32)
        jlg, jcache = jserve(jparams, jcache, jnp.asarray(tok), lora=jlora)
        lg, cache = serve(params, cache, torch.from_numpy(tok).long(), lora=lora)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=TOL)
    assert cache["pos"] == int(jcache["pos"]) == 13


def test_fl_round_step_matches_jax():
    """One round: adapters shared (their gradient the clients' mean), each
    client's LoRA its own; loss and trainables within 1e-5."""
    n = 3
    jcfg = jget_config("roberta-base").reduced(d_model=32, repeats=2)
    cfg = get_config("roberta-base").reduced(d_model=32, repeats=2)
    key = jax.random.PRNGKey(0)
    pc_j = jpeft.PEFTConfig(lora_rank=4, adapter_dim=4, lora_targets=("mixer/wq", "mixer/wv"))
    jfull = jpeft.init_adapters(key, JModel(jcfg).init(key), jcfg, pc_j)
    jloras = [jtrees.map_with_path(lambda p, v, c=c: jnp.asarray(v) if p.endswith("/mask")
                                   else jnp.asarray(_factors({p: np.asarray(v)}, c)[p]),
                                   jpeft.init_lora(jax.random.fold_in(key, c), jfull, pc_j))
              for c in range(n)]
    is_ad = lambda p: "/adapter/" in p  # noqa: E731
    jtrain = {"adapters": jtrees.select(jfull, is_ad), "lora": jtrees.stack(jloras)}
    rng = np.random.RandomState(3)
    toks = rng.randint(6, 512, size=(n, 2, 12))
    batch = {"tokens": toks, "labels": np.roll(toks, 1, -1),
             "mask": (rng.rand(n, 2, 12) < 0.5).astype(np.float32)}
    jstep, jopt = jsteps.make_fl_round_step(JModel(jcfg), pc_j, n)
    jstep = jax.jit(jstep)
    jnew, _, jloss = jstep(jtrain, jfull, jopt.init(jtrain),
                           {k: jnp.asarray(v) for k, v in batch.items()})

    model = Model(cfg, device="cpu")
    pc = peft.PEFTConfig(lora_rank=4, adapter_dim=4, lora_targets=("mixer/wq", "mixer/wv"))
    full = bridge.params_from_numpy(_np(jfull), cfg)
    train_t = {"adapters": trees.select(full, lambda p: "/adapter/" in p),
               "lora": trees.stack([bridge.lora_from_numpy(_np(lo), cfg) for lo in jloras])}
    step, opt = steps.make_fl_round_step(model, pc, n)
    new, _, loss = step(train_t, full, opt.init(train_t),
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(jloss), abs=TOL)
    got, want = trees.flatten(new), _np(jnew)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=TOL, err_msg=k)


@pytest.mark.parametrize("arch", ["gpt2-small", "dbrx-132b", "mamba2-1.3b"])
def test_remat_keeps_loss_and_gradients(arch):
    """Rematerialization recomputes each repeat's forward in the backward
    (the MoE's routing and balance loss, the scan's Function included):
    loss and every gradient within 1e-6 of the model without it."""
    cfg = get_config(arch).reduced(d_model=64, repeats=2, vocab=256)
    base = Model(cfg, device="cpu")
    params = base.init(torch.Generator().manual_seed(0), max_seq=16)
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(6, 256, size=(2, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": torch.ones(2, 16)}
    out = {}
    for remat in (False, True):
        m = Model(cfg, device="cpu", remat=remat)
        out[remat] = value_and_grad(lambda p, m=m: m.lm_loss(p, batch), params)
    assert float(out[True][0]) == pytest.approx(float(out[False][0]), abs=REMAT_TOL)
    g0, g1 = trees.flatten(out[False][1]), trees.flatten(out[True][1])
    assert g0.keys() == g1.keys()
    for k, v in g0.items():
        if v is None:
            assert g1[k] is None, k
        else:
            np.testing.assert_allclose(g1[k].numpy(), v.numpy(), atol=REMAT_TOL, err_msg=k)
    with torch.no_grad():      # outside training the flag changes nothing
        a = base.lm_loss(params, batch)
        b = Model(cfg, device="cpu", remat=True).lm_loss(params, batch)
    assert torch.equal(a, b)


@pytest.mark.parametrize("lora_rank", [0, 4])
def test_steps_ckpt_reads_back(tmp_path, lora_rank):
    argv = ["--arch", "roberta-base", "--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
            "--lora-rank", str(lora_rank), "--device", "cpu"]
    path = str(tmp_path / "ck.npz")
    losses = train.main(argv + ["--ckpt", path])
    tr = train.Trainer(train.parse_args(argv), remat=False)
    rng = np.random.RandomState(0)
    ref = [float(tr.step(tr.to_device(tr.batch(rng)))) for _ in range(2)]
    np.testing.assert_allclose(losses, ref, atol=1e-6)
    want = tr.params()
    got = load_checkpoint(path, want)
    for k, v in trees.flatten(want).items():
        np.testing.assert_allclose(trees.flatten(got)[k].numpy(), v.numpy(), atol=1e-6, err_msg=k)
    assert tr.model.remat is False and train.Trainer(train.parse_args(argv)).model.remat is False


def test_launcher_refusals(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        train.main(["--arch", "gpt2-small", "--reduced", "--steps", "1", "--data-axis", "2",
                    "--device", "cpu"])
    assert not launch_mesh.in_torchrun()
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        launch_mesh.make_client_mesh("cpu")
