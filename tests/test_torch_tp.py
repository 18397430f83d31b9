"""The port under the (data, model) tensor-parallel mesh against the JAX
package's unsharded functions (JAX's own sharded model fails under the
installed JAX: ROADMAP queue 3), on the CPU: one spawn of four gloo worker
processes (``tests/_torch_tp_worker.py``) runs every case on the (1, 1),
(2, 2) and (1, 4) meshes while this process computes the JAX oracles.

* ``lm_loss`` (``cls_loss`` for roberta) of every config, reduced to d 64,
  within 2e-4 of JAX's, with a ragged mask (a mean of per-shard means
  would be wrong there); the MoE configs are held to JAX's loss on each
  data shard, averaged (the balance loss and the capacity are per shard,
  JAX's ``pmean`` of ``_local_moe``), with a full mask; one case whose 3
  heads do not divide the model axis (the spec splits a head, the plan
  gathers the projections);
* one ``make_train_step`` step of tinyllama and dbrx against JAX's step:
  the loss within 2e-4, the unsharded parameters within 1e-5 (AdamW's
  first step exempts elements whose gradient is below 1e-7 in magnitude,
  where rounding alone moves them by up to lr);
* one ``make_peft_step`` and one ``make_fl_round_step`` (two clients) of
  tinyllama and dbrx on (2, 2) and (1, 4), LoRA on wq/wv/wo and the ff
  weights (the experts' for dbrx) and bottleneck adapters, against JAX's
  ``make_peft_step`` / ``make_fl_round_step``: the loss within 2e-4, the
  factors and adapters within 1e-5 (the same exemption); dbrx on (2, 2)
  against JAX's steps over the mean of its data shards' losses;
* prefill of 12 tokens and 8 decode steps of tinyllama and gpt2 (nonzero
  LoRA on wq/wv) against the port's unsharded decode, within 1e-5: a
  32-position cache, so a sequence segment is empty at the first steps
  and fills during them;
* ``moe_ffn_a2a`` on (1, 4) against JAX's ``_local_moe_a2a`` under
  ``vmap`` over a model axis (output, balance loss and gradients), and
  ``mamba_seq_sp`` on (1, 4) against JAX's unsharded ``mamba_seq``
  (output and gradients; JAX's test's tolerance, 2e-5 + 1e-4 relative);
* an arch cohort round on the (2, 2) mesh equal to the same round on its
  (2,) client mesh (the model ranks are replicas)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_tp_worker import spawn

from repro import trees as jtrees
from repro.configs import get_config as jget
from repro.configs import list_configs
from repro.launch.steps import make_fl_round_step as jmake_fl_round_step
from repro.launch.steps import make_peft_step as jmake_peft_step
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro.models import peft as jpeft
from repro.models import ssm as jssm
from repro.optim import adamw as jadamw
from repro.sharding import MeshCtx as JMeshCtx
from repro_torch import bridge
from repro_torch import trees as ptrees
from repro_torch.configs import get_config
from repro_torch.core.arch_round import ArchRoundConfig
from repro_torch.models import peft
from repro_torch.models.transformer import Model

JMESH = JMeshCtx.single_device()
LOSS_TOL = 2e-4
PARAM_TOL = 1e-5
DECODE_TOL = 1e-5
SP_ATOL, SP_RTOL = 2e-5, 1e-4
B, S = 4, 16
ARCHS = list_configs()
MESHES = ("1x1", "2x2", "1x4")
STEP_ARCHS = ("tinyllama-1.1b", "dbrx-132b")
DECODE_ARCHS = ("tinyllama-1.1b", "gpt2-small")
PEFT_KINDS = ("peft", "fl")
PEFT_MESHES = ("2x2", "1x4")
PEFT_TARGETS = ("mixer/wq", "mixer/wv", "mixer/wo", "ff/wg", "ff/wu", "ff/wd")
PEFT_LR = 1e-3
N_CLIENTS = 2


def _np(tree):
    return {k: np.asarray(v) for k, v in jtrees.flatten(tree).items()}


def _is_moe(cfg):
    return any(k.ff == "moe" for st in cfg.stages for k in st.pattern)


def _cfgs(arch):
    if arch == "llama-3heads":
        j = dataclasses.replace(jget("llama3.2-1b").reduced(d_model=96), n_heads=3,
                                n_kv_heads=3)
        p = dataclasses.replace(get_config("llama3.2-1b").reduced(d_model=96), n_heads=3,
                                n_kv_heads=3)
        return j, p
    return jget(arch).reduced(d_model=64), get_config(arch).reduced(d_model=64)


def _batch(cfg, seed):
    rng = np.random.RandomState(seed)
    if cfg.is_encoder_only:
        return {"tokens": rng.randint(6, cfg.vocab_size, (B, S)).astype(np.int32),
                "label": rng.randint(0, cfg.n_classes, (B,)).astype(np.int32)}
    toks = rng.randint(6, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    full = _is_moe(cfg)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": (np.ones((B, S)) if full else rng.rand(B, S) < 0.7).astype(np.float32)}
    if cfg.n_prefix_tokens:
        batch["patches"] = rng.randn(B, cfg.n_prefix_tokens, cfg.prefix_dim).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.randn(B, cfg.encoder_seq, cfg.d_model).astype(np.float32)
    return batch


def _shards(batch, d):
    return [{k: v[i * B // d:(i + 1) * B // d] for k, v in batch.items()} for i in range(d)]


def _jloss(jm, jcfg):
    if jcfg.is_encoder_only:
        return jax.jit(lambda p, b: jm.cls_loss(p, b)[0])
    return jax.jit(lambda p, b: jm.lm_loss(p, b))


def _oracle_loss(fn, jcfg, jp, batch, mesh):
    """JAX's loss as the mesh computes it: the unsharded loss, or for MoE
    on (2, 2) the mean of the data shards' losses."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if _is_moe(jcfg) and mesh == "2x2":
        return float(np.mean([float(fn(jp, s)) for s in _shards(jb, 2)]))
    return float(fn(jp, jb))


class _DataShardMean:
    """A JAX model whose ``lm_loss`` is the mean of the losses of its
    batch's ``d`` row blocks: the loss a MoE model computes with its batch
    sharded over ``d`` data ranks (balance loss and capacity per shard)."""

    def __init__(self, jm, d):
        self.jm, self.d = jm, d

    def lm_loss(self, params, batch, **kw):
        n = next(iter(batch.values())).shape[0] // self.d
        return sum(self.jm.lm_loss(params, {k: v[i * n:(i + 1) * n] for k, v in batch.items()},
                                   **kw) for i in range(self.d)) / self.d


def _peft_cases(arch, jcfg, cfg, flat):
    """The trainables of the PEFT and FL-round steps: random adapters in the
    parameter tree and each client's random LoRA factors (flat numpy), and
    the two cases' batches."""
    pc = peft.PEFTConfig(lora_rank=4, adapter_dim=4, lora_targets=PEFT_TARGETS)
    rng = np.random.RandomState(8)
    full = bridge.to_numpy(peft.init_adapters(torch.Generator().manual_seed(2),
                                              bridge.params_from_numpy(flat, cfg), cfg, pc))
    full = {k: (rng.randn(*v.shape) * 0.05).astype(np.float32)
            if peft.is_adapter_path(k) else v for k, v in full.items()}
    gen = torch.Generator().manual_seed(3)
    loras = [{k: v if k.endswith("/mask") else (rng.randn(*v.shape) * 0.05).astype(np.float32)
              for k, v in bridge.to_numpy(peft.init_lora(
                  gen, bridge.params_from_numpy(full, cfg), pc)).items()}
             for _ in range(N_CLIENTS)]
    per_client = [_batch(cfg, 20 + c) for c in range(N_CLIENTS)]
    batches = {"peft": _batch(cfg, 11),
               "fl": {k: np.stack([b[k] for b in per_client]) for k in per_client[0]}}
    return {kind: {"kind": kind, "cfg": cfg, "params": full, "pc": pc, "lr": PEFT_LR,
                   "loras": loras[:1] if kind == "peft" else loras, "batch": batches[kind],
                   "meshes": PEFT_MESHES} for kind in PEFT_KINDS}


def _peft_oracle(case, jm, jcfg, mesh):
    """JAX's ``make_peft_step`` / ``make_fl_round_step`` on the case: (loss,
    new trainables, AdamW's first moment), flat numpy."""
    cfg = case["cfg"]
    jpc = jpeft.PEFTConfig(**dataclasses.asdict(case["pc"]))
    jfull = _jtree(case["params"], cfg)
    tmpl = jpeft.init_lora(jax.random.PRNGKey(0), jfull, jpc)
    jloras = [jtrees.map_with_path(lambda p, v, lo=lo: jnp.asarray(lo[p]), tmpl)
              for lo in case["loras"]]
    jtrain = {"adapters": jtrees.select(jfull, lambda p: "/adapter/" in p),
              "lora": jloras[0] if case["kind"] == "peft" else jtrees.stack(jloras)}
    model = _DataShardMean(jm, 2) if _is_moe(jcfg) and mesh == "2x2" else jm
    step, opt = (jmake_peft_step(model, jpc, lr=PEFT_LR) if case["kind"] == "peft" else
                 jmake_fl_round_step(model, jpc, N_CLIENTS, lr=PEFT_LR))
    jb = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    new, st, loss = jax.jit(step)(jtrain, jfull, opt.init(jtrain), jb)
    return float(loss), _np(new), _np(st["mu"])


def _a2a_case():
    jcfg = jget("dbrx-132b").reduced(d_model=64)
    m = jcfg.moe
    rng = np.random.RandomState(5)
    d, f, e = jcfg.d_model, m.d_ff, m.n_experts
    case = {"kind": "a2a", "meshes": ("1x4",), "cfg": get_config("dbrx-132b").reduced(
                d_model=64).moe, "act": jcfg.act,
            "x": rng.randn(2, 16, d).astype(np.float32),
            "router": (rng.randn(d, e) * d ** -0.5).astype(np.float32),
            "wg": (rng.randn(e, d, f) * d ** -0.5).astype(np.float32),
            "wu": (rng.randn(e, d, f) * d ** -0.5).astype(np.float32),
            "wd": (rng.randn(e, f, d) * f ** -0.5).astype(np.float32),
            "r": rng.randn(2, 16, d).astype(np.float32)}
    n = 4
    e_loc = e // n

    def body(x, router, wg, wu, wd):
        return jmoe._local_moe_a2a(x, router, wg, wu, wd, cfg=m, act=jcfg.act, e_loc=e_loc,
                                   model_axis="model", n_model=n, axes=("model",))

    def f_(x, router, wg, wu, wd):
        xs = x.reshape(2, n, 16 // n, d).transpose(1, 0, 2, 3)
        sl = lambda w: w.reshape((n, e_loc) + w.shape[1:])  # noqa: E731
        y, aux = jax.vmap(body, in_axes=(0, None, 0, 0, 0), axis_name="model")(
            xs, router, sl(wg), sl(wu), sl(wd))
        return y.transpose(1, 0, 2, 3).reshape(2, 16, d), aux[0]

    def oracle():
        args = [jnp.asarray(case[k]) for k in ("x", "router", "wg", "wu", "wd")]
        y, aux = jax.jit(f_)(*args)
        grads = jax.jit(jax.grad(lambda *a: (f_(*a)[0] * case["r"]).sum() + f_(*a)[1],
                                 argnums=(0, 1, 2, 3, 4)))(*args)
        return {"y": np.asarray(y), "aux": float(aux),
                "grads": dict(zip(("x", "router", "wg", "wu", "wd"), map(np.asarray, grads)))}

    return case, oracle


def _sp_case():
    jcfg, cfg = _cfgs("mamba2-1.3b")
    pre = "stages/0/layers/0/mixer/"
    flat = {k[len(pre):]: v[0] for k, v in _init(cfg, 3).items() if k.startswith(pre)}
    rng = np.random.RandomState(6)
    flat["a_log"] = (rng.randn(*flat["a_log"].shape) * 0.3).astype(np.float32)
    x = rng.randn(2, 128, 64).astype(np.float32)
    r = rng.randn(2, 128, 64).astype(np.float32)
    case = {"kind": "sp", "meshes": ("1x4",), "cfg": get_config("mamba2-1.3b").reduced(
        d_model=64).ssm, "d_model": 64, "eps": jcfg.norm_eps, "x": x, "r": r, "p": flat}
    def f_(x, p):
        return jssm.mamba_seq(x, p, jcfg.ssm, 64, jcfg.norm_eps)[0]

    def oracle():
        p = ptrees.unflatten({k: jnp.asarray(v) for k, v in flat.items()})
        y = jax.jit(f_)(jnp.asarray(x), p)
        dx, dp = jax.jit(jax.grad(lambda x, p: (f_(x, p) * r).sum(), argnums=(0, 1)))(
            jnp.asarray(x), p)
        return {"y": np.asarray(y), "dx": np.asarray(dx), "grads": _np(dp)}

    return case, oracle


def _init(cfg, seed):
    """The port's random init (seeded), as flat numpy."""
    import torch
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(seed), max_seq=64)
    return bridge.to_numpy(params)


def _jtree(flat, cfg):
    """A flat numpy tree in the JAX package's nesting (the port's: the
    ``stages``/``layers`` levels lists)."""
    return ptrees.map_leaves(lambda t: jnp.asarray(t.numpy()),
                             bridge.params_from_numpy(flat, cfg))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases, setups = {}, {}
    for arch in ARCHS + ["llama-3heads"]:
        jcfg, cfg = _cfgs(arch)
        flat = _init(cfg, 0)
        jm = JModel(jcfg, meshctx=JMESH)
        batch = _batch(cfg, 1)
        setups[arch] = (jcfg, cfg, jm, flat, batch)
        cases[f"loss/{arch}"] = {
            "kind": "loss", "cfg": cfg, "params": flat, "batch": batch,
            "fn": "cls" if cfg.is_encoder_only else "lm",
            "meshes": ("2x2", "1x4") if arch == "llama-3heads" else MESHES}
    for arch in STEP_ARCHS:
        jcfg, cfg, jm, flat, batch = setups[arch]
        cases[f"step/{arch}"] = {"kind": "step", "cfg": cfg, "params": flat,
                                 "batch": batch, "lr": 1e-4, "meshes": MESHES}
    for arch in STEP_ARCHS:
        jcfg, cfg, jm, flat, batch = setups[arch]
        for kind, case in _peft_cases(arch, jcfg, cfg, flat).items():
            cases[f"{kind}/{arch}"] = case
    rng = np.random.RandomState(4)
    for arch in DECODE_ARCHS:
        jcfg, cfg, jm, flat, _ = setups[arch]
        pc = peft.PEFTConfig(lora_rank=4, lora_targets=("mixer/wq", "mixer/wv"))
        lora = {k: (v if k.endswith("/mask") else (rng.randn(*v.shape) * 0.1).astype(
            np.float32)) for k, v in bridge.to_numpy(peft.init_lora(
                torch.Generator().manual_seed(1), bridge.params_from_numpy(flat, cfg),
                pc)).items()}
        cases[f"decode/{arch}"] = {
            "kind": "decode", "cfg": cfg, "params": flat, "lora": lora, "scale": 2.0,
            "prompt": rng.randint(6, cfg.vocab_size, (B, 12)), "cache_len": 32,
            "next": [rng.randint(6, cfg.vocab_size, (B, 1)) for _ in range(8)],
            "meshes": ("2x2", "1x4")}
    cases["a2a"], a2a_want = _a2a_case()
    cases["sp"], sp_want = _sp_case()
    cases["cohort"] = {"kind": "cohort", "meshes": ("2x2",), "init": None,
                       "cfg": ArchRoundConfig(arch="llama3.2-1b", n_clients=3, rounds=1,
                                              local_steps=2, batch=3, seq_len=12,
                                              d_model=32, device="cpu")}
    wait = spawn(cases, tmp_path_factory.mktemp("tp"))
    # the oracles, while the workers run
    want = {"a2a": a2a_want(), "sp": sp_want()}
    for arch, (jcfg, cfg, jm, flat, batch) in setups.items():
        jp = _jtree(flat, cfg)
        fn = _jloss(jm, jcfg)
        for mesh in cases[f"loss/{arch}"]["meshes"]:
            want[(f"loss/{arch}", mesh)] = _oracle_loss(fn, jcfg, jp, batch, mesh)
    for arch in STEP_ARCHS:
        jcfg, cfg, jm, flat, batch = setups[arch]
        jp = _jtree(flat, cfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        step, opt = jmake_train_step(jm, lr=1e-4)
        new, st, loss = jax.jit(step)(jp, opt.init(jp), jb)
        want[(f"step/{arch}", "1x1")] = want[(f"step/{arch}", "1x4")] = (
            float(loss), _np(new), _np(st["mu"]))
        if _is_moe(jcfg):           # the mean of the data shards' losses
            opt = jadamw(1e-4, weight_decay=0.01)
            lf = lambda p: sum(jm.lm_loss(p, s) for s in _shards(jb, 2)) / 2  # noqa: E731
            loss, g = jax.jit(jax.value_and_grad(lf))(jp)
            upd, st = opt.update(g, opt.init(jp), jp)
            new = jtrees.tree_add(jp, upd)
        want[(f"step/{arch}", "2x2")] = (float(loss), _np(new), _np(st["mu"]))
    for arch in STEP_ARCHS:
        jcfg, cfg, jm, flat, batch = setups[arch]
        for kind in PEFT_KINDS:
            for mesh in PEFT_MESHES:          # without MoE both meshes' oracle is one
                want[(f"{kind}/{arch}", mesh)] = (
                    _peft_oracle(cases[f"{kind}/{arch}"], jm, jcfg, mesh)
                    if _is_moe(jcfg) or mesh == PEFT_MESHES[0] else
                    want[(f"{kind}/{arch}", PEFT_MESHES[0])])
    for arch in DECODE_ARCHS:
        c = cases[f"decode/{arch}"]
        plain = dict(c, kind="decode")
        from _torch_tp_worker import run_case
        want[f"decode/{arch}"] = run_case(plain, None).numpy()
    return want, wait()


def _each(ranks, key):
    return [r[key] for r in ranks if key in r]


@pytest.mark.parametrize("arch,mesh", [(a, m) for a in ARCHS for m in MESHES]
                         + [("llama-3heads", "2x2"), ("llama-3heads", "1x4")])
def test_loss_matches_jax(runs, arch, mesh):
    want, ranks = runs
    key = (f"loss/{arch}", mesh)
    got = _each(ranks, key)
    assert got and len({round(g, 7) for g in got}) == 1, got
    assert abs(got[0] - want[key]) <= LOSS_TOL, (got[0], want[key])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_jax(runs, arch, mesh):
    want, ranks = runs
    key = (f"step/{arch}", mesh)
    wloss, wparams, wmu = want[key]
    for got in _each(ranks, key):
        assert abs(got["loss"] - wloss) <= LOSS_TOL
        assert got["params"].keys() == wparams.keys()
        for p, v in wparams.items():
            keep = ~((np.abs(wmu[p] / 0.1) < 1e-7) & (wmu[p] != 0))
            np.testing.assert_allclose(got["params"][p][keep], v[keep], atol=PARAM_TOL,
                                       rtol=0, err_msg=p)


@pytest.mark.parametrize("mesh", PEFT_MESHES)
@pytest.mark.parametrize("arch", STEP_ARCHS)
@pytest.mark.parametrize("kind", PEFT_KINDS)
def test_peft_and_fl_round_steps_match_jax(runs, kind, arch, mesh):
    """LoRA's factors (B's local columns of a column-parallel weight, A's
    local rows of a row-parallel one, the experts' on their model rank),
    the adapters and ``sync_grads``' data sums, after one step."""
    want, ranks = runs
    key = (f"{kind}/{arch}", mesh)
    wloss, wtrain, wmu = want[key]
    got_all = _each(ranks, key)
    assert len(got_all) == 4
    for got in got_all:
        assert abs(got["loss"] - wloss) <= LOSS_TOL, (got["loss"], wloss)
        assert got["train"].keys() == wtrain.keys()
        for p, v in wtrain.items():
            keep = ~((np.abs(wmu[p] / 0.1) < 1e-7) & (wmu[p] != 0))
            np.testing.assert_allclose(got["train"][p][keep], v[keep], atol=PARAM_TOL,
                                       rtol=0, err_msg=p)


@pytest.mark.parametrize("mesh", ("2x2", "1x4"))
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_decode_matches_unsharded(runs, arch, mesh):
    want, ranks = runs
    for got in _each(ranks, (f"decode/{arch}", mesh)):
        np.testing.assert_allclose(got, want[f"decode/{arch}"], atol=DECODE_TOL, rtol=0)


def test_moe_a2a_matches_jax_local_moe_a2a(runs):
    want, ranks = runs
    w = want["a2a"]
    e_loc = w["grads"]["wg"].shape[0] // 4
    for r, got in enumerate(_each(ranks, ("a2a", "1x4"))):
        np.testing.assert_allclose(got["y"], w["y"], atol=1e-5, rtol=0)
        assert abs(float(got["aux"]) - w["aux"]) <= 1e-6
        for k in ("x", "router"):
            np.testing.assert_allclose(got["grads"][k], w["grads"][k], atol=1e-5, rtol=0)
        for k in ("wg", "wu", "wd"):
            np.testing.assert_allclose(got["grads"][k], w["grads"][k][r * e_loc:(r + 1) * e_loc],
                                       atol=1e-5, rtol=0, err_msg=k)


def test_mamba_sp_matches_jax_mamba_seq(runs):
    want, ranks = runs
    w = want["sp"]
    for got in _each(ranks, ("sp", "1x4")):
        np.testing.assert_allclose(got["y"], w["y"], atol=SP_ATOL, rtol=SP_RTOL)
        np.testing.assert_allclose(got["dx"], w["dx"], atol=SP_ATOL, rtol=SP_RTOL)
        for k, g in w["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g, atol=1e-4, rtol=SP_RTOL, err_msg=k)


def test_cohort_round_on_2x2_equals_2(runs):
    _, ranks = runs
    for got in _each(ranks, ("cohort", "2x2")):
        assert got["mesh"]["n_ghosts"] == got["data"]["n_ghosts"] == 1
        assert got["mesh"]["loss_per_round"] == got["data"]["loss_per_round"]
        for k, v in got["data"]["global_lora"].items():
            np.testing.assert_array_equal(got["mesh"]["global_lora"][k], v, err_msg=k)


def test_model_without_mesh_takes_mesh_opts():
    """``mamba_sp`` and ``moe_a2a`` no longer raise: without a mesh they
    fall back to the single-device mixers (bit-equal losses)."""
    cfg = get_config("jamba-v0.1-52b").reduced(d_model=64)
    base = Model(cfg, device="cpu")
    params = base.init(torch.Generator().manual_seed(0), max_seq=32)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2).items()}
    opt = Model(cfg, device="cpu", opts={"mamba_sp": True, "moe_a2a": True})
    assert torch.equal(base.lm_loss(params, batch), opt.lm_loss(params, batch))
    with pytest.raises(ValueError, match="unknown Model opts"):
        Model(cfg, device="cpu", opts={"moe_a2a_typo": True})


def test_steps_default_is_full_finetuning_on_the_1x1_mesh(tmp_path):
    """``launch.train --steps`` without ``--lora-rank`` is the JAX
    launcher's full fine-tuning (``make_train_step`` over every leaf), and
    without torchrun it runs the meshless ``Trainer``: the same losses and
    checkpointed parameters, bit for bit."""
    from repro_torch import trees
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch import train
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16", "--device", "cpu"]
    args = train.parse_args(argv)
    assert args.lora_rank == 0 and args.data_axis == 0
    tr = train.Trainer(args, remat=True)
    assert tr.peft_cfg is None and tr._step.__name__ == "train_step" and tr.mc is None
    path = str(tmp_path / "ck.npz")
    losses = train.main(argv + ["--ckpt", path])
    rng = np.random.RandomState(0)
    assert losses == [float(tr.step(tr.to_device(tr.batch(rng)))) for _ in range(2)]
    want = tr.params()
    got = trees.flatten(load_checkpoint(path, want))
    for k, v in trees.flatten(want).items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("clen,sparse", [(400, False), (1000, True), (700, True)])
def test_decode_segments_with_offsets_merge_to_whole(clen, sparse):
    """The sequence-split decode's arithmetic on one process: the plain
    ``decode_ref`` of each 256-slot segment at its position offset (an
    empty segment skipped), merged by ``attention.merge_by_lse``, equals the
    whole cache's decode, dense and under the sparse mask (whose blocks
    read absolute positions), and JAX's decode on the whole cache."""
    from repro.models.attention import decode_attention as jdecode
    from repro_torch.configs import SparseAttnConfig
    from repro_torch.kernels.decode_attn.ref import decode_ref
    from repro_torch.models.attention import merge_by_lse
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(*s).astype(np.float32) for s in ((2, 1, 4, 32), (2, 1024, 2, 32),
                                                          (2, 1024, 2, 32)))
    cfg = SparseAttnConfig(block_size=64, local_blocks=2, sink_blocks=1, stride=4) \
        if sparse else None
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    whole = decode_ref(tq, tk, tv, clen, sparse=cfg)
    parts = [decode_ref(tq, tk[:, o:o + 256].contiguous(), tv[:, o:o + 256].contiguous(),
                        clen, sparse=cfg, offset=o, return_lse=True)
             for o in range(0, 1024, 256) if clen - o >= 1]
    torch.testing.assert_close(merge_by_lse(parts), whole, atol=1e-6, rtol=1e-5)
    want = np.asarray(jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), clen,
                              sparse=cfg and _jsparse(cfg)))
    np.testing.assert_allclose(whole.numpy(), want, atol=1e-5, rtol=0)


def _jsparse(cfg):
    from repro.configs.base import SparseAttnConfig as J
    return J(**dataclasses.asdict(cfg))
