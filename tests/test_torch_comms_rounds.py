"""One round of each cohort engine with the compressed uplink, against the
JAX package's, on the CPU, from identical stacked state, with JAX's
uniforms and count-sketch hashes injected: ``build_supervised_round``
(fedlora's trainables: LoRA factors and the head uploaded; int8 and
count-sketch synchronous, int4 with ``factored_agg`` robust with a
straggler: each codec's leaves are held in ``test_torch_comms.py``, the
engine's wiring here) and ``build_ppo_round`` (int4; synchronous and
robust).  Bodies within
1e-5, payload bits within 1e-6 relative (the robust bodies' only for the
clients that train: the others send their pending payload and are charged
nothing here).  Then ``run_pfit`` (shepherd) with int4 and
``factored_agg`` from the JAX draws:
rewards within 1e-3 (``test_torch_pfit.py``'s gate), the ledger's totals
within ``test_torch_comms_runs.FLIP_RTOL`` (a run's quantizer symbols may
sit one step apart).  The fixtures are ``test_torch_fl.py``'s,
``test_torch_rlhf.py``'s and ``test_torch_pfit.py``'s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_comms import jax_hashes, jax_noise
from test_torch_comms_runs import FLIP_RTOL, jax_codec_noise
from test_torch_fl import round_setup  # noqa: F401  (a fixture)
from test_torch_pfit import KW as PFIT_KW
from test_torch_pfit import _export_init as pfit_init
from test_torch_rlhf import (B, GEN, PROMPT, _jparams, _port, _port_rm,  # noqa: F401
                             policy, reward_setup)
from test_torch_rlhf import jax_noise as jax_gumbel

from repro import trees as jtrees
from repro.comms import codec as jcodec
from repro.core import cohort as jcohort
from repro.core import pfit as jpfit
from repro.core import pftt as jpftt
from repro.models import Model as JModel
from repro.models import peft as jpeft
from repro.optim import adamw as jadamw
from repro.rlhf import ppo as jppo
from repro_torch import bridge, trees
from repro_torch.comms import codec
from repro_torch.configs import get_config
from repro_torch.core import cohort, pfit, pftt, rewards
from repro_torch.models import peft
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw, value_and_grad
from repro_torch.rlhf import ppo

TOL = 1e-5
BITS_RTOL = 1e-6


def _np(tree):
    return {k: np.asarray(v) for k, v in jtrees.flatten(tree).items()}


def _assert_flat(got, want, atol=TOL):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v), atol=atol, err_msg=k)


def _codec(name):
    return codec.get_codec(name, **({"hashes": jax_hashes} if name == "countsketch" else {}))


# --------------------------------------------------------------- supervised
SUP_ROBUST = ([1, 0, 1], [1.0, 0.5, 0.7], [1, 0, 1], [0, 0, 0], [1, 1, 1])


@pytest.mark.parametrize("name, factored, robust", [
    ("int8", False, False), ("countsketch", False, False), ("int4", True, True)])
def test_supervised_round_with_codec_matches_jax(round_setup, name, factored,  # noqa: F811
                                                 robust):
    """One round of fedlora's body (3 clients, 2 AdamW steps, ragged
    batches; LoRA factors and the head uploaded): trainables, optimizer
    state (and ``pending``, the decoded uploads) within 1e-5 of JAX's, the
    bits within 1e-6.  Robust: client 1 straggles and retransmits a pending
    payload at a discount."""
    jcfg, pc, jparams, loras, batches = round_setup
    pred = pftt._upload_pred("fedlora")
    jmodel, jopt = JModel(jcfg), jadamw(1e-2, update_mask=lambda p: not p.endswith("/mask"))
    scale = jpeft.lora_scale(pc)

    def jlocal(t, o, batch):
        def loss_fn(t):
            full, lora = jpftt._split_trainable("fedlora", jparams, t)
            return jmodel.cls_loss(full, batch, lora=lora, lora_scale=scale)[0]
        loss, g = jax.value_and_grad(loss_fn)(t)
        upd, o = jopt.update(g, o, t)
        return jtrees.tree_add(t, upd), o, loss

    cfg = get_config("roberta-base").reduced(d_model=64, repeats=2)
    model = Model(cfg, device="cpu")
    params = bridge.params_from_numpy(_np(jparams), cfg)
    opt = adamw(1e-2, update_mask=lambda p: not p.endswith("/mask"))
    tscale = peft.lora_scale(peft.PEFTConfig(lora_rank=4))

    def local(t, o, batch):
        def loss_fn(t):
            full, lora = pftt._split_trainable("fedlora", params, t)
            return model.cls_loss(full, batch, lora=lora, lora_scale=tscale)[0]
        loss, g = value_and_grad(loss_fn, t)
        upd, o = opt.update(g, o, t)
        return trees.tree_add(t, upd), o, loss

    jst = jtrees.stack([jpftt._build_trainable("fedlora", jparams, lo) for lo in loras])
    st = trees.stack([pftt._build_trainable("fedlora", params,
                                            bridge.lora_from_numpy(_np(lo), cfg))
                      for lo in loras])
    jso = jtrees.stack([jopt.init(jpftt._build_trainable("fedlora", jparams, lo))
                        for lo in loras])
    so = trees.stack([opt.init(t) for t in trees.unstack(st)])
    keys = [jax.random.fold_in(jax.random.PRNGKey(3), ci) for ci in range(3)]
    kw = dict(codec=jcodec.get_codec(name), factored_agg=factored, robust=robust)
    jround = jcohort.build_supervised_round(jlocal, pred, donate=False, **kw)
    rnd = cohort.build_supervised_round(local, pred, **dict(kw, codec=_codec(name)))
    noises = [jax_noise(k) for k in keys]
    if robust:
        masks = [np.asarray(m, np.float32) for m in SUP_ROBUST]
        rng = np.random.RandomState(7)
        moved = {k: (rng.randn(*v.shape) * 0.05).astype(np.float32)
                 for k, v in trees.flatten(st).items()}
        pend = trees.map_with_path(lambda p, v: v + torch.from_numpy(moved[p]), st)
        jpend = jtrees.map_with_path(lambda p, v: v + moved[p], jst)
        jout = jround(jst, jso, jpend, jcohort.HostBatchStacker()(batches),
                      *(jnp.asarray(m) for m in masks), jnp.stack(keys))
        out = rnd(st, so, pend, cohort.HostBatchStacker("cpu")(batches),
                  *(torch.from_numpy(m) for m in masks), noises)
        trained = masks[0] > 0
        jtrees_out, jbits = jout[:3], np.asarray(jout[4])
        trees_out, bits = out[:3], out[4].numpy()
    else:
        w = np.asarray([1.0, 0.0, 1.0], np.float32)
        jout = jround(jst, jso, jcohort.HostBatchStacker()(batches), jnp.asarray(w),
                      jnp.stack(keys))
        out = rnd(st, so, cohort.HostBatchStacker("cpu")(batches), torch.from_numpy(w), noises)
        trained = np.ones(3, bool)
        jtrees_out, jbits = jout[:2], np.asarray(jout[3])
        trees_out, bits = out[:2], out[3].numpy()
    for got, want in zip(trees_out, jtrees_out):
        _assert_flat(bridge.to_numpy(got), _np(want))
    np.testing.assert_allclose(bits[trained], jbits[trained], rtol=BITS_RTOL)
    assert (bits[~trained] == 0).all() and (bits[trained] > 0).all()


# --------------------------------------------------------------- PPO
@pytest.mark.parametrize("robust", [False, True], ids=["sync", "robust"])
def test_ppo_round_with_codec_matches_jax(policy, reward_setup, robust):  # noqa: F811
    """One PPO round (2 clients, JAX's Gumbel noise, 2 masked epochs) with
    int4: each client's whole params coded against its round-input params,
    charged on its sparsity mask.  Every output within 1e-5 of JAX's, bits
    within 1e-6; robust: client 1 straggles, its bits 0."""
    samples, (jh, js) = reward_setup
    jcfg, cfg = policy["jcfg"], policy["cfg"]
    jmodel, jp = JModel(jcfg), _jparams(policy["params"])
    jopt = jadamw(4e-4)
    keeps = [np.asarray(jax.random.permutation(jax.random.PRNGKey(s), 4)[:2]) for s in (0, 1)]
    jmasks = [jax.tree_util.tree_map(lambda a, b: a * b,
                                     jpeft.last_k_layers_mask(jp, jcfg, 1),
                                     jpeft.head_sparsity_mask(jp, jcfg, 0.5, seed=s))
              for s in (0, 1)]

    def jquality(toks, mask, ah, asafe):
        return ah * jh.score(jh.params, toks, mask) + asafe * js.score(js.params, toks, mask)

    prompts = np.stack([policy["prompts"], policy["prompts"][::-1]])
    keys = [jax.random.fold_in(jax.random.PRNGKey(0), 17 + ci) for ci in range(2)]
    ckeys = [jax.random.fold_in(jax.random.PRNGKey(9), ci) for ci in range(2)]
    ah, asafe = [0.25, 0.75], [0.75, 0.25]
    kw = dict(lambda_regs=[1e-3, 1e-3], robust=robust)
    jround = jcohort.build_ppo_round(jmodel, jopt, jppo.PPOConfig(), PROMPT, GEN, jquality,
                                     donate=False, codec=jcodec.get_codec("int4"), **kw)
    model, params = _port(policy)
    rh, rs = _port_rm(jh), _port_rm(js)
    d = rewards.DoubleReward(rh, rh.params, rs, rs.params)
    opt = adamw(4e-4)
    masks = [trees.map_leaves(lambda a, b: a * b, peft.last_k_layers_mask(params, cfg, 1),
                              peft.head_sparsity_mask(params, cfg, 0.5, s, keep=k))
             for s, k in zip((0, 1), keeps)]
    rnd = cohort.build_ppo_round(
        model, opt, ppo.PPOConfig(), PROMPT, GEN,
        lambda t, m, a, s: d.quality(t, m, rewards.ClientPreference(a, s)),
        codec=codec.get_codec("int4"), **kw)
    gumbel = [jax_gumbel(k, GEN, B, cfg.vocab_size) for k in keys]
    jstate = (jtrees.stack([jp, jp]), jtrees.stack([jopt.init(jp)] * 2), jp)
    state = (trees.stack([params, params]), trees.stack([opt.init(params)] * 2), params)
    common = (jnp.asarray(prompts), jnp.stack(keys), jnp.asarray(ah), jnp.asarray(asafe))
    if robust:
        # (agg_w, train, recv, rejoin, ontime): client 1 straggles
        m = [np.asarray(x, np.float32) for x in ([1.0, 0.5], [1, 0], [1, 1], [0, 0], [1, 1])]
        jout = jround(*jstate, jtrees.stack([jp, jp]), jtrees.stack(jmasks), *common,
                      *(jnp.asarray(x) for x in m), jnp.stack(ckeys))
        out = rnd(*state, trees.stack([params, params]), trees.stack(masks),
                  torch.from_numpy(prompts), gumbel, ah, asafe,
                  *(torch.from_numpy(x) for x in m), [jax_noise(k) for k in ckeys])
        trained = m[1] > 0
    else:
        w = jnp.asarray([1.0, 1.0], jnp.float32)
        jout = jround(*jstate, jtrees.stack(jmasks), *common, w, jnp.stack(ckeys))
        out = rnd(*state, trees.stack(masks), torch.from_numpy(prompts), gumbel, ah, asafe,
                  torch.ones(2), [jax_noise(k) for k in ckeys])
        trained = np.ones(2, bool)
    for i, (got, want) in enumerate(zip(out[:-1], jout[:-1])):
        if isinstance(got, dict):
            _assert_flat(bridge.to_numpy(got), _np(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    bits, jbits = out[-1].numpy(), np.asarray(jout[-1])
    np.testing.assert_allclose(bits[trained], jbits[trained], rtol=BITS_RTOL)
    assert (bits[~trained] == 0).all()


# --------------------------------------------------------------- run_pfit
PFIT_INT4 = dict(PFIT_KW, uplink_codec="int4", factored_agg=True)


def test_run_pfit_with_int4_matches_jax():
    """``run_pfit`` (shepherd: its LoRA uploads through the supervised
    engine's codec, aggregated by the SVD re-projection) with int4 from
    the JAX draws: the reward per round within 1e-3, the ledger's totals
    within ``FLIP_RTOL``.  (The PPO methods' codec is held against JAX one
    round at a time above; their JAX runs cost several times shepherd's
    under the suite's parallel workers.)"""
    jcfg = jpfit.PFITConfig(method="shepherd", **PFIT_INT4)
    want = jpfit.run_pfit(jcfg)
    init = dict(pfit_init(jcfg), codec_noise=jax_codec_noise(jcfg.seed))
    got = pfit.run_pfit(pfit.PFITConfig(method="shepherd", device="cpu", **PFIT_INT4),
                        init=init)
    np.testing.assert_allclose(got["reward_per_round"], want["reward_per_round"], atol=1e-3)
    for k in ("total_bytes", "total_energy_j", "mean_round_delay_s", "mean_round_bytes"):
        np.testing.assert_allclose(got[k], want[k], rtol=FLIP_RTOL, err_msg=k)
    assert got["uplink_codec"] == "int4" and got["total_bytes"] > 0
