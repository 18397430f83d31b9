"""The port's robust-round pieces against the JAX package, on the CPU: the
numpy copies (``wireless/faults.py``, ``wireless/arrivals.py``,
``core/robust.py``) draw for draw and field for field, ``ChannelBudget``'s
attempt accounting, ``StalenessWeightedAggregator`` (≤ 1e-6), and one round
of each robust engine body from identical stacked state and hand-set fault
masks against JAX's ``build_supervised_round(robust=True)`` and
``build_ppo_round(robust=True)`` (≤ 1e-5; the fixtures of
``test_torch_fl.py`` and ``test_torch_rlhf.py``).  Where pure selection
decides a value (a client that does not train, a client the broadcast
skips, the pending copy, a zeroed optimizer state, a voided round) it must
be bitwise; all-ones masks must give bitwise the synchronous round."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_fl import round_setup  # noqa: F401  (a fixture)
from test_torch_rlhf import (B, GEN, PROMPT, _jparams, _port, _port_rm, jax_noise,
                             policy, reward_setup)  # noqa: F401  (fixtures)

from repro import trees as jtrees
from repro.comms.codec import ChannelBudget as JBudget
from repro.core import async_agg as jasync
from repro.core import cohort as jcohort
from repro.core import pftt as jpftt
from repro.core import robust as jrobust
from repro.models import Model as JModel
from repro.models import peft as jpeft
from repro.optim import adamw as jadamw
from repro.rlhf import ppo as jppo
from repro.wireless import arrivals as jarrivals
from repro.wireless import channel as jchannel
from repro.wireless import faults as jfaults
from repro_torch import bridge, trees
from repro_torch.comms import ChannelBudget
from repro_torch.configs import get_config
from repro_torch.core import async_agg, cohort, pftt, rewards, robust
from repro_torch.models import peft
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw, value_and_grad
from repro_torch.rlhf import ppo
from repro_torch.wireless import arrivals, channel, faults

TOL = 1e-5
FULL_PLAN = dict(dropout_p=0.2, straggle_p=0.25, max_straggle=2, crash_p=0.1, max_crash=3,
                 snr_dip_p=0.2, seed=7)                          # tests/test_faults.py
MIX = dict(dropout_p=0.25, straggle_p=0.3, max_straggle=2, crash_p=0.1, max_crash=1,
           snr_dip_p=0.2, corrupt_p=0.25, seed=5)               # tests/test_deadline.py
TRACE_FIELDS = ("train", "tx", "recv", "rejoin", "gain_scale", "corrupt", "compute_scale")


def _np(tree):
    return {k: np.asarray(v) for k, v in jtrees.flatten(tree).items()}


def _assert_flat(got, want, atol=TOL):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v), atol=atol, err_msg=k)


# --------------------------------------------------------------- numpy copies
@pytest.mark.parametrize("plan", [FULL_PLAN, MIX, {}], ids=["full", "mix", "zero"])
def test_fault_plan_realize_matches_jax(plan):
    """Every mask of the realized trace equal, past-horizon rounds equal,
    and the trace prefix-stable (a shorter horizon is the longer's head)."""
    got, want = faults.FaultPlan(**plan), jfaults.FaultPlan(**plan)
    assert got.is_zero() == want.is_zero() == (not plan)
    t, jt = got.realize(5, 12), want.realize(5, 12)
    short = got.realize(5, 7)
    for f in TRACE_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(jt, f), err_msg=f)
        np.testing.assert_array_equal(getattr(short, f), getattr(t, f)[:7], err_msg=f)
    for r in (3, 12, 20):
        a, b = t.round(r), jt.round(r)
        for f in TRACE_FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    if plan:
        assert t.train.min() == 0 and t.rejoin.max() == 1
    if plan.get("corrupt_p"):
        assert t.corrupt.max() == 1


def test_plan_and_deadline_specs_match_jax(tmp_path):
    """``from_spec`` (inline, a JSON file, none), ``from_dict`` with an
    unknown key, ``to_dict``, and ``DeadlineConfig``'s ``is_inert``, for
    both copies."""
    spec = "dropout_p=0.3,straggle_p=0.2,max_straggle=4,corrupt_p=0.1,seed=1"
    assert faults.FaultPlan.from_spec(spec).to_dict() == \
        jfaults.FaultPlan.from_spec(spec).to_dict()
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(MIX))
    assert faults.FaultPlan.from_spec(str(path)) == faults.FaultPlan(**MIX)
    assert jfaults.FaultPlan.from_spec(str(path)).to_dict() == MIX | {
        k: v for k, v in jfaults.FaultPlan().to_dict().items() if k not in MIX}
    dspec = "deadline_s=0.5,min_quorum=2,max_retries=3,backoff_base_s=0.01"
    assert arrivals.DeadlineConfig.from_spec(dspec).to_dict() == \
        jarrivals.DeadlineConfig.from_spec(dspec).to_dict()
    inf = arrivals.DeadlineConfig.from_spec("deadline_s=inf")
    assert inf.is_inert() and jarrivals.DeadlineConfig.from_spec("deadline_s=inf").is_inert()
    for mod, jmod, bad in ((faults.FaultPlan, jfaults.FaultPlan, {"drop": 0.1}),
                           (arrivals.DeadlineConfig, jarrivals.DeadlineConfig, {"cutoff": 1.0})):
        for m in (mod, jmod):
            assert m.from_spec(None) is None and m.from_spec("none") is None
            with pytest.raises(ValueError, match="unknown"):
                m.from_dict(bad)
            with pytest.raises(ValueError, match="unknown"):
                m.from_spec(",".join(f"{k}={v}" for k, v in bad.items()))
            with pytest.raises(ValueError, match="key=value"):
                m.from_spec("seed")
    assert not arrivals.DeadlineConfig(min_quorum=1).is_inert()


def test_arrival_model_matches_jax():
    """Rates, compute-time draws (with and without the straggle scale),
    ``burn_round`` and the backoff waits, draw for draw."""
    dl = dict(deadline_s=0.1, backoff_base_s=0.02, compute_mean_s=0.01, seed=4)
    ch, jch = channel.RayleighChannel(seed=3), jchannel.RayleighChannel(seed=3)
    am = arrivals.ArrivalModel(ch, arrivals.DeadlineConfig(**dl), 5)
    jam = jarrivals.ArrivalModel(jch, jarrivals.DeadlineConfig(**dl), 5)
    for r in range(4):
        g = ch.realize(5) * (0.01 if r == 2 else 1.0)
        np.testing.assert_array_equal(am.rates(g), jam.rates(g))
        scale = None if r % 2 else np.array([1, 3, 1, 2, 1], np.float32)
        np.testing.assert_array_equal(am.compute_times(scale), jam.compute_times(scale))
        if r == 1:
            am.burn_round()
            jam.burn_round()
    fails = np.array([0, 1, 2, 5, 0])
    np.testing.assert_array_equal(am.backoff_wait_s(fails), jam.backoff_wait_s(fails))


def _tracker_pair(mode):
    """The port's and the JAX tracker over one plan and channel seed; in
    deadline mode a quorum of 2 and no retry, so the 6 rounds hold quorum
    no-ops and abandoned payloads (asserted by the test)."""
    cfg = dict(alpha=0.8, a=0.5, max_staleness=3)
    if mode == "round":
        return (robust.StalenessTracker(4, robust.StalenessConfig(**cfg)),
                jrobust.StalenessTracker(4, jrobust.StalenessConfig(**cfg)), None, None)
    dl = dict(deadline_s=0.1, backoff_base_s=0.01, max_retries=0, min_quorum=2,
              compute_mean_s=0.005, seed=11)
    ch, jch = channel.RayleighChannel(seed=0), jchannel.RayleighChannel(seed=0)
    d, jd = arrivals.DeadlineConfig(**dl), jarrivals.DeadlineConfig(**dl)
    return (robust.StalenessTracker(4, robust.StalenessConfig(**cfg), deadline=d,
                                    arrivals=arrivals.ArrivalModel(ch, d, 4)),
            jrobust.StalenessTracker(4, jrobust.StalenessConfig(**cfg), deadline=jd,
                                     arrivals=jarrivals.ArrivalModel(jch, jd, 4)), ch, jch)


@pytest.mark.parametrize("mode", ["round", "deadline"])
def test_staleness_tracker_matches_jax(mode):
    """Six rounds of ``begin_round``/``end_round`` under a fault plan with
    stragglers, crashes, dips and corruption: every ``RoundPlan`` field and
    every charge equal; the counters equal; ``state_dict`` through JSON
    restores a tracker that goes on identically."""
    plan = dict(dropout_p=0.1, straggle_p=0.2, max_straggle=2, crash_p=0.1, max_crash=1,
                snr_dip_p=0.2, corrupt_p=0.25, seed=5)
    trace, jtrace = faults.FaultPlan(**plan).realize(4, 6), jfaults.FaultPlan(**plan).realize(4, 6)
    tk, jtk, ch, jch = _tracker_pair(mode)
    if ch is None:
        ch, jch = channel.RayleighChannel(seed=0), jchannel.RayleighChannel(seed=0)
    bits = np.array([6e4, 8e4, 5e4, 7e4])
    for r in range(6):
        rf, jrf = trace.round(r), jtrace.round(r)
        g, jg = ch.realize(4) * rf.gain_scale, jch.realize(4) * jrf.gain_scale
        kw = dict(gains=g, fresh_bits=bits) if mode == "deadline" else {}
        jkw = dict(gains=jg, fresh_bits=bits) if mode == "deadline" else {}
        p = tk.begin_round(rf, ch.outage_weights(g), **kw)
        jp = jtk.begin_round(jrf, jch.outage_weights(jg), **jkw)
        for f in dataclasses.fields(jp):
            a, b = getattr(p, f.name), getattr(jp, f.name)
            if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name
        np.testing.assert_array_equal(tk.end_round(p, bits * (1 + r)),
                                      jtk.end_round(jp, bits * (1 + r)))
        assert tk.counters() == jtk.counters()
        if r == 2:   # restore a tracker from JSON and carry on with it
            state = json.loads(json.dumps(tk.state_dict()))
            assert state == json.loads(json.dumps(jtk.state_dict()))
            tk2, _, _, _ = _tracker_pair(mode)
            tk2.load_state_dict(state)
            if mode == "deadline":
                tk2.arrivals = tk.arrivals
            tk = tk2
    c = tk.counters()
    assert c["retransmissions"] > 0
    if mode == "deadline":
        assert c["quorum_noops"] > 0 and c["abandoned"] > 0


def test_channel_budget_attempts_match_jax():
    ch, jch = channel.RayleighChannel(seed=1), jchannel.RayleighChannel(seed=1)
    bud, jbud = ChannelBudget(ch, tx_power_w=0.3), JBudget(jch, tx_power_w=0.3)
    for bits, gain in ((8e4, 1.3), (1234.5, 0.02), (0.0, 0.7), (5e5, 1e-9)):
        assert bud.tx_seconds(bits, gain) == jbud.tx_seconds(bits, gain)
        for delivered in (True, False):
            kw = dict(tx_time_s=0.031, arrival_s=0.044, delivered=delivered)
            assert dataclasses.asdict(bud.attempt_report(bits, gain, **kw)) == \
                dataclasses.asdict(jbud.attempt_report(bits, gain, **kw))


def test_staleness_weighted_aggregator_matches_jax():
    """Three server rounds of FedAsync merges (one, three and no arrivals,
    at several stalenesses): the global within 1e-6."""
    rng = np.random.RandomState(0)
    mk = lambda: {"w": rng.randn(3, 4).astype(np.float32),  # noqa: E731
                  "b": [rng.randn(4).astype(np.float32)]}
    g0 = mk()
    agg = async_agg.StalenessWeightedAggregator(trees.map_leaves(torch.from_numpy, g0))
    jagg = jasync.StalenessWeightedAggregator(jax.tree_util.tree_map(jnp.asarray, g0))
    for arrivals_ in ([(mk(), 0)], [(mk(), 1), (mk(), 0), (mk(), -1)], []):
        for tree, produced in arrivals_:
            agg.submit(trees.map_leaves(torch.from_numpy, tree), produced)
            jagg.submit(jax.tree_util.tree_map(jnp.asarray, tree), produced)
        _assert_flat(bridge.to_numpy(agg.step()), _np(jagg.step()), atol=1e-6)
    assert agg.round == jagg.round == 3


# --------------------------------------------------------------- supervised body
SUP_MASKS = {   # (train, agg_w, recv, rejoin, ontime), 3 clients
    # client 1 straggles (retransmits its pending payload at a discount and
    # skips the broadcast), client 2 rejoins (no payload, zeroed optimizer)
    "straggle_rejoin": ([1, 0, 0], [1.0, 0.5, 0.0], [1, 0, 1], [0, 0, 1], [1, 1, 1]),
    # client 2 misses the deadline: one delivery under a quorum of 2 voids it
    "quorum_void": ([1, 1, 1], [1.0, 0.0, 0.7], [1, 1, 1], [0, 0, 0], [1, 1, 0]),
}


def _pending(st, pred, rng):
    """A pending buffer of earlier payloads: the uploaded subtree, moved."""
    return trees.map_leaves(lambda v: v + torch.from_numpy(
        (rng.randn(*v.shape) * 0.05).astype(np.float32)), trees.select(st, pred))


@pytest.mark.parametrize("case", list(SUP_MASKS))
def test_supervised_robust_round_matches_jax(round_setup, case):  # noqa: F811
    """One robust round of PFTT's body (3 clients, 2 local steps, ragged
    batches) from identical stacked state, pending buffer and masks: state,
    optimizer, pending and losses ≤ 1e-5 against JAX; the non-training
    clients' trainables and optimizer state bitwise kept (the rejoining
    one's zeroed, step included), ``pending`` a fresh upload where a client
    trained and bitwise the old payload elsewhere, and a voided round's
    shared leaves bitwise the trained ones (no broadcast)."""
    jcfg, pc, jparams, loras, batches = round_setup
    train, agg_w, recv, rejoin, ontime = (np.asarray(m, np.float32) for m in SUP_MASKS[case])
    quorum = 2 if case == "quorum_void" else 0
    pred = pftt._upload_pred("pftt")
    jmodel, jopt = JModel(jcfg), jadamw(1e-2, update_mask=lambda p: not p.endswith("/mask"))
    scale = jpeft.lora_scale(pc)

    def jlocal(t, o, batch):
        def loss_fn(t):
            full, lora = jpftt._split_trainable("pftt", jparams, t)
            return jmodel.cls_loss(full, batch, lora=lora, lora_scale=scale)[0]
        loss, g = jax.value_and_grad(loss_fn)(t)
        upd, o = jopt.update(g, o, t)
        return jtrees.tree_add(t, upd), o, loss

    jround = jcohort.build_supervised_round(jlocal, pred, robust=True, min_quorum=quorum,
                                            donate=False)
    cfg = get_config("roberta-base").reduced(d_model=64, repeats=2)
    model = Model(cfg, device="cpu")
    params = bridge.params_from_numpy(_np(jparams), cfg)
    opt = adamw(1e-2, update_mask=lambda p: not p.endswith("/mask"))
    tscale = peft.lora_scale(peft.PEFTConfig(lora_rank=4))

    def local(t, o, batch):
        def loss_fn(t):
            full, lora = pftt._split_trainable("pftt", params, t)
            return model.cls_loss(full, batch, lora=lora, lora_scale=tscale)[0]
        loss, g = value_and_grad(loss_fn, t)
        upd, o = opt.update(g, o, t)
        return trees.tree_add(t, upd), o, loss

    ts = [pftt._build_trainable("pftt", params, bridge.lora_from_numpy(_np(lo), cfg))
          for lo in loras]
    jts = [jpftt._build_trainable("pftt", jparams, lo) for lo in loras]
    # clients that trained before (nonzero moments and step, to keep or to
    # zero) and a pending buffer of earlier payloads (the uploaded subtree,
    # moved)
    st, jst = trees.stack(ts), jtrees.stack(jts)
    so = trees.map_leaves(_bump, trees.stack([opt.init(t) for t in ts]))
    jso = jax.tree_util.tree_map(_bump, jtrees.stack([jopt.init(t) for t in jts]))
    rng = np.random.RandomState(7)
    moved = {k: (rng.randn(*v.shape) * 0.05).astype(np.float32)
             for k, v in sorted(trees.flatten(trees.select(st, pred)).items())}
    pend = trees.map_with_path(lambda p, v: v + torch.from_numpy(moved[p]),
                               trees.select(st, pred))
    jpend = jtrees.map_with_path(lambda p, v: v + moved[p], jtrees.select(jst, pred))
    before = {k: v.clone() for k, v in trees.flatten({"t": st, "o": so, "p": pend}).items()}
    jout = jround(jst, jso, jpend, jcohort.HostBatchStacker()(batches),
                  *(jnp.asarray(m) for m in (train, agg_w, recv, rejoin, ontime)))
    rnd = cohort.build_supervised_round(local, pred, robust=True, min_quorum=quorum)
    out = rnd(st, so, pend, cohort.HostBatchStacker("cpu")(batches),
              *(torch.from_numpy(m) for m in (train, agg_w, recv, rejoin, ontime)))
    for got, want in zip(out[:3], jout[:3]):
        _assert_flat(bridge.to_numpy(got), _np(want))
    np.testing.assert_allclose(out[3].numpy(), np.asarray(jout[3]), atol=TOL)
    flat = trees.flatten({"t": out[0], "o": out[1], "p": out[2]})
    for k, v in flat.items():
        old = before[k]
        for ci in range(3):
            if k.startswith("o/") and rejoin[ci]:
                assert not v[ci].any(), k
            elif k.startswith(("t/", "o/")) and not train[ci] and (
                    k.startswith("o/") or not recv[ci] or not pred(k[2:])):
                assert torch.equal(v[ci], old[ci]), k
            elif k.startswith("p/") and not train[ci]:
                assert torch.equal(v[ci], old[ci]), k
            elif k.startswith("p/"):    # the fresh upload, before any broadcast
                assert not torch.equal(v[ci], old[ci]), k
    assert not out[3][train == 0].any()
    if case == "quorum_void":           # no broadcast: each keeps its upload
        for k, v in trees.flatten(out[2]).items():
            assert torch.equal(trees.flatten(out[0])[k], v), k


def _bump(v):
    """A leaf of a fresh optimizer state moved as if the client had trained
    before: moments + 0.01, step + 1."""
    return v + 1 if v.dtype in (torch.int32, jnp.int32) else v + 0.01


def test_supervised_robust_all_ones_is_bitwise_sync(round_setup):  # noqa: F811
    """All-ones masks, outage weights and any pending buffer: the robust
    body's state, optimizer and losses are bitwise the synchronous round's
    (JAX's ``robust=True`` docstring), and ``pending`` is bitwise the
    uploaded subtree."""
    jcfg, pc, jparams, loras, batches = round_setup
    cfg = get_config("roberta-base").reduced(d_model=64, repeats=2)
    model = Model(cfg, device="cpu")
    params = bridge.params_from_numpy(_np(jparams), cfg)
    opt = adamw(1e-2, update_mask=lambda p: not p.endswith("/mask"))
    tscale = peft.lora_scale(peft.PEFTConfig(lora_rank=4))
    pred = pftt._upload_pred("pftt")

    def local(t, o, batch):
        def loss_fn(t):
            full, lora = pftt._split_trainable("pftt", params, t)
            return model.cls_loss(full, batch, lora=lora, lora_scale=tscale)[0]
        loss, g = value_and_grad(loss_fn, t)
        upd, o = opt.update(g, o, t)
        return trees.tree_add(t, upd), o, loss

    def state():
        ts = [pftt._build_trainable("pftt", params, bridge.lora_from_numpy(_np(lo), cfg))
              for lo in loras]
        return trees.stack(ts), trees.stack([opt.init(t) for t in ts])

    w = torch.tensor([1.0, 0.0, 1.0])
    one = torch.ones(3)
    sync = cohort.build_supervised_round(local, pred)(*state(), cohort.HostBatchStacker("cpu")(
        batches), w)
    st, so = state()
    rob = cohort.build_supervised_round(local, pred, robust=True)(
        st, so, _pending(st, pred, np.random.RandomState(1)),
        cohort.HostBatchStacker("cpu")(batches), one, w, one, torch.zeros(3), one)
    for a, b in ((sync[0], rob[0]), (sync[1], rob[1])):
        for k, v in trees.flatten(a).items():
            assert torch.equal(v, trees.flatten(b)[k]), k
    assert torch.equal(sync[2], rob[3])


# --------------------------------------------------------------- PPO body
PPO_MASKS = {   # (train, agg_w, recv, rejoin, ontime), 2 clients, quorum 2
    # client 1 straggles: it retransmits its pending payload at a discount
    # and skips the broadcast; client 0 trains and takes it
    "straggle": ([1, 0], [1.0, 0.5], [1, 0], [0, 0], [1, 1]),
    # client 1 rejoins (zeroed optimizer) and client 0's upload misses the
    # deadline: one delivery under the quorum of 2 voids the round
    "rejoin_void": ([1, 0], [1.0, 0.6], [1, 1], [0, 1], [0, 1]),
}


@pytest.mark.parametrize("case", list(PPO_MASKS))
def test_ppo_robust_round_matches_jax(policy, reward_setup, case):  # noqa: F811
    """One robust PPO round (2 clients, JAX's Gumbel noise, the double
    reward minus the λ·L2 pull, 2 masked epochs) from identical stacked
    state, pending buffer and masks, ``min_quorum`` 2: the clients, their
    optimizer state, ``pending``, rewards and KLs ≤ 1e-5 against JAX, the
    selected values bitwise.  The new global too, except in the voided
    round: there JAX's fused body returns its ungated aggregate while its
    per-client loop keeps the global; the port keeps it, bitwise."""
    samples, (jh, js) = reward_setup
    train, agg_w, recv, rejoin, ontime = (np.asarray(m, np.float32) for m in PPO_MASKS[case])
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

    rng = np.random.RandomState(3)
    pend_np = {k: v + (rng.randn(2, *v.shape) * 0.05).astype(np.float32)
               for k, v in policy["params"].items()}
    prompts = np.stack([policy["prompts"], policy["prompts"][::-1]])
    keys = [jax.random.fold_in(jax.random.PRNGKey(0), 17 + ci) for ci in range(2)]
    ah, asafe = [0.25, 0.75], [0.75, 0.25]
    jround = jcohort.build_ppo_round(jmodel, jopt, jppo.PPOConfig(), PROMPT, GEN, jquality,
                                     lambda_regs=[1e-3, 1e-3], donate=False, robust=True,
                                     min_quorum=2)
    jso = jax.tree_util.tree_map(_bump, jtrees.stack([jopt.init(jp)] * 2))
    jpend = jtrees.map_with_path(lambda p, v: jnp.asarray(pend_np[p]), jtrees.stack([jp, jp]))
    jout = jround(jtrees.stack([jp, jp]), jso, jp, jpend, jtrees.stack(jmasks),
                  jnp.asarray(prompts), jnp.stack(keys), jnp.asarray(ah), jnp.asarray(asafe),
                  *(jnp.asarray(m) for m in (agg_w, train, recv, rejoin, ontime)))

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
        lambda_regs=[1e-3, 1e-3], robust=True, min_quorum=2)
    st = trees.stack([params, params])
    so = trees.map_leaves(_bump, trees.stack([opt.init(params)] * 2))
    pend = trees.map_with_path(lambda p, v: torch.from_numpy(pend_np[p]), st)
    before = {k: v.clone() for k, v in trees.flatten({"t": st, "o": so, "p": pend,
                                                      "g": params}).items()}
    out = rnd(st, so, params, pend, trees.stack(masks), torch.from_numpy(prompts),
              [jax_noise(k, GEN, B, cfg.vocab_size) for k in keys], ah, asafe,
              *(torch.from_numpy(m) for m in (agg_w, train, recv, rejoin, ontime)))
    voided = case == "rejoin_void"
    for i, (got, want) in enumerate(zip(out, jout)):
        if i == 2 and voided:
            continue
        if isinstance(got, dict):
            _assert_flat(bridge.to_numpy(got), _np(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    flat = trees.flatten({"t": out[0], "o": out[1], "p": out[3], "g": out[2]})
    for k, v in flat.items():
        old = before[k]
        if k.startswith("g/"):
            if voided:
                assert torch.equal(v, old), k
            continue
        for ci in range(2):
            if k.startswith("o/") and rejoin[ci]:
                assert not v[ci].any(), k
            elif not train[ci] and (k.startswith(("o/", "p/")) or not recv[ci] or voided):
                assert torch.equal(v[ci], old[ci]), k
    assert out[4][1] == 0 and out[5][1] == 0
    if voided:   # JAX's fused body moved its global: the reference's fault
        assert not all(np.array_equal(np.asarray(a), b) for a, b in
                       zip(_np(jout[2]).values(), _np(jp).values()))


def test_ppo_robust_all_ones_is_bitwise_sync(policy, reward_setup):  # noqa: F811
    """All-ones masks: the robust PPO body is bitwise the synchronous one
    (clients, optimizer, global, rewards, KLs) and ``pending`` bitwise the
    trained clients."""
    samples, (jh, js) = reward_setup
    model, params = _port(policy)
    cfg = policy["cfg"]
    rh, rs = _port_rm(jh), _port_rm(js)
    d = rewards.DoubleReward(rh, rh.params, rs, rs.params)
    opt = adamw(4e-4)
    masks = trees.stack([trees.map_leaves(
        lambda a, b: a * b, peft.last_k_layers_mask(params, cfg, 1),
        peft.head_sparsity_mask(params, cfg, 0.5, s, keep=np.array([s, 2]))) for s in (0, 1)])
    kw = dict(lambda_regs=[1e-3, 1e-3])
    q = lambda t, m, a, s: d.quality(t, m, rewards.ClientPreference(a, s))  # noqa: E731
    prompts = torch.from_numpy(np.stack([policy["prompts"], policy["prompts"][::-1]]))
    keys = [jax.random.fold_in(jax.random.PRNGKey(0), 17 + ci) for ci in range(2)]
    noises = [jax_noise(k, GEN, B, cfg.vocab_size) for k in keys]
    w, one = torch.tensor([1.0, 1.0]), torch.ones(2)
    sync = cohort.build_ppo_round(model, opt, ppo.PPOConfig(), PROMPT, GEN, q, **kw)(
        trees.stack([params, params]), trees.stack([opt.init(params)] * 2), params, masks,
        prompts, noises, [0.3, 0.6], [0.7, 0.4], w)
    rob = cohort.build_ppo_round(model, opt, ppo.PPOConfig(), PROMPT, GEN, q, robust=True,
                                 **kw)(
        trees.stack([params, params]), trees.stack([opt.init(params)] * 2), params,
        trees.map_leaves(torch.zeros_like, trees.stack([params, params])), masks, prompts,
        noises, [0.3, 0.6], [0.7, 0.4], w, one, one, torch.zeros(2), one)
    for a, b in zip(sync, rob[:3] + rob[4:]):
        fa = trees.flatten(a) if isinstance(a, dict) else {"": a}
        fb = trees.flatten(b) if isinstance(b, dict) else {"": b}
        for k, v in fa.items():
            assert torch.equal(v, fb[k]), k
