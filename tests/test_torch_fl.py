"""The port's federated path against the JAX package, on the CPU: the
numpy copies (data, channel) draw for draw, the tree helpers, the
aggregation operators, ``HostBatchStacker``, one synchronous round of the
cohort engine from identical stacked state (an all-outage round included),
and ``run_pftt`` for the four methods of Fig. 5 from a JAX-exported init.
Tolerances: 1e-5 on trainables (``tests/test_lora_factored.py``'s), exact
equality for every numpy draw and every byte and delay of the ledger."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro import trees as jtrees
from repro.comms.codec import ChannelBudget as JBudget
from repro.configs import get_config as jget_config
from repro.core import aggregation as jagg
from repro.core import cohort as jcohort
from repro.core import pftt as jpftt
from repro.data import partition as jpartition
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.models import Model as JModel
from repro.models import peft as jpeft
from repro.optim import adamw as jadamw
from repro.wireless import channel as jchannel
from repro.wireless import cost as jcost
from repro_torch import bridge, trees
from repro_torch.comms import ChannelBudget
from repro_torch.configs import get_config
from repro_torch.core import aggregation, cohort, pftt
from repro_torch.data import partition, pipeline, synthetic
from repro_torch.models import peft
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw, value_and_grad
from repro_torch.sharding import ClientMesh, cohort_sharding
from repro_torch.wireless import channel, cost

TOL = 1e-5


def _np(tree):
    return {k: np.asarray(v) for k, v in jtrees.flatten(tree).items()}


def _assert_trees(got_flat, want_flat, atol=TOL):
    assert got_flat.keys() == want_flat.keys()
    for k, v in want_flat.items():
        np.testing.assert_allclose(np.asarray(got_flat[k]), np.asarray(v), atol=atol, err_msg=k)


# --------------------------------------------------------------- numpy copies
def test_data_copies_draw_like_jax():
    assert synthetic.SPECIAL == jsynthetic.SPECIAL and synthetic.VOCAB == jsynthetic.VOCAB
    for kw in (dict(), dict(n_classes=8, skew=0.8, seq_len=24)):
        got = synthetic.ClassificationCorpus(**kw).sample(50, rng=np.random.RandomState(4))
        want = jsynthetic.ClassificationCorpus(**kw).sample(50, rng=np.random.RandomState(4))
        _assert_trees(got, want, atol=0)
    got = synthetic.InstructionCorpus().sample(20)
    want = jsynthetic.InstructionCorpus().sample(20)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    labels = np.random.RandomState(1).randint(0, 4, size=300)
    for a, b in zip(partition.dirichlet_partition(labels, 5, 0.3, seed=2),
                    jpartition.dirichlet_partition(labels, 5, 0.3, seed=2)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(partition.client_topic_preferences(3, 8, 0.5, seed=1),
                                  jpartition.client_topic_preferences(3, 8, 0.5, seed=1))
    arrays = {"x": np.arange(37), "y": np.arange(37) * 2, "n": 5}
    it, jit = pipeline.batch_iterator(arrays, 8, seed=3), jpipeline.batch_iterator(arrays, 8, seed=3)
    for _ in range(12):
        a, b = next(it), next(jit)
        assert a["n"] == b["n"]
        np.testing.assert_array_equal(a["x"], b["x"])


def test_channel_budget_and_ledger_match_jax():
    ch, jch = channel.RayleighChannel(seed=5), jchannel.RayleighChannel(seed=5)
    bud, jbud = ChannelBudget(ch, tx_power_w=0.3), JBudget(jch, tx_power_w=0.3)
    led, jled = cost.CommLedger(), jcost.CommLedger()
    for rnd in range(6):
        g, jg = ch.realize(4), jch.realize(4)
        np.testing.assert_array_equal(g, jg)
        np.testing.assert_array_equal(ch.outage_weights(g * 0.05), jch.outage_weights(jg * 0.05))
        bits = [1e4 * (i + 1) + 0.5 for i in range(4)]
        reps, jreps = bud.round_reports(bits, g * (0.05 if rnd == 3 else 1)), \
            jbud.round_reports(bits, jg * (0.05 if rnd == 3 else 1))
        assert [dataclasses.asdict(r) for r in reps] == [dataclasses.asdict(r) for r in jreps]
        led.log_round(reps, round_id=rnd)
        jled.log_round(jreps, round_id=rnd)
    assert dataclasses.asdict(ch.uplink(1234.0)) == dataclasses.asdict(jch.uplink(1234.0))
    assert led.rounds[3]["outages"] > 0
    np.testing.assert_equal(led.rounds, jled.rounds)
    for prop in ("total_bytes", "total_energy_j", "mean_round_bytes", "mean_round_delay",
                 "total_sim_time_s", "quorum_noops"):
        assert getattr(led, prop) == getattr(jled, prop), prop
    tree = {"a": np.zeros((3, 4), np.float32), "b": None,
            "c": {"d": np.zeros(5, np.int32), "m": np.ones((2, 1, 1), np.float32)}}
    assert cost.tree_bytes(trees.map_leaves(torch.from_numpy, tree)) == \
        jcost.tree_bytes(jax.tree_util.tree_map(jnp.asarray, tree)) == 76


# --------------------------------------------------------------- trees, aggregation
def _tree(rng, lead=()):
    return {"w": rng.randn(*lead, 3, 2).astype(np.float32),
            "stages": [{"layers": [{"a": rng.randn(*lead, 4).astype(np.float32),
                                    "b": None}]}],
            "head": rng.randn(*lead, 2).astype(np.float32)}


def test_tree_helpers_match_jax():
    rng = np.random.RandomState(0)
    clients = [_tree(rng) for _ in range(3)]
    t_clients = [trees.map_leaves(torch.from_numpy, c) for c in clients]
    j_clients = [jax.tree_util.tree_map(jnp.asarray, c) for c in clients]
    pred = lambda p: p.startswith(("stages", "head"))  # noqa: E731
    st, jst = trees.stack(t_clients), jtrees.stack(j_clients)
    _assert_trees(trees.flatten(st), _np(jst), atol=0)
    sel, jsel = trees.select(st, pred), jtrees.select(jst, pred)
    _assert_trees(trees.flatten(sel), _np(jsel), atol=0)
    over = trees.map_leaves(lambda x: x + 1, sel)
    _assert_trees(trees.flatten(trees.merge(st, over)),
                  _np(jtrees.merge(jst, jax.tree_util.tree_map(lambda x: x + 1, jsel))), atol=0)
    for a, b in zip(trees.unstack(st), jtrees.unstack(jst)):
        _assert_trees(trees.flatten(a), _np(b), atol=0)
    _assert_trees(trees.flatten(trees.tree_add(t_clients[0], t_clients[1], 0.5)),
                  _np(jtrees.tree_add(j_clients[0], j_clients[1], 0.5)))
    _assert_trees(trees.flatten(trees.tree_zeros_like(st)), _np(jtrees.tree_zeros_like(jst)), atol=0)


@pytest.mark.parametrize("weights", [None, [0.5, 0.0, 2.0, 1.0], [0.0, 0.0, 0.0, 0.0]])
def test_aggregation_ops_match_jax(weights):
    rng = np.random.RandomState(1)
    st = _tree(rng, lead=(4,))
    glob = _tree(rng)
    masks = {"w": (rng.rand(4, 3, 2) > 0.5).astype(np.float32),
             "stages": [{"layers": [{"a": (rng.rand(4, 4) > 0.5).astype(np.float32),
                                     "b": None}]}],
             "head": np.ones((4, 1), np.float32)}
    T = lambda t: trees.map_leaves(torch.from_numpy, t)  # noqa: E731
    J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    w_t = None if weights is None else torch.tensor(weights)
    w_j = None if weights is None else jnp.asarray(weights)
    np.testing.assert_allclose(aggregation._client_weights(4, w_t).numpy(),
                               np.asarray(jagg._client_weights(4, w_j)), atol=1e-7)
    _assert_trees(trees.flatten(aggregation.fedavg_stacked(T(st), w_t)),
                  _np(jagg.fedavg_stacked(J(st), w_j)))
    pred = lambda p: p.startswith("stages")  # noqa: E731
    _assert_trees(trees.flatten(aggregation.partial_fedavg_stacked(T(glob), T(st), pred, w_t)),
                  _np(jagg.partial_fedavg_stacked(J(glob), J(st), pred, w_j)))
    _assert_trees(trees.flatten(aggregation.masked_fedavg_stacked(T(glob), T(st), T(masks), w_t)),
                  _np(jagg.masked_fedavg_stacked(J(glob), J(st), J(masks), w_j)))
    gate = None if weights is None else bool(np.sum(weights) > 0)
    for m in (None, masks):
        _assert_trees(
            trees.flatten(aggregation.broadcast_merge_stacked(
                T(st), T(glob), None if m is None else T(m), gate=gate)),
            _np(jagg.broadcast_merge_stacked(J(st), J(glob), None if m is None else J(m),
                                             gate=gate)), atol=0)
    _assert_trees(trees.flatten(aggregation.fedavg([T(_tree(np.random.RandomState(i)))
                                                    for i in range(3)])),
                  _np(jagg.fedavg([J(_tree(np.random.RandomState(i))) for i in range(3)])))


def test_host_batch_stacker_matches_jax():
    """Uniform and ragged cohorts (the ``valid`` leaf), round over round.
    The JAX stacker reuses its buffer, so after a wider round its padding
    stays at the wider width and keeps the earlier round's rows; the port
    pads each round to its own width with zeros.  Both must agree on every
    real row and on ``valid``, and every padded row must be invalid."""
    rng = np.random.RandomState(2)

    def round_batches(sizes):
        return [[{"tokens": rng.randint(0, 9, size=(n, 5)).astype(np.int32),
                  "label": rng.randint(0, 4, size=n).astype(np.int32)} for _ in range(3)]
                for n in sizes]

    st, jst = cohort.HostBatchStacker("cpu"), jcohort.HostBatchStacker()
    for sizes in ((4, 4), (4, 4), (4, 2, 3), (3, 1, 2)):
        b = round_batches(sizes)
        got, want = st(b), jst(b)
        assert set(got) == set(want) == ({"tokens", "label"} | ({"valid"} if len(set(sizes)) > 1
                                                                 else set()))
        width = max(sizes)
        for k in ("tokens", "label"):
            assert got[k].shape[:3] == (len(sizes), 3, width)
            for ci, n in enumerate(sizes):
                np.testing.assert_array_equal(got[k].numpy()[ci, :, :n],
                                              np.asarray(want[k])[ci, :, :n], err_msg=k)
                np.testing.assert_array_equal(got[k].numpy()[ci, :, n:], 0, err_msg=k)
        if "valid" in want:
            wv = np.asarray(want["valid"])
            np.testing.assert_array_equal(got["valid"].numpy(), wv[..., :width])
            np.testing.assert_array_equal(wv[..., width:], 0)


# --------------------------------------------------------------- one round
@pytest.fixture(scope="module")
def round_setup():
    """A reduced RoBERTa (d 64) with adapters; three clients' PFTT
    trainables (adapters + cls_head shared, distinct LoRA with nonzero B
    local); two local steps of ragged batches (sizes 6, 6, 3)."""
    jcfg = jget_config("roberta-base").reduced(d_model=64, repeats=2)
    key = jax.random.PRNGKey(0)
    pc = jpeft.PEFTConfig(lora_rank=4, adapter_dim=8, lora_targets=("mixer/wq", "mixer/wv"))
    jparams = jpeft.init_adapters(key, JModel(jcfg).init(key), jcfg, pc)
    rng = np.random.RandomState(5)
    jparams = jtrees.map_with_path(
        lambda p, v: jnp.asarray(rng.randn(*v.shape) * 0.1, jnp.float32)
        if p.endswith("adapter/wu") else v, jparams)
    loras = []
    for ci in range(3):
        lo = jpeft.init_lora(jax.random.fold_in(key, 100 + ci), jparams, pc)
        loras.append(jtrees.map_with_path(
            lambda p, v: jnp.asarray(rng.randn(*v.shape) * 0.1, jnp.float32)
            if p.endswith("/b") else v, lo))
    batches = [[{"tokens": rng.randint(6, 512, size=(n, 16)).astype(np.int32),
                 "label": rng.randint(0, 4, size=n).astype(np.int32)} for _ in range(2)]
               for n in (6, 6, 3)]
    return jcfg, pc, jparams, loras, batches


def _jax_round(jcfg, pc, jparams):
    jmodel, opt = JModel(jcfg), jadamw(1e-2, update_mask=lambda p: not p.endswith("/mask"))
    scale = jpeft.lora_scale(pc)

    def local_step(t, o, batch):
        def loss_fn(t):
            full, lora = jpftt._split_trainable("pftt", jparams, t)
            return jmodel.cls_loss(full, batch, lora=lora, lora_scale=scale)[0]
        loss, g = jax.value_and_grad(loss_fn)(t)
        upd, o = opt.update(g, o, t)
        return jtrees.tree_add(t, upd), o, loss

    return jcohort.build_supervised_round(local_step, jpftt._upload_pred("pftt")), opt


@pytest.mark.parametrize("weights", [[1.0, 1.0, 1.0], [1.0, 0.0, 1.0], [0.0, 0.0, 0.0]])
def test_supervised_round_matches_jax(round_setup, weights):
    """One synchronous round (local steps, weighted mean of the uploaded
    subtree, broadcast; all-outage keeps local values) from identical
    stacked state, batches and outage weights, against the JAX engine."""
    jcfg, pc, jparams, loras, batches = round_setup
    jround, jopt = _jax_round(jcfg, pc, jparams)
    jts = [jpftt._build_trainable("pftt", jparams, lo) for lo in loras]
    jst, jso = jtrees.stack(jts), jtrees.stack([jopt.init(t) for t in jts])
    jst, jso, jlosses = jround(jst, jso, jcohort.HostBatchStacker()(batches),
                               jnp.asarray(weights, jnp.float32))

    cfg = get_config("roberta-base").reduced(d_model=64, repeats=2)
    model = Model(cfg, device="cpu")
    params = bridge.params_from_numpy(_np(jparams), cfg)
    opt = adamw(1e-2, update_mask=lambda p: not p.endswith("/mask"))
    scale = peft.lora_scale(peft.PEFTConfig(lora_rank=4))

    def local_step(t, o, batch):
        def loss_fn(t):
            full, lora = pftt._split_trainable("pftt", params, t)
            return model.cls_loss(full, batch, lora=lora, lora_scale=scale)[0]
        loss, g = value_and_grad(loss_fn, t)
        upd, o = opt.update(g, o, t)
        return trees.tree_add(t, upd), o, loss

    rnd = cohort.build_supervised_round(local_step, pftt._upload_pred("pftt"))
    ts = [pftt._build_trainable("pftt", params, bridge.lora_from_numpy(_np(lo), cfg))
          for lo in loras]
    st, so = trees.stack(ts), trees.stack([opt.init(t) for t in ts])
    st, so, losses = rnd(st, so, cohort.HostBatchStacker("cpu")(batches),
                         torch.tensor(weights))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), atol=TOL)
    _assert_trees(bridge.to_numpy(st), _np(jst))
    _assert_trees(bridge.to_numpy(so), _np(jso))
    head = bridge.to_numpy(st)["shared/cls_head"]
    if sum(weights) > 0:   # the aggregate is broadcast into every slot
        np.testing.assert_array_equal(head[0], head[2])
    else:                  # all outage: every client keeps its own
        assert np.abs(head[0] - head[2]).max() > 0


@pytest.mark.parametrize("method", pftt.METHODS)
def test_factored_trainable_matches_merged_oracle(round_setup, method):
    """Each method's factored execution (``_split_trainable``: LoRA through
    ``lora_proj``) against the merged oracle ``_merge_trainable`` and
    against JAX's merged oracle: the classification loss, ≤ 1e-5."""
    jcfg, pc, jparams, loras, batches = round_setup
    lo = loras[0] if method != "fedbert" else None
    jt = jpftt._build_trainable(method, jparams, lo)
    batch = batches[0][0]
    want = float(JModel(jcfg).cls_loss(jpftt._merge_trainable(method, jparams, jt, pc),
                                       {k: jnp.asarray(v) for k, v in batch.items()})[0])
    cfg = get_config("roberta-base").reduced(d_model=64, repeats=2)
    model = Model(cfg, device="cpu")
    params = bridge.params_from_numpy(_np(jparams), cfg)
    t = pftt._build_trainable(method, params, None if lo is None
                              else bridge.lora_from_numpy(_np(lo), cfg))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tpc = peft.PEFTConfig(lora_rank=4, adapter_dim=8, lora_targets=("mixer/wq", "mixer/wv"))
    full, lora = pftt._split_trainable(method, params, t)
    factored = float(model.cls_loss(full, tb, lora=lora, lora_scale=peft.lora_scale(tpc))[0])
    merged = float(model.cls_loss(pftt._merge_trainable(method, params, t, tpc), tb)[0])
    assert (lora is None) == (method == "fedbert")
    np.testing.assert_allclose([factored, merged], [want, want], atol=TOL)


def test_cohort_eval_and_unported_options(tmp_path):
    st = {"x": torch.arange(6.0).reshape(3, 2)}
    ev = cohort.build_cohort_eval(lambda t, d: (t["x"].sum() * d.sum(), d.sum()))
    a, b = ev(st, torch.ones(3, 4))
    np.testing.assert_array_equal(a.numpy(), [4.0, 20.0, 36.0])
    assert b.shape == (3,)
    # the codec, factored aggregation and health build (they are ported);
    # a sharded round over a mesh whose process group is not initialised
    # raises (no fallback to world size 1), and so does anything but a
    # ClientMesh
    for opt in ({"codec": object()}, {"robust": True, "codec": object()},
                {"factored_agg": True}, {"codec": object(), "health": True},
                {"health": True}, {"robust": True, "health": True}):
        assert callable(cohort.build_supervised_round(lambda *a: a, **opt))
    mesh = ClientMesh(("data",), (1,))
    for opt, m, err, match in (({"robust": True, "codec": object()}, mesh,
                                RuntimeError, "not initialised"),
                               ({"health": True}, mesh, RuntimeError, "not initialised"),
                               ({}, object(), TypeError, "ClientMesh"),
                               ({"factored_agg": True}, mesh, RuntimeError,
                                "not initialised")):
        with pytest.raises(err, match=match):
            cohort.build_supervised_round(lambda *a: a, cs=cohort_sharding(m, 2), **opt)
    # the legacy loop runs (with ``ckpt_dir`` it writes nothing, as JAX's
    # loop); population mode raises the JAX package's own errors before any
    # work
    from repro_torch.fl import PopulationConfig
    from repro_torch.wireless.scenarios import Scenario
    for kw in (dict(engine=False), dict(ckpt_dir=str(tmp_path), factored_agg=True, engine=False)):
        res = pftt.run_pftt(pftt.PFTTConfig(device="cpu", **dict(PFTT_KW, rounds=1), **kw))
        assert res["fused_engine"] is False and np.isfinite(res["final_acc"])
    assert list(tmp_path.iterdir()) == []
    pop = PopulationConfig(population=8, cohort_size=2)
    for kw, err, match in ((dict(population=pop, engine=False), ValueError, "engine"),
                           (dict(population=PopulationConfig(
                               population=8, cohort_size=2, scenario=Scenario(n_classes=8))),
                            ValueError, "4-class")):
        with pytest.raises(err, match=match):
            pftt.run_pftt(pftt.PFTTConfig(device="cpu", **kw))


# --------------------------------------------------------------- run_pftt
PFTT_KW = dict(d_model=64, n_clients=3, rounds=2, local_steps=2, pretrain_steps=3,
               samples_per_client=40, batch=32)


def _export_init(cfg):
    """The JAX package's draws for ``run_pftt``: the base before pretraining,
    the adapter leaves, each client's initial LoRA (``_setup_backbone`` and
    ``run_pftt``'s keys)."""
    key = jax.random.PRNGKey(cfg.seed)
    mcfg = jget_config("roberta-base").reduced(d_model=cfg.d_model, repeats=2)
    base = JModel(mcfg).init(key)
    pc = jpeft.PEFTConfig(lora_rank=cfg.lora_rank, adapter_dim=cfg.adapter_dim,
                          lora_targets=("mixer/wq", "mixer/wv"))
    with_ad = jpeft.init_adapters(key, base, mcfg, pc)
    params = with_ad if cfg.method in ("pftt", "vanilla_fl") else base
    return {"base": _np(base),
            "adapters": {k: v for k, v in _np(with_ad).items() if "/adapter/" in k},
            "lora": [_np(jpeft.init_lora(jax.random.fold_in(key, 100 + ci), params, pc))
                     for ci in range(cfg.n_clients)]}


@pytest.mark.parametrize("method", pftt.METHODS)
def test_run_pftt_matches_jax(method):
    """``run_pftt`` from the JAX-exported init, with a ragged cohort (batch
    32 over about 32 training samples per client): per-round bytes and
    delays exactly equal, accuracies to 1e-6 (each is a count of correct
    predictions over the client's test set: one flipped prediction would
    move it by at least 1/40)."""
    want = jpftt.run_pftt(jpftt.PFTTConfig(method=method, **PFTT_KW))
    got = pftt.run_pftt(pftt.PFTTConfig(method=method, device="cpu", **PFTT_KW),
                        init=_export_init(jpftt.PFTTConfig(method=method, **PFTT_KW)))
    assert got["ragged_cohort"] and want["ragged_cohort"]
    assert [r["bytes"] for r in got["round_records"]] == [r["bytes"] for r in want["round_records"]]
    assert [r["delay_s"] for r in got["round_records"]] == \
        [r["delay_s"] for r in want["round_records"]]
    np.testing.assert_allclose(got["acc_per_round"], want["acc_per_round"], atol=1e-6)
    for k in ("mean_round_bytes", "mean_round_delay_s", "total_bytes", "total_energy_j",
              "quorum_noops", "uplink_codec", "fused_engine"):
        assert got[k] == want[k], k
    assert set(want) <= set(got)
