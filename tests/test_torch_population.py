"""The port's population mode (``repro_torch.fl``, ``wireless/scenarios.py``,
``core/async_agg.FairSelector``) against the JAX package, on the CPU, at
``tests/test_population.py``'s small settings (population 16, cohort 4,
d 32, rank 2, 3 rounds):

* the copies draw for draw: scenarios (prefix-stable in the horizon),
  samplers (mid-stream resume), ``PopulationData``, ``FairSelector``; the
  store's semantics against the original's; the runner's host-to-device
  step a copy;
* ``run_pftt`` in population mode from JAX's exported init (every client's
  ``fold_in(key, 100 + i)`` LoRA): cohort ids, bytes and delays equal,
  accuracies within 1e-6, each round's health within 1e-5; under int8 with
  JAX's uniforms keyed by client id, bits within ``FLIP_RTOL``;
* the port's kill and resume: the canonical event streams byte for byte;
* shepherd population, 1 round: evaluation loss within 1e-3, ledger equal;
  the PPO methods raise JAX's ``ValueError``;
* the launcher's population and telemetry flags, ``report --check``, and
  the legacy ``FLServer``/``run_rounds`` loop against ``repro.fl``'s:
  each round's w within 1e-6, ledger records equal."""
import dataclasses
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_comms_runs import FLIP_RTOL, _close_records, jax_codec_noise
from test_torch_fl import _export_init, _np

from repro import fl as jfl
from repro import obs as jobs
from repro import optim as joptim
from repro import trees as jtrees
from repro.configs import get_config as jget_config
from repro.core import async_agg as jasync
from repro.core import pfit as jpfit
from repro.core import pftt as jpftt
from repro.fl import population as jpop
from repro.models import Model as JModel
from repro.models import peft as jpeft
from repro.wireless import RayleighChannel as JRayleigh
from repro.wireless import faults as jfaults
from repro.wireless import scenarios as jscen
from repro_torch import fl, obs, optim, trees
from repro_torch.core import async_agg, pfit, pftt
from repro_torch.fl import (ClientSampler, PopulationConfig, PopulationData,
                            PopulationRunner, PopulationStore, stacked_client_init)
from repro_torch.launch import report, train
from repro_torch.wireless import FaultPlan, RayleighChannel
from repro_torch.wireless.scenarios import Scenario

ACC_TOL = 1e-6
HEALTH_TOL = 1e-5
SHEPHERD_TOL = 1e-3


# --------------------------------------------------------------- scenarios
SCENARIOS = {
    "inert": {},
    "dirichlet": dict(alpha=0.1, seed=3),
    "diurnal": dict(avail="diurnal", avail_period=6, seed=1),
    "periodic": dict(avail="periodic", avail_period=4, avail_duty=0.25, seed=2),
    "waypoint": dict(mobility="waypoint", speed_mps=5.0, seed=4),
    "all": dict(alpha=0.3, n_classes=8, avail="diurnal", mobility="waypoint", seed=5),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_copy_draws_like_jax(name):
    """Every array of the trace equal, prefix-stable in the horizon, the
    clamp past it and the spec round-trip the original's."""
    mine, ref = Scenario(**SCENARIOS[name]), jscen.Scenario(**SCENARIOS[name])
    tr, jtr = mine.realize(12, 7), ref.realize(12, 7)
    for f in ("class_probs", "avail_p", "avail", "gain_scale"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jtr, f), err_msg=f)
    short = mine.realize(12, 3)
    for f in ("avail_p", "avail", "gain_scale"):
        np.testing.assert_array_equal(getattr(short, f), getattr(tr, f)[:3], err_msg=f)
    for r in (2, 9):
        np.testing.assert_array_equal(short.avail_probs(r), jtr.avail_probs(r) if r < 3
                                      else np.ones(12))
        np.testing.assert_array_equal(short.gain_round(r), ref.realize(12, 3).gain_round(r))
    assert mine.to_dict() == ref.to_dict()
    assert Scenario.from_dict(mine.to_dict()) == mine
    assert mine.is_inert() == ref.is_inert() and mine.has_availability() == ref.has_availability()


def test_scenario_specs_parse_and_refuse_like_jax(tmp_path):
    spec = "alpha=0.1,avail=diurnal,avail_period=8,mobility=waypoint,seed=3"
    assert Scenario.from_spec(spec).to_dict() == jscen.Scenario.from_spec(spec).to_dict()
    path = tmp_path / "s.json"
    path.write_text(json.dumps(Scenario.from_spec(spec).to_dict()))
    assert Scenario.from_spec(str(path)) == Scenario.from_spec(spec)
    assert Scenario.from_spec("none") is None and Scenario.from_spec(None) is None
    for bad in ("alpha=0.1,warp=9", "alpha"):
        with pytest.raises(ValueError):
            Scenario.from_spec(bad)
        with pytest.raises(ValueError):
            jscen.Scenario.from_spec(bad)
    with pytest.raises(ValueError):
        Scenario(avail="sometimes")


# --------------------------------------------------------------- samplers
@pytest.mark.parametrize("kind", ["uniform", "availability"])
def test_sampler_copy_draws_like_jax_and_resumes_mid_stream(kind):
    p = np.linspace(0.05, 1.0, 40)
    mine, ref = ClientSampler(kind, 40, 6, seed=7), jpop.ClientSampler(kind, 40, 6, seed=7)
    seq = [mine.sample(p) for _ in range(6)]
    for ids in seq:
        np.testing.assert_array_equal(ids, ref.sample(p))
        assert len(np.unique(ids)) == 6 and np.all(np.diff(ids) > 0)
    snap = json.loads(json.dumps(mine.state_dict()))
    assert snap == json.loads(json.dumps(ref.state_dict()))
    later = [mine.sample(p) for _ in range(4)]
    resumed = ClientSampler(kind, 40, 6, seed=99)
    resumed.load_state_dict(snap)
    for ids in later:
        np.testing.assert_array_equal(resumed.sample(p), ids)
    with pytest.raises(ValueError):
        ClientSampler("roundrobin", 10, 2)


POP_CONFIGS = [
    dict(population=4, cohort_size=8), dict(population=10, cohort_size=0),
    dict(population=10, cohort_size=2, sampler="magic"),
    dict(population=10, cohort_size=2, sampler="availability"),
    dict(population=10, cohort_size=2, sampler="availability", scenario="inert"),
    dict(population=10, cohort_size=2, sampler="availability", scenario="diurnal"),
]


@pytest.mark.parametrize("kw", POP_CONFIGS, ids=range(len(POP_CONFIGS)))
def test_population_config_validates_like_jax(kw):
    def make(cls, scen):
        args = dict(kw)
        if "scenario" in args:
            args["scenario"] = scen(**SCENARIOS[args["scenario"]])
        return cls(**args)

    try:
        want = make(jpop.PopulationConfig, jscen.Scenario)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            make(PopulationConfig, Scenario)
    else:
        got = make(PopulationConfig, Scenario)
        assert (got.population, got.cohort_size, got.sampler) == \
            (want.population, want.cohort_size, want.sampler)


# --------------------------------------------------------------- store
def _toy(n, seed=0):
    r = np.random.RandomState(seed)
    return {"a": {"w": r.randn(n, 3, 4).astype(np.float32), "skip": None},
            "b": r.randn(n, 5).astype(np.float32), "step": np.arange(n, dtype=np.int32)}


def test_store_semantics_match_jax():
    """gather (a reused staging buffer), scatter from tensors (a copy, the
    unsampled rows untouched), zero_rows, row, nbytes and the checkpoint
    round-trip, against the original store on the same arrays."""
    tree = _toy(10)
    store = PopulationStore({"trainable": tree})
    jstore = jpop.PopulationStore({"trainable": {k: v for k, v in _toy(10).items()}})
    ids = np.array([1, 4, 7])
    got = store.gather("trainable", ids)
    want = jstore.gather("trainable", ids)
    for k, v in trees.flatten(want).items():
        np.testing.assert_array_equal(trees.flatten(got)[k], v, err_msg=k)
    assert got["a"]["skip"] is None
    again = store.gather("trainable", np.array([0, 2, 3]))
    assert again["b"] is got["b"]                       # refilled in place
    np.testing.assert_array_equal(again["b"], tree["b"][[0, 2, 3]])
    new = trees.map_leaves(lambda a: torch.from_numpy(a * 0 + 7), store.gather("trainable", ids))
    before = trees.map_leaves(np.copy, store.slots["trainable"])
    store.scatter("trainable", ids, new)
    jstore.scatter("trainable", ids, trees.map_leaves(lambda t: jnp.asarray(t.numpy()), new))
    new["b"].add_(1.0)                                  # no view kept
    for k, v in trees.flatten(store.slots["trainable"]).items():
        np.testing.assert_array_equal(v, trees.flatten(jstore.slots["trainable"])[k], err_msg=k)
        keep = np.setdiff1d(np.arange(10), ids)
        np.testing.assert_array_equal(v[keep], trees.flatten(before)[k][keep], err_msg=k)
        assert (v[ids] == 7).all(), k
    store.zero_rows("trainable", [2, 5])
    jstore.zero_rows("trainable", [2, 5])
    np.testing.assert_array_equal(store.row("trainable", 5)["b"], jstore.row("trainable", 5)["b"])
    assert store.nbytes() == jstore.nbytes() and store.n_clients == 10
    ck = trees.map_leaves(np.copy, store.checkpoint_tree())
    store.zero_rows("trainable", list(range(10)))
    store.load_checkpoint_tree(ck)
    np.testing.assert_array_equal(store.slots["trainable"]["b"], jstore.slots["trainable"]["b"])


def test_runner_copies_to_the_device_on_the_cpu_too():
    """``torch.from_numpy`` alone would share the staging buffer on the CPU:
    the runner's host-to-device step copies, so a body that writes its
    inputs in place leaves the buffer (and the store) as they were."""
    store = PopulationStore({"trainable": _toy(6)})
    buf = store.gather("trainable", np.array([0, 3]))
    dev = PopulationRunner._put(types.SimpleNamespace(device=torch.device("cpu")), buf)
    dev["b"].mul_(0.0)
    assert not np.shares_memory(buf["b"], dev["b"].numpy()) and buf["b"].any()
    np.testing.assert_array_equal(buf["b"], store.slots["trainable"]["b"][[0, 3]])


def test_population_data_and_fair_selector_copies_draw_like_jax():
    r = np.random.RandomState(0)
    pool = {"tokens": r.randint(0, 50, size=(64, 8)), "label": np.arange(64) % 4,
            "prompt_len": 3}
    probs = jscen.Scenario(alpha=0.2, seed=1).realize(5, 1).class_probs
    mine, ref = PopulationData(pool, probs, seed=2), jpop.PopulationData(pool, probs, seed=2)
    for cid, rnd in ((0, 0), (3, 2), (4, 7)):
        for a, b in zip(mine.round_batches(cid, rnd, 2, 6), ref.round_batches(cid, rnd, 2, 6)):
            assert a.keys() == b.keys() and a["prompt_len"] == 3
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(mine.test_set(cid, 5)["label"],
                                      ref.test_set(cid, 5)["label"])
    sel, jsel = async_agg.FairSelector(8), jasync.FairSelector(8)
    for t in range(6):
        rates = np.random.RandomState(t).rand(8)
        assert sel.select(rates, 3) == jsel.select(rates, 3)
    np.testing.assert_array_equal(sel._avg, jsel._avg)


def test_stacked_client_init_stacks_each_clients_draw():
    out = stacked_client_init(lambda i: {"w": torch.full((2,), float(i)), "n": None,
                                         "s": np.int32(i)}, 3)
    np.testing.assert_array_equal(out["w"], [[0, 0], [1, 1], [2, 2]])
    assert out["n"] is None and out["s"].tolist() == [0, 1, 2]


# --------------------------------------------------------------- run_pftt
POP_KW = dict(rounds=3, local_steps=2, batch=4, pretrain_steps=10, samples_per_client=32,
              test_samples=8, d_model=32, lora_rank=2, adapter_dim=4, seed=0, verbose=False)
SCEN = dict(alpha=0.1, avail="diurnal", avail_period=6, mobility="waypoint", seed=1)
STRAGGLE = dict(straggle_p=0.3, max_straggle=2, seed=2)


def _configs(method="pftt", rounds=3, **kw):
    jcfg = jpftt.PFTTConfig(method=method, population=jpop.PopulationConfig(
        population=16, cohort_size=4, sampler="availability",
        scenario=jscen.Scenario(**SCEN)), fault_plan=jfaults.FaultPlan(**STRAGGLE),
        staleness_a=0.5, max_staleness=2, **dict(POP_KW, rounds=rounds, **kw))
    cfg = pftt.PFTTConfig(method=method, population=PopulationConfig(
        population=16, cohort_size=4, sampler="availability", scenario=Scenario(**SCEN)),
        fault_plan=FaultPlan(**STRAGGLE), staleness_a=0.5, max_staleness=2, device="cpu",
        **dict(POP_KW, rounds=rounds, **kw))
    init = _export_init(dataclasses.replace(jcfg, n_clients=16))
    return jcfg, cfg, init


def _jax_rounds(tmp_path, jcfg):
    """JAX's run with telemetry: the result and its round events."""
    want = jpftt.run_pftt(dataclasses.replace(jcfg, telemetry=jobs.TelemetryConfig(
        out_dir=str(tmp_path / "jax"))))
    return want, [e for e in jobs.read_events(str(tmp_path / "jax" / "events.jsonl"))
                  if e["event"] == "round"]


def test_run_pftt_population_matches_jax(tmp_path):
    """pftt under availability sampling, a Dirichlet/diurnal/waypoint
    scenario and stragglers: each round's cohort, bytes and delay equal,
    accuracies within 1e-6, health within 1e-5, participation, store size
    and the result's keys the JAX package's."""
    jcfg, cfg, init = _configs()
    want, jrounds = _jax_rounds(tmp_path, jcfg)
    got = pftt.run_pftt(dataclasses.replace(cfg, telemetry=obs.TelemetryConfig(
        out_dir=str(tmp_path / "port"))), init=init)
    assert got["cohorts"] == [e["cohort"] for e in jrounds]
    np.testing.assert_equal([(r["bytes"], r["delay_s"]) for r in got["round_records"]],
                            [(r["bytes"], r["delay_s"]) for r in want["round_records"]])
    np.testing.assert_allclose(got["acc_per_round"], want["acc_per_round"], atol=ACC_TOL)
    for h, e in zip(got["health_per_round"], jrounds):
        for k in obs.HEALTH_KEYS:
            assert h[k] == pytest.approx(e["health"][k], abs=HEALTH_TOL, rel=HEALTH_TOL), k
    assert got["staleness"] == jrounds[-1]["staleness"]
    for k in ("participation_frac", "store_bytes", "total_bytes", "scenario", "population",
              "cohort_size", "sampler", "fused_engine"):
        assert got[k] == want[k], k
    assert set(want) <= set(got)


def test_run_pftt_population_codec_keys_by_client_id(tmp_path):
    """fedlora under int8 with JAX's uniforms, keyed (round, client id) as
    the JAX runner keys them: ledgers within FLIP_RTOL, cohorts equal,
    accuracies within 1e-6."""
    jcfg, cfg, init = _configs("fedlora", rounds=2, uplink_codec="int8")
    init["codec_noise"] = jax_codec_noise(jcfg.seed)
    want, jrounds = _jax_rounds(tmp_path, jcfg)
    got = pftt.run_pftt(cfg, init=init)
    assert got["cohorts"] == [e["cohort"] for e in jrounds]
    _close_records([{k: v for k, v in r.items() if k != "per_client"}
                    for r in got["round_records"]],
                   [{k: v for k, v in r.items() if k != "per_client"}
                    for r in want["round_records"]], FLIP_RTOL)
    np.testing.assert_allclose(got["acc_per_round"], want["acc_per_round"], atol=ACC_TOL)


def test_population_kill_resume_event_stream_is_byte_exact(tmp_path):
    """Killed after 2 of 4 rounds and resumed (one npz: store, global,
    sampler, tracker, flags): the canonical stream byte for byte the
    uninterrupted run's, one resume event, no round twice, the result the
    same."""
    _, cfg, _ = _configs(rounds=4)

    def run(tag, **kw):
        return pftt.run_pftt(dataclasses.replace(cfg, telemetry=obs.TelemetryConfig(
            out_dir=str(tmp_path / tag)), **kw))

    full = run("full")
    run("killed", rounds=2, ckpt_dir=str(tmp_path / "ck"))
    resumed = run("killed", ckpt_dir=str(tmp_path / "ck"), resume=True)
    ev_full = obs.read_events(str(tmp_path / "full" / "events.jsonl"))
    ev_res = obs.read_events(str(tmp_path / "killed" / "events.jsonl"))
    assert obs.validate_events(ev_full) == obs.validate_events(ev_res) == []
    assert [e["event"] for e in ev_res].count("resume") == 1
    assert obs.canonical_stream(ev_res) == obs.canonical_stream(ev_full)
    assert len(obs.canonical_stream(ev_full)) == 4
    for k in ("acc_per_round", "cohorts", "staleness", "health_per_round", "total_bytes"):
        assert resumed[k] == full[k], k
    meta = json.load(open(tmp_path / "ck" / "pftt_pop_pftt.json"))
    assert meta["next_round"] == 4 and "sampler" in meta["runner"]


# --------------------------------------------------------------- shepherd
SHEP_KW = dict(rounds=1, rollout_batch=4, pretrain_steps=15, d_model=48, n_layers=2,
               gen_len=8, prompt_len=6, seed=0, method="shepherd", shepherd_steps=2)


def test_shepherd_population_matches_jax(tmp_path):
    """One round of shepherd's population mode (population 8, cohort 2)
    from JAX's policy and per-client LoRA: the evaluation LM loss within
    1e-3, the ledger equal, health and the stream present."""
    n = 8
    key = jax.random.PRNGKey(0)
    mcfg = jget_config("gpt2-small").reduced(d_model=48, repeats=2)
    params = JModel(mcfg).init(key)
    pc = jpeft.PEFTConfig(lora_rank=8, lora_targets=("mixer/wq", "mixer/wv"))
    init = {"policy": _np(params),
            "lora": [_np(jpeft.init_lora(jax.random.fold_in(key, 200 + i), params, pc))
                     for i in range(n)]}
    want = jpfit.run_pfit(jpfit.PFITConfig(population=jpop.PopulationConfig(
        population=n, cohort_size=2), **SHEP_KW))
    got = pfit.run_pfit(pfit.PFITConfig(
        population=PopulationConfig(population=n, cohort_size=2), device="cpu",
        telemetry=obs.TelemetryConfig(out_dir=str(tmp_path)), **SHEP_KW), init=init)
    np.testing.assert_allclose(got["eval_loss_per_round"], want["eval_loss_per_round"],
                               atol=SHEPHERD_TOL)
    assert got["total_bytes"] == want["total_bytes"]
    assert got["mean_round_delay_s"] == want["mean_round_delay_s"]
    assert set(got["health_per_round"][0]) == set(obs.HEALTH_KEYS)
    assert report.main([str(tmp_path), "--check"]) == 0
    assert set(want) <= set(got)


@pytest.mark.parametrize("method", ["pfit", "sfl", "pfl"])
def test_population_refuses_ppo_methods_as_jax_does(method):
    kw = dict(population=PopulationConfig(population=8, cohort_size=2), method=method)
    with pytest.raises(ValueError, match="shepherd"):
        pfit.run_pfit(pfit.PFITConfig(device="cpu", **kw))
    with pytest.raises(ValueError, match="shepherd"):
        jpfit.run_pfit(jpfit.PFITConfig(method=method, population=jpop.PopulationConfig(
            population=8, cohort_size=2)))


# --------------------------------------------------------------- launcher
def test_launcher_population_and_telemetry_flags(tmp_path, monkeypatch, capsys):
    """The JAX launcher's flags and defaults; a population run with
    telemetry on the CPU (its pretraining cut to 2 steps, d 32), then
    ``report --check``; ``--population`` refuses another arch."""
    argv = ["--arch", "roberta-base", "--population", "16", "--sampler", "availability",
            "--scenario", "avail=diurnal,avail_period=6,seed=1", "--fl-rounds", "2",
            "--telemetry-dir", str(tmp_path), "--trace", "--device", "cpu"]
    args = train.parse_args(argv)
    assert (args.cohort, args.torch_profile) == (8, False)
    cfg = train.pftt_config(args)
    assert cfg.population == PopulationConfig(
        population=16, cohort_size=8, sampler="availability",
        scenario=Scenario(avail="diurnal", avail_period=6, seed=1))
    assert cfg.n_clients == 8 and cfg.telemetry == obs.TelemetryConfig(
        out_dir=str(tmp_path), trace=True, torch_profile=False)
    assert train.pftt_config(train.parse_args(argv[:2] + ["--device", "cpu"])).population \
        is None
    monkeypatch.setattr(pftt, "PFTTConfig", functools.partial(
        pftt.PFTTConfig, pretrain_steps=2, d_model=32, lora_rank=2, adapter_dim=4,
        samples_per_client=16))
    res = train.main(argv + ["--cohort", "4", "--batch", "4"])
    assert len(res["acc_per_round"]) == 2 and res["population"] == 16
    assert "population: sampled" in capsys.readouterr().out
    assert report.main([str(tmp_path), "--check"]) == 0
    assert (tmp_path / "trace.json").exists()
    with pytest.raises(SystemExit, match="roberta-base"):
        train.parse_args(["--arch", "gpt2-small", "--population", "8"])


# --------------------------------------------------------------- legacy loop
def _legacy_run(fl, optim, tree_add, make_tensor, grad, channel):
    """``tests/test_system.py``'s case (two clients on quadratic targets,
    SGD 0.2, 20 rounds of 2 local steps) through one package's FLClient,
    FLServer and run_rounds: both clients' w after each round, and the
    server's ledger."""
    opt = optim.sgd(0.2)
    zero = make_tensor([0.0])

    def make_step(tgt):
        def step(trainable, opt_state, batch):
            upd, opt_state = opt.update(grad(trainable, tgt), opt_state, trainable)
            return tree_add(trainable, upd), opt_state, 0.0
        return step

    clients = [fl.FLClient(cid=i, trainable={"w": zero}, opt_state=opt.init({"w": zero}),
                           data_iter=iter(lambda: None, 1),
                           step_fn=make_step(make_tensor([t])))
               for i, t in enumerate((1.0, 3.0))]
    server = fl.FLServer(channel=channel)
    hist = fl.run_rounds(server, clients, rounds=20, local_steps=2,
                         eval_fn=lambda cs: [float(c.trainable["w"][0]) for c in cs])
    return np.asarray(hist), server.ledger.rounds


@pytest.mark.parametrize("with_channel", [False, True], ids=["no-channel", "rayleigh"])
def test_generic_fl_runner_aggregates(with_channel):
    """The port's legacy FLClient/FLServer/run_rounds against
    ``repro.fl``'s on the same case: each round's w within 1e-6 and the
    ledger's round records equal; with no channel both clients reach the
    mean of their targets, as ``tests/test_system.py`` asserts."""
    want, want_ledger = _legacy_run(
        jfl, joptim, jtrees.tree_add, jnp.array,
        lambda t, tgt: jax.grad(lambda u: jnp.sum((u["w"] - tgt) ** 2))(t),
        JRayleigh(seed=1) if with_channel else None)
    got, got_ledger = _legacy_run(
        fl, optim, trees.tree_add, torch.tensor,
        lambda t, tgt: {"w": 2 * (t["w"] - tgt)},
        RayleighChannel(seed=1) if with_channel else None)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert json.dumps(got_ledger, sort_keys=True) == json.dumps(want_ledger, sort_keys=True)
    if with_channel:
        assert len(got_ledger) == 20
        assert sum(r["outages"] for r in got_ledger) > 0    # the case drops uploads
    else:
        assert got_ledger == []
        assert abs(got[-1, 0] - got[-1, 1]) < 1e-4 and abs(got[-1, 0] - 2.0) < 0.2
