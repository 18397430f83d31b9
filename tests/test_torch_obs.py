"""The port's observability (``repro_torch.obs``) against the JAX package's
``repro.obs``, on the CPU:

* the copied ``metrics`` writes the same bytes from the same events, and
  its validator and canonical stream agree with the original's, bad
  streams included; each package's ``report --check`` accepts the other's
  stream;
* the copied ``SpanTracer`` accumulates and nests as the original does;
  ``torch_profile_start``/``stop`` write a Chrome trace;
* ``cohort_health`` against JAX's ``cohort_health`` and the float64
  ``host_health`` on the same numpy inputs, with and without a codec:
  ≤ 1e-6;
* one supervised round, synchronous and robust (``test_torch_fl.py``'s
  three-client setup), with health: the dict within 1e-5 of JAX's engine,
  and the state with health on bitwise the state with health off; the same
  with int8 and JAX's uniforms injected, ``codec_err`` included;
* ``run_pftt`` with telemetry: the stream validates and carries each
  round's health, the trace's spans nest."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_comms import jax_noise
from test_torch_fl import _np, round_setup  # noqa: F401  (a fixture)

from repro import obs as jobs
from repro import trees as jtrees
from repro.comms import codec as jcodec
from repro.core import cohort as jcohort
from repro.core import pftt as jpftt
from repro.launch import report as jreport
from repro.models import Model as JModel
from repro.models import peft as jpeft
from repro.optim import adamw as jadamw
from repro_torch import bridge, obs, trees
from repro_torch.comms import get_codec
from repro_torch.configs import get_config
from repro_torch.core import cohort, pftt
from repro_torch.launch import report
from repro_torch.models import peft
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw, value_and_grad

TOL_SHARED = 1e-6     # health on shared numpy inputs
TOL_ROUND = 1e-5      # health inside a round from identical state


# --------------------------------------------------------------- metrics
def _events(tele, rounds=3):
    tele.start({"mode": "test", "rounds": rounds})
    for r in range(rounds):
        tele.round_event(r, {
            "acc": 0.5 + 0.1 * r, "cohort": [r, r + 1],
            "comm": {"record_id": r, "round": r, "bytes": 1000 * (r + 1),
                     "delay_s": float("nan") if r == 1 else 0.25, "outages": 0},
            "staleness": {"pending": 0, "abandoned": 0, "retransmissions": 0,
                          "quorum_noops": 0},
            "health": {k: 0.1 for k in obs.HEALTH_KEYS},
        }, wall={"phases": {"device-step": 0.01 * (r + 1)}})
        tele.checkpoint(r)
    tele.compile_event(0, 1.5)
    return tele


def test_metrics_copy_writes_the_same_stream(tmp_path):
    """Same events → the same file bytes, the same reading, validation and
    canonical stream; a resume drops the same rounds."""
    mine = _events(obs.RunTelemetry(str(tmp_path / "port")))
    ref = _events(jobs.RunTelemetry(str(tmp_path / "jax")))
    assert open(mine.path, "rb").read() == open(ref.path, "rb").read()
    ev = obs.read_events(mine.path)
    assert ev == jobs.read_events(ref.path)
    assert obs.validate_events(ev) == jobs.validate_events(ev) == []
    assert obs.canonical_stream(ev) == jobs.canonical_stream(ev)
    assert obs.SCHEMA_VERSION == jobs.SCHEMA_VERSION
    mine.resume(1, {"k": 1})
    ref.resume(1, {"k": 1})
    assert open(mine.path, "rb").read() == open(ref.path, "rb").read()
    assert [e["round"] for e in obs.read_events(mine.path) if e["event"] == "round"] == [0]
    fields = {f.name for f in dataclasses.fields(obs.TelemetryConfig)}
    jfields = {f.name for f in dataclasses.fields(jobs.TelemetryConfig)}
    assert fields ^ jfields == {"torch_profile", "jax_profile"}


BAD_STREAMS = {
    "empty": [],
    "no_run_head": [{"event": "round", "round": 0, "comm": {}, "wall": {}}],
    "old_schema": [{"event": "run", "schema": 0}],
    "unknown_and_dup": [{"event": "run", "schema": 1}, {"event": "bogus"},
                        {"event": "round", "round": 1, "comm": {}, "wall": {}},
                        {"event": "round", "round": 1, "comm": {}, "wall": {}}],
    "out_of_order_missing": [{"event": "run", "schema": 1},
                             {"event": "round", "round": 2, "wall": {}},
                             {"event": "round", "round": 1, "comm": {}},
                             {"event": "round", "comm": {}, "wall": {}}],
}


@pytest.mark.parametrize("case", list(BAD_STREAMS))
def test_validator_reports_what_jax_reports(case):
    errs = obs.validate_events(BAD_STREAMS[case])
    assert errs and errs == jobs.validate_events(BAD_STREAMS[case])


def test_disabled_telemetry_is_a_noop(tmp_path):
    tele = obs.RunTelemetry(None, tracer=obs.SpanTracer(enabled=True))
    tele.start({})
    tele.round_event(0, {"comm": {}})
    tele.checkpoint(0)
    tele.close()
    assert not tele.enabled and tele.path is None and not list(tmp_path.iterdir())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_report_checks_the_others_stream(tmp_path, writer, capsys):
    tele = (obs if writer == "port" else jobs).RunTelemetry(str(tmp_path))
    _events(tele)
    assert report.main([str(tmp_path), "--check"]) == 0
    assert jreport.main([str(tmp_path), "--check"]) == 0
    with open(tele.path, "a") as f:      # a duplicated round fails both
        f.write(json.dumps({"event": "round", "round": 2, "comm": {}, "wall": {}}) + "\n")
    assert report.main([str(tmp_path), "--check"]) == 1
    assert jreport.main([str(tmp_path), "--check"]) == 1
    assert "check FAILED" in capsys.readouterr().err


# --------------------------------------------------------------- tracer
def _spans(tracer, sleep):
    with tracer.span("round"):
        with tracer.span("gather", n=2):
            sleep()
        with tracer.span("device-step"):
            with tracer.span("encode"):
                sleep()
    first = tracer.pop_round()
    with tracer.span("eval"):
        sleep()
    return first, tracer.pop_round(), tracer.totals()


@pytest.mark.parametrize("enabled", [False, True])
def test_span_tracer_copy_accounts_and_nests_like_jax(tmp_path, enabled):
    mine, ref = obs.SpanTracer(enabled=enabled), jobs.SpanTracer(enabled=enabled)
    got, want = _spans(mine, lambda: None), _spans(ref, lambda: None)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and all(v >= 0 for v in g.values())
    assert set(got[0]) == {"round", "gather", "device-step", "encode"}
    ev, jev = mine.chrome_trace()["traceEvents"], ref.chrome_trace()["traceEvents"]
    assert [e["name"] for e in ev] == [e["name"] for e in jev]
    assert len(ev) == (5 if enabled else 0)
    if enabled:
        outer = next(e for e in ev if e["name"] == "round")
        for e in ev:
            if e["name"] in ("gather", "device-step", "encode"):
                assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
        assert next(e for e in ev if e["name"] == "gather")["args"] == {"n": 2}
        mine.write(str(tmp_path / "trace.json"))
        assert json.load(open(tmp_path / "trace.json"))["traceEvents"] == ev


def test_torch_profile_bracket_writes_a_chrome_trace(tmp_path):
    prof = obs.torch_profile_start(torch.device("cpu"))
    torch.ones(64, 64) @ torch.ones(64, 64)
    path = obs.torch_profile_stop(prof, str(tmp_path))
    assert path == str(tmp_path / "torch_profile" / "trace.json")
    assert "traceEvents" in json.load(open(path))


# --------------------------------------------------------------- health
def _health_inputs(codec):
    rng = np.random.RandomState(3)
    tree = lambda: {"a": {"w": rng.randn(4, 3, 2).astype(np.float32)},   # noqa: E731
                    "b": rng.randn(4, 5).astype(np.float32)}
    send, ref = tree(), tree()
    raw = tree() if codec else None
    dec = None if not codec else jax.tree_util.tree_map(
        lambda x: x + 0.01 * rng.randn(*x.shape).astype(np.float32), raw)
    losses = rng.rand(4, 2).astype(np.float32)
    w = np.asarray([1.0, 1.0, 0.0, 0.5], np.float32)
    train = np.asarray([1, 1, 0, 1], np.float32)
    losses[2] = 0.0
    return send, ref, raw, dec, losses, w, train


@pytest.mark.parametrize("codec", [False, True], ids=["no_codec", "codec"])
@pytest.mark.parametrize("gate", [1.0, 0.0])
def test_cohort_health_matches_jax_and_the_oracle(codec, gate):
    send, ref, raw, dec, losses, w, train = _health_inputs(codec)
    t = lambda tree: None if tree is None else trees.map_leaves(   # noqa: E731
        torch.from_numpy, tree)
    got = obs.cohort_health(t(send), t(ref), torch.from_numpy(losses), torch.from_numpy(w),
                            torch.tensor(gate), train_m=torch.from_numpy(train),
                            raw=t(raw), decoded=t(dec))
    j = lambda tree: None if tree is None else jax.tree_util.tree_map(   # noqa: E731
        jnp.asarray, tree)
    want = jobs.cohort_health(j(send), j(ref), jnp.asarray(losses), jnp.asarray(w),
                              jnp.float32(gate), train_m=jnp.asarray(train), raw=j(raw),
                              decoded=j(dec))
    oracle = obs.host_health(send, ref, losses, w, gate, train_m=train, raw=raw, decoded=dec)
    joracle = jobs.host_health(send, ref, losses, w, gate, train_m=train, raw=raw, decoded=dec)
    assert set(got) == set(obs.HEALTH_KEYS) and obs.HEALTH_KEYS == jobs.HEALTH_KEYS
    for k in obs.HEALTH_KEYS:
        assert got[k].dim() == 0 and got[k].dtype == torch.float32, k
        assert float(got[k]) == pytest.approx(float(want[k]), abs=TOL_SHARED), k
        assert float(got[k]) == pytest.approx(oracle[k], abs=TOL_SHARED), k
        assert oracle[k] == pytest.approx(joracle[k], abs=1e-12), k
    assert (float(got["codec_err"]) > 0) == codec
    assert float(got["delivered"]) == 3.0 and float(got["loss_mean"]) > 0


# --------------------------------------------------------------- in a round
SYNC_W = [1.0, 0.0, 1.0]
ROBUST_MASKS = ([1, 0, 1], [1.0, 0.5, 0.7], [1, 0, 1], [0, 0, 1], [1, 1, 0])
CODEC_KEYS = [jax.random.fold_in(jax.random.PRNGKey(3), ci) for ci in range(3)]


def _port_round(round_setup, robust, health, codec=None):  # noqa: F811
    jcfg, pc, jparams, loras, batches = round_setup
    cfg = get_config("roberta-base").reduced(d_model=64, repeats=2)
    model = Model(cfg, device="cpu")
    params = bridge.params_from_numpy(_np(jparams), cfg)
    opt = adamw(1e-2, update_mask=lambda p: not p.endswith("/mask"))
    scale = peft.lora_scale(peft.PEFTConfig(lora_rank=4))
    pred = pftt._upload_pred("pftt")

    def local(t, o, batch):
        def loss_fn(t):
            full, lora = pftt._split_trainable("pftt", params, t)
            return model.cls_loss(full, batch, lora=lora, lora_scale=scale)[0]
        loss, g = value_and_grad(loss_fn, t)
        upd, o = opt.update(g, o, t)
        return trees.tree_add(t, upd), o, loss

    ts = [pftt._build_trainable("pftt", params, bridge.lora_from_numpy(_np(lo), cfg))
          for lo in loras]
    st, so = trees.stack(ts), trees.stack([opt.init(t) for t in ts])
    rnd = cohort.build_supervised_round(local, pred, robust=robust, health=health,
                                        codec=codec)
    bt = cohort.HostBatchStacker("cpu")(batches)
    noise = () if codec is None else ([jax_noise(k) for k in CODEC_KEYS],)
    if robust:
        pend = trees.map_leaves(lambda v: v + 0.05, trees.select(st, pred))
        masks = [torch.tensor(m, dtype=torch.float32) for m in ROBUST_MASKS]
        return rnd(st, so, pend, bt, *masks, *noise)
    return rnd(st, so, bt, torch.tensor(SYNC_W), *noise)


def _jax_round(round_setup, robust, codec=None):  # noqa: F811
    jcfg, pc, jparams, loras, batches = round_setup
    jmodel = JModel(jcfg)
    jopt = jadamw(1e-2, update_mask=lambda p: not p.endswith("/mask"))
    scale = jpeft.lora_scale(pc)
    pred = jpftt._upload_pred("pftt")

    def jlocal(t, o, batch):
        def loss_fn(t):
            full, lora = jpftt._split_trainable("pftt", jparams, t)
            return jmodel.cls_loss(full, batch, lora=lora, lora_scale=scale)[0]
        loss, g = jax.value_and_grad(loss_fn)(t)
        upd, o = jopt.update(g, o, t)
        return jtrees.tree_add(t, upd), o, loss

    jts = [jpftt._build_trainable("pftt", jparams, lo) for lo in loras]
    jst, jso = jtrees.stack(jts), jtrees.stack([jopt.init(t) for t in jts])
    rnd = jcohort.build_supervised_round(jlocal, pred, robust=robust, health=True,
                                         donate=False, codec=codec)
    bt = jcohort.HostBatchStacker()(batches)
    keys = () if codec is None else (jnp.stack(CODEC_KEYS),)
    if robust:
        jpend = jax.tree_util.tree_map(lambda v: v + 0.05, jtrees.select(jst, pred))
        return rnd(jst, jso, jpend, bt, *(jnp.asarray(m, jnp.float32) for m in ROBUST_MASKS),
                   *keys)
    return rnd(jst, jso, bt, jnp.asarray(SYNC_W), *keys)


@pytest.mark.parametrize("robust", [False, True], ids=["sync", "robust"])
def test_round_health_matches_jax_and_leaves_the_state_bitwise(round_setup, robust):  # noqa: F811
    """One round (3 clients, 2 ragged local steps) with health: the dict
    within 1e-5 of JAX's engine's; everything else the round returns
    bitwise equal to the same round with health off."""
    on, off = (_port_round(round_setup, robust, h) for h in (True, False))
    want = _jax_round(round_setup, robust)[-1]
    assert len(on) == len(off) + 1
    for k in obs.HEALTH_KEYS:
        assert float(on[-1][k]) == pytest.approx(float(want[k]), abs=TOL_ROUND, rel=TOL_ROUND), k
    for a, b in zip(on[:-1], off):
        fa, fb = trees.flatten(a) if isinstance(a, dict) else {"": a}, \
            trees.flatten(b) if isinstance(b, dict) else {"": b}
        assert fa.keys() == fb.keys()
        assert all(torch.equal(fa[k], fb[k]) for k in fa)
    if robust:   # client 1 retransmits its pending payload, client 2 is late;
        # the losses are the 2 training rows' only
        assert float(on[-1]["delivered"]) == 2.0
        assert float(on[-1]["loss_mean"]) == pytest.approx(
            float(on[3].sum()) / (2 * on[3].shape[1]))


@pytest.mark.parametrize("robust", [False, True], ids=["sync", "robust"])
def test_round_health_with_a_codec_matches_jax(round_setup, robust):  # noqa: F811
    """int8 through the round, JAX's uniforms injected: the whole health
    dict (``codec_err`` from the pre-codec uploads, ``update_norm`` over the
    decoded ones; robust: over ``send``) within 1e-5 of JAX's engine's, and
    the state bitwise the health-off round's."""
    on, off = (_port_round(round_setup, robust, h, get_codec("int8")) for h in (True, False))
    want = _jax_round(round_setup, robust, jcodec.get_codec("int8"))[-1]
    for a, b in zip(on[:-1], off):
        fa, fb = trees.flatten(a) if isinstance(a, dict) else {"": a}, \
            trees.flatten(b) if isinstance(b, dict) else {"": b}
        assert all(torch.equal(fa[k], fb[k]) for k in fa)
    assert float(on[-1]["codec_err"]) > 0
    for k in obs.HEALTH_KEYS:
        assert float(on[-1][k]) == pytest.approx(float(want[k]), abs=TOL_ROUND, rel=TOL_ROUND), k


# --------------------------------------------------------------- a run
def test_run_pftt_writes_a_valid_stream_with_health(tmp_path):
    """``run_pftt`` (2 clients, 2 rounds, d 32) with telemetry and trace:
    the stream validates and ``report --check`` passes, each round event
    holds the seven health scalars (equal to the result's), the compile
    event marks round 0, and the trace's spans are the JAX runner's."""
    tele = obs.TelemetryConfig(out_dir=str(tmp_path), trace=True)
    res = pftt.run_pftt(pftt.PFTTConfig(
        n_clients=2, rounds=2, local_steps=2, batch=4, d_model=32, lora_rank=2,
        adapter_dim=4, pretrain_steps=2, samples_per_client=16, device="cpu",
        telemetry=tele))
    ev = obs.read_events(str(tmp_path / "events.jsonl"))
    assert obs.validate_events(ev) == [] and report.main([str(tmp_path), "--check"]) == 0
    assert [e["event"] for e in ev] == ["run", "compile", "round", "round"]
    rounds = [e for e in ev if e["event"] == "round"]
    assert [e["health"] for e in rounds] == res["health_per_round"]
    assert all(set(h) == set(obs.HEALTH_KEYS) for h in res["health_per_round"])
    assert rounds[0]["acc"] == res["acc_per_round"][0] and rounds[0]["cohort"] is None
    names = {e["name"] for e in json.load(open(tmp_path / "trace.json"))["traceEvents"]}
    assert names == {"gather", "device-step", "eval"}
