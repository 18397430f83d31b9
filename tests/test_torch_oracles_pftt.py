"""PFTT's legacy per-client loop (``PFTTConfig(engine=False)``) against
the JAX package's loop, on the CPU, from the JAX package's draws
(``test_torch_fl.py``'s ``PFTT_KW`` and ``_export_init``: 3 clients, a
ragged cohort, 2 rounds), and against the port's own engine, as JAX's
``tests/test_cohort_engine.py`` holds its loop against its engine.  Gates:
every round's bytes and delay exactly equal, accuracies within 1e-6 (a
count of correct predictions over a client's test set: one flip moves it
by at least 1/40).  Also the loop's own contract: each client merges its
own copy of the aggregate, and what the JAX loop leaves out (checkpoints,
health scalars, the engine's spans) the port's leaves out too."""
import functools
import json

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_fl import PFTT_KW, _export_init

from repro.core import pftt as jpftt
from repro_torch import trees
from repro_torch.core import cohort, pftt
from repro_torch.obs import TelemetryConfig
from repro_torch.optim import adamw, value_and_grad


def _ledger(res):
    return [(r["bytes"], r["delay_s"]) for r in res["round_records"]]


@functools.lru_cache(maxsize=None)
def _port(method, engine):
    """The port's run of ``method`` from the JAX init, loop or engine."""
    jcfg = jpftt.PFTTConfig(method=method, **PFTT_KW)
    return pftt.run_pftt(pftt.PFTTConfig(method=method, engine=engine, device="cpu", **PFTT_KW),
                         init=_export_init(jcfg))


@pytest.mark.parametrize("method", pftt.METHODS)
def test_loop_matches_jax_loop(method):
    """The port's loop against JAX's ``run_pftt(engine=False)``: bytes and
    delays exactly equal, accuracies within 1e-6, the JAX result keys all
    present, ``fused_engine`` False on both sides."""
    want = jpftt.run_pftt(jpftt.PFTTConfig(method=method, engine=False, **PFTT_KW))
    got = _port(method, False)
    assert _ledger(got) == _ledger(want)
    np.testing.assert_allclose(got["acc_per_round"], want["acc_per_round"], atol=1e-6)
    for k in ("mean_round_bytes", "mean_round_delay_s", "total_bytes", "total_energy_j",
              "quorum_noops", "uplink_codec", "fused_engine", "ragged_cohort"):
        assert got[k] == want[k], k
    assert got["fused_engine"] is False and set(want) <= set(got)


@pytest.mark.parametrize("method", pftt.METHODS)
def test_loop_matches_port_engine(method):
    """The port's loop against the port's engine from the same init (the
    engine pads the ragged cohort and weighs its rows; the loop runs each
    client's own batches): bytes and delays equal, accuracies within 1e-6,
    mean local losses within 1e-6."""
    loop, eng = _port(method, False), _port(method, True)
    assert _ledger(loop) == _ledger(eng) and eng["fused_engine"] is True
    np.testing.assert_allclose(loop["acc_per_round"], eng["acc_per_round"], atol=1e-6)
    np.testing.assert_allclose(loop["loss_per_round"], eng["loss_per_round"], atol=1e-6)
    assert loop["uplink_bits"] == eng["uplink_bits"]


def test_broadcast_gives_each_client_its_own_copy():
    """After the loop's downlink (``cohort.own_copies``) client 0's training
    — one AdamW step written into its tensors in place, as the engine's
    ``write_client`` writes — leaves client 1's trainable and the aggregate
    unchanged; ``recv`` 0 keeps a client's own tree."""
    rng = np.random.RandomState(0)
    clients = [{"shared": {"w": torch.from_numpy(rng.randn(3, 4).astype(np.float32))},
                "local": {"v": torch.from_numpy(rng.randn(4).astype(np.float32))}}
               for _ in range(3)]
    agg = {"shared": {"w": torch.ones(3, 4)}, "local": {"v": None}}
    before = [trees.map_leaves(torch.clone, c) for c in clients]
    got = cohort.own_copies(clients, agg, recv=np.array([1.0, 1.0, 0.0]))
    assert got[2] is clients[2]
    opt = adamw(0.1)
    loss, g = value_and_grad(lambda t: (t["shared"]["w"] ** 2).sum() + t["local"]["v"].sum(),
                             got[0])
    upd, _ = opt.update(g, opt.init(got[0]), got[0])
    trees.map_leaves(lambda dst, src: dst.copy_(src), got[0], trees.tree_add(got[0], upd))
    assert not torch.equal(got[0]["shared"]["w"], torch.ones(3, 4))
    np.testing.assert_array_equal(got[1]["shared"]["w"].numpy(), np.ones((3, 4), np.float32))
    np.testing.assert_array_equal(got[1]["local"]["v"].numpy(), before[1]["local"]["v"].numpy())
    np.testing.assert_array_equal(agg["shared"]["w"].numpy(), np.ones((3, 4), np.float32))
    assert got[0]["shared"]["w"].data_ptr() != got[1]["shared"]["w"].data_ptr()


def test_loop_keeps_the_jax_loops_semantics(tmp_path):
    """As JAX's loop: no checkpoint under ``ckpt_dir`` (JAX checkpoints the
    engine only), no health scalars even when asked, no ``gather`` or
    ``device-step`` span, ``fused_engine`` False; the run event says
    ``engine`` False."""
    ck, tele = tmp_path / "ck", tmp_path / "tele"
    kw = dict(PFTT_KW, rounds=1, engine=False, ckpt_dir=str(ck))
    res = pftt.run_pftt(pftt.PFTTConfig(
        device="cpu", telemetry=TelemetryConfig(str(tele), trace=True, health=True), **kw))
    assert res["fused_engine"] is False and res["health_per_round"] == [None]
    assert not ck.exists() or list(ck.iterdir()) == []
    events = [json.loads(line) for line in open(tele / "events.jsonl")]
    assert [e["meta"]["engine"] for e in events if e["event"] == "run"] == [False]
    for e in events:
        if e["event"] == "round":
            assert e["health"] is None and set(e["wall"]["phases"]) <= {"eval"}
