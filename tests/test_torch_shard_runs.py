"""``run_pftt`` with the cohort sharded over two gloo ranks (one spawn of
two worker processes, ``tests/_torch_shard_worker.py``, running every
case) against the unsharded JAX engine, on the CPU, as
``tests/test_cohort_shard.py``'s 8-device cases hold JAX's sharded engine
(JAX's own sharded paths fail under the installed JAX; ROADMAP queue 3):

* 4 clients (2 a rank, no ghost), 3 clients (one ghost on rank 1) and 3
  clients at ``snr_db=-30`` (every round in outage): accuracies within
  1e-6, bytes and delays equal;
* a robust run under a fault plan: every round record, the stragglers'
  selections included, equal to JAX's; the tracker's counters equal to the
  unsharded port's;
* one int8 codec round with JAX's uniforms: each client's bits equal to
  the unsharded port's and within 1e-6 of JAX's (a quantizer's one-step
  flips, ``test_torch_comms_runs.py``);
* a 3-client run stopped after round 1 on two ranks (its checkpoint holds
  the real cohort, unsharded) and resumed here on one process: the
  uninterrupted run's accuracies (JAX's, within 1e-6) and ledger.

Both ranks must return the same result.  Widths: reduced roberta at d 32,
3 pretraining steps, 40 samples a client, 2 local steps."""
import dataclasses

import numpy as np
import pytest
from _torch_shard_worker import spawn_ranks
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_comms_runs import jax_codec_noise
from test_torch_fl import _export_init
from test_torch_robust_runs import FAULTY

from repro.core import pftt as jpftt
from repro.wireless import faults as jfaults
from repro_torch.core import pftt
from repro_torch.wireless import FaultPlan

KW = dict(d_model=32, rounds=2, local_steps=2, pretrain_steps=3, samples_per_client=40,
          batch=16)
ACC_TOL = 1e-6
BITS_RTOL = 1e-6
CASES = {"div4": dict(n_clients=4),
         "ghost3": dict(n_clients=3),
         "outage3": dict(n_clients=3, snr_db=-30.0),
         "robust3": dict(n_clients=3, staleness_a=0.5, max_staleness=2),
         "int8": dict(n_clients=3, method="fedlora", uplink_codec="int8", rounds=1),
         "resume3": dict(n_clients=3, rounds=1)}


def _cfgs(case):
    kw = dict(KW, **CASES[case])
    jkw, pkw = dict(kw), dict(kw, device="cpu")
    if case.startswith("robust"):
        jkw["fault_plan"], pkw["fault_plan"] = jfaults.FaultPlan(**FAULTY), FaultPlan(**FAULTY)
    return jpftt.PFTTConfig(**jkw), pftt.PFTTConfig(**pkw)


def _recorded(noise, table):
    def hook(rnd, ci, leaf, shape):
        table[(rnd, ci, leaf)] = np.asarray(noise(rnd, ci, leaf, shape))
        return table[(rnd, ci, leaf)]
    return hook


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: JAX's unsharded run, the port's unsharded run and each
    rank's sharded result; the resume case's checkpoint directory."""
    tmp = tmp_path_factory.mktemp("shard_pftt")
    jax_res, port, cases = {}, {}, {}
    for case in CASES:
        jcfg, cfg = _cfgs(case)
        init = _export_init(jcfg)
        if case == "resume3":     # the oracle is the uninterrupted 2-round run
            jax_res[case] = jax_res["ghost3"]
            port[case] = port["ghost3"]
            cfg = dataclasses.replace(cfg, ckpt_dir=str(tmp / "ck"))
        else:
            jax_res[case] = jpftt.run_pftt(jcfg)
            if cfg.uplink_codec != "none":
                table = {}
                init["codec_noise"] = _recorded(jax_codec_noise(jcfg.seed), table)
            port[case] = pftt.run_pftt(cfg, init=dict(init))
            if cfg.uplink_codec != "none":
                init.pop("codec_noise")
                init["codec_table"] = table
        cases[case] = {"fn": "pftt", "cfg": cfg, "init": init}
    ranks = spawn_ranks(cases, tmp / "spawn")
    return jax_res, port, ranks, str(tmp / "ck")


def _records(res):
    return [(r["bytes"], r["delay_s"], r["outages"]) for r in res["round_records"]]


@pytest.mark.parametrize("case", ["div4", "ghost3", "outage3"])
def test_sharded_run_pftt_matches_unsharded_jax(runs, case):
    want, port, ranks, _ = runs
    for got in (r[case] for r in ranks):
        np.testing.assert_allclose(got["acc_per_round"], want[case]["acc_per_round"],
                                   atol=ACC_TOL)
        assert got["mean_round_bytes"] == want[case]["mean_round_bytes"]
        np.testing.assert_equal(_records(got), _records(want[case]))
        np.testing.assert_allclose(got["loss_per_round"], port[case]["loss_per_round"],
                                   rtol=1e-5)
    assert ranks[0][case]["acc_per_round"] == ranks[1][case]["acc_per_round"]
    if case == "outage3":
        assert all(r["outages"] == 3 for r in want[case]["round_records"])


def test_sharded_robust_run_selections_match(runs):
    want, port, ranks, _ = runs
    for got in (r["robust3"] for r in ranks):
        np.testing.assert_equal(got["round_records"], want["robust3"]["round_records"])
        np.testing.assert_allclose(got["acc_per_round"], want["robust3"]["acc_per_round"],
                                   atol=ACC_TOL)
        assert got["staleness"] == port["robust3"]["staleness"]
        assert got["uplink_bits"] == port["robust3"]["uplink_bits"]
    assert port["robust3"]["staleness"]["retransmissions"] + \
        port["robust3"]["staleness"]["abandoned"] > 0


def test_sharded_int8_round_bits(runs):
    want, port, ranks, _ = runs
    for got in (r["int8"] for r in ranks):
        assert got["uplink_bits"]["realized"] == port["int8"]["uplink_bits"]["realized"]
        assert got["mean_round_bytes"] == port["int8"]["mean_round_bytes"]
        np.testing.assert_allclose(got["mean_round_bytes"], want["int8"]["mean_round_bytes"],
                                   rtol=BITS_RTOL)
        np.testing.assert_allclose(got["acc_per_round"], want["int8"]["acc_per_round"],
                                   atol=ACC_TOL)


def test_sharded_checkpoint_resumes_unsharded(runs):
    """The 2-rank run's checkpoint after round 1 (the real 3 clients,
    gathered) resumes on one process into the uninterrupted run."""
    want, port, ranks, ck = runs
    _, cfg = _cfgs("ghost3")
    jcfg, _ = _cfgs("ghost3")
    resumed = pftt.run_pftt(dataclasses.replace(cfg, ckpt_dir=ck, resume=True),
                            init=_export_init(jcfg))
    assert ranks[0]["resume3"]["acc_per_round"] == resumed["acc_per_round"][:1]
    np.testing.assert_allclose(resumed["acc_per_round"], want["ghost3"]["acc_per_round"],
                               atol=ACC_TOL)
    np.testing.assert_equal(_records(resumed), _records(want["ghost3"]))
    np.testing.assert_allclose(resumed["loss_per_round"], port["ghost3"]["loss_per_round"],
                               rtol=1e-5)
    assert len(resumed["round_s"]) == 1
