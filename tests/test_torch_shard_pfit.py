"""``run_pfit``, population mode and ``run_arch_round`` with the cohort
sharded over two gloo ranks (one spawn of two worker processes,
``tests/_torch_shard_worker.py``, running every case) against the
unsharded JAX engine, on the CPU (JAX's own sharded paths fail under the
installed JAX; ROADMAP queue 3).  Every cohort has 3 clients, so rank 1
holds a ghost:

* ``run_pfit`` PPO (pfit) and shepherd, one round, with JAX's Gumbel
  noise (recorded from the unsharded port run, keyed by client id):
  rewards within 1e-3 (``tests/test_cohort_shard.py``'s), bytes equal;
* population mode (``run_pftt``, pftt, cohort 3 of 8 under stragglers,
  health on): the same cohorts, health within 1e-3, accuracies within
  1e-6;
* ``run_arch_round`` on a reduced llama3.2-1b (d 32): losses within 1e-5.

Both ranks must return the same result."""
import dataclasses

import jax
import numpy as np
import pytest
from _torch_shard_worker import spawn_ranks
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_fl import _export_init as pftt_init
from test_torch_pfit import KW as PFIT_KW
from test_torch_pfit import _export_init as pfit_init

from repro import obs as jobs
from repro import trees as jtrees
from repro.configs import get_config as jget_config
from repro.core import arch_round as jar
from repro.core import pfit as jpfit
from repro.core import pftt as jpftt
from repro.fl import population as jpop
from repro.models import Model as JModel
from repro.models import peft as jpeft
from repro.sharding import MeshCtx
from repro.wireless import faults as jfaults
from repro.wireless import scenarios as jscen
from repro_torch import obs
from repro_torch.core import arch_round, pfit, pftt
from repro_torch.fl import PopulationConfig
from repro_torch.wireless import FaultPlan
from repro_torch.wireless.scenarios import Scenario

REWARD_TOL = 1e-3
HEALTH_TOL = 1e-3
ACC_TOL = 1e-6
LOSS_TOL = 1e-5
PFIT = dict(PFIT_KW, n_clients=3, rounds=1)
POP_KW = dict(rounds=2, local_steps=2, batch=4, pretrain_steps=5, samples_per_client=32,
              test_samples=8, d_model=32, lora_rank=2, adapter_dim=4, seed=0,
              staleness_a=0.5, max_staleness=2)
SCEN = dict(alpha=0.1, avail="diurnal", avail_period=6, seed=1)
STRAGGLE = dict(straggle_p=0.3, max_straggle=2, seed=2)
ARCH = dict(arch="llama3.2-1b", n_clients=3, rounds=1, local_steps=2, batch=3, seq_len=12,
            d_model=32)


def _recorded_noise(noise, table):
    """``noise(stream, batch)`` that records each stream's draws."""
    def hook(stream, batch):
        h = noise(stream, batch)
        table[stream] = [np.asarray(h(s)) for s in range(PFIT["gen_len"])]
        return h
    return hook


def _arch_init():
    mcfg = jget_config(ARCH["arch"]).reduced(d_model=ARCH["d_model"], repeats=1)
    key = jax.random.PRNGKey(0)
    params = JModel(mcfg, meshctx=MeshCtx.single_device()).init(key, max_seq=ARCH["seq_len"])
    pc = jpeft.PEFTConfig(lora_rank=4, lora_alpha=8.0, lora_targets=jar.arch_lora_targets(mcfg))
    flat = lambda t: {k: np.asarray(v) for k, v in jtrees.flatten(t).items()}  # noqa: E731
    return {"params": flat(params),
            "lora": [flat(jpeft.init_lora(jax.random.fold_in(key, 100 + ci), params, pc))
                     for ci in range(ARCH["n_clients"])]}


def _pop_cfgs(tmp):
    jcfg = jpftt.PFTTConfig(population=jpop.PopulationConfig(
        population=8, cohort_size=3, scenario=jscen.Scenario(**SCEN)),
        fault_plan=jfaults.FaultPlan(**STRAGGLE),
        telemetry=jobs.TelemetryConfig(out_dir=str(tmp / "jax_pop")), **POP_KW)
    cfg = pftt.PFTTConfig(population=PopulationConfig(
        population=8, cohort_size=3, scenario=Scenario(**SCEN)),
        fault_plan=FaultPlan(**STRAGGLE), device="cpu",
        telemetry=obs.TelemetryConfig(out_dir=str(tmp / "port_pop")), **POP_KW)
    return jcfg, cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: JAX's unsharded run (population: its round events too),
    the port's unsharded run and each rank's sharded result."""
    tmp = tmp_path_factory.mktemp("shard_pfit")
    want, port, cases = {}, {}, {}
    for method in ("pfit", "shepherd"):
        jcfg = jpfit.PFITConfig(method=method, **PFIT)
        cfg = pfit.PFITConfig(method=method, device="cpu", **PFIT)
        init, table = pfit_init(jcfg), {}
        want[method] = jpfit.run_pfit(jcfg)
        port[method] = pfit.run_pfit(cfg, init=dict(init, noise=_recorded_noise(init["noise"],
                                                                                  table)))
        init.pop("noise")
        cases[method] = {"fn": "pfit", "cfg": cfg, "init": dict(init, noise_table=table)}
    jcfg, cfg = _pop_cfgs(tmp)
    want["pop"] = jpftt.run_pftt(jcfg)
    want["pop_rounds"] = [e for e in jobs.read_events(str(tmp / "jax_pop" / "events.jsonl"))
                          if e["event"] == "round"]
    init = pftt_init(dataclasses.replace(jcfg, population=None, n_clients=8))
    port["pop"] = pftt.run_pftt(cfg, init=init)
    cases["pop"] = {"fn": "pftt", "cfg": dataclasses.replace(
        cfg, telemetry=obs.TelemetryConfig(out_dir=str(tmp / "shard_pop"))), "init": init}
    want["arch"] = jar.run_arch_round(jar.ArchRoundConfig(**ARCH))
    cases["arch"] = {"fn": "arch", "cfg": arch_round.ArchRoundConfig(device="cpu", **ARCH),
                     "init": _arch_init()}
    return want, port, spawn_ranks(cases, tmp / "spawn")


@pytest.mark.parametrize("method", ["pfit", "shepherd"])
def test_sharded_run_pfit_matches_unsharded_jax(runs, method):
    want, port, ranks = runs
    for got in (r[method] for r in ranks):
        np.testing.assert_allclose(got["reward_per_round"], want[method]["reward_per_round"],
                                   atol=REWARD_TOL)
        np.testing.assert_allclose(got["reward_per_round"], port[method]["reward_per_round"],
                                   atol=1e-5)
        for k in ("mean_round_bytes", "total_bytes", "mean_round_delay_s"):
            assert got[k] == want[method][k], k
        assert got["round_records"] == port[method]["round_records"]
    assert ranks[0][method]["reward_per_round"] == ranks[1][method]["reward_per_round"]


def test_sharded_population_matches_unsharded_jax(runs):
    want, port, ranks = runs
    for got in (r["pop"] for r in ranks):
        assert got["cohorts"] == port["pop"]["cohorts"] == \
            [e["cohort"] for e in want["pop_rounds"]]
        np.testing.assert_allclose(got["acc_per_round"], want["pop"]["acc_per_round"],
                                   atol=ACC_TOL)
        assert [r["bytes"] for r in got["round_records"]] == \
            [r["bytes"] for r in want["pop"]["round_records"]]
        for h, e in zip(got["health_per_round"], want["pop_rounds"]):
            for k in obs.HEALTH_KEYS:
                assert h[k] == pytest.approx(e["health"][k], abs=HEALTH_TOL, rel=HEALTH_TOL), k
        assert got["staleness"] == port["pop"]["staleness"]


def test_sharded_arch_round_matches_unsharded_jax(runs):
    want, _, ranks = runs
    for got in (r["arch"] for r in ranks):
        assert got["n_ghosts"] == 1 and got["dispatches_per_round"] == 1.0
        np.testing.assert_allclose(got["loss_per_round"], want["arch"]["loss_per_round"],
                                   atol=LOSS_TOL)
        assert got["dense_merges_in_engine"] == 0
    np.testing.assert_array_equal(ranks[0]["arch"]["loss_per_round"],
                                  ranks[1]["arch"]["loss_per_round"])
