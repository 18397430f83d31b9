"""PFIT's legacy per-client loop (``PFITConfig(engine=False)``) against
the JAX package's loop, on the CPU, from the JAX package's draws
(``test_torch_pfit.py``'s ``KW`` and ``_export_init``: the policy, both
reward models, the kept heads and every sampling stream's Gumbel noise),
and against the port's own engine, as JAX's ``tests/test_cohort_engine.py``
holds its loop against its engine.  Gates: the reward per round within
1e-3 (the JAX package's own engine-vs-loop tolerance), every round's bytes
and delay exactly equal."""
import functools

import numpy as np
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_pfit import KW, _export_init

from repro.core import pfit as jpfit
from repro_torch.core import pfit


def _ledger(res):
    return [(r["bytes"], r["delay_s"]) for r in res["round_records"]]


@functools.lru_cache(maxsize=None)
def _port(method, engine):
    """The port's run of ``method`` from the JAX draws, loop or engine."""
    return pfit.run_pfit(pfit.PFITConfig(method=method, engine=engine, device="cpu", **KW),
                         init=_export_init(jpfit.PFITConfig(method=method, **KW)))


def test_pfit_loop_matches_jax_loop():
    """pfit (2 clients, 2 rounds): the rollout through ``generate`` and the
    masked PPO round client by client, then ``masked_fedavg`` and the
    masked broadcast.  Rewards within 1e-3 of JAX's loop, bytes and delays
    equal, the reward models' pair accuracies equal, the JAX result keys
    all present."""
    want = jpfit.run_pfit(jpfit.PFITConfig(method="pfit", engine=False, **KW))
    got = _port("pfit", False)
    assert set(want) <= set(got) and got["fused_engine"] is False
    np.testing.assert_allclose(got["reward_per_round"], want["reward_per_round"], atol=1e-3)
    assert got["rm_pair_acc"] == want["rm_pair_acc"]
    for k in ("mean_round_bytes", "mean_round_delay_s", "total_bytes", "total_energy_j",
              "total_sim_time_s", "quorum_noops", "uplink_codec", "method"):
        assert got[k] == want[k], k


def test_loop_matches_port_engine():
    """The port's pfit loop against its engine from the same draws: rewards
    within 1e-3, bytes and delays equal, the clients' rollout rewards within
    1e-6 and round 0's sampled tokens equal (the same host noise stream,
    rnd·17 + ci, reaches the same rollout).  Shepherd's:
    ``test_torch_oracles_shepherd.py``."""
    loop, eng = _port("pfit", False), _port("pfit", True)
    np.testing.assert_allclose(loop["reward_per_round"], eng["reward_per_round"], atol=1e-3)
    assert _ledger(loop) == _ledger(eng) and eng["fused_engine"] is True
    np.testing.assert_allclose(loop["train_reward_per_round"], eng["train_reward_per_round"],
                               atol=1e-6)
    for a, b in zip(loop["rollouts_round0"] + loop["eval_round0"],
                    eng["rollouts_round0"] + eng["eval_round0"]):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
