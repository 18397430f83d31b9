"""PFIT's legacy per-client loop in the robust round against the JAX
package's loop, on the CPU, from the JAX package's draws: pfit under
``tests/test_faults.py``'s FAULTY plan (``test_torch_robust_runs.py``'s
staleness settings, ``test_torch_pfit.py``'s ``KW``).  Gates: the reward
per round within 1e-3, the ledger's totals equal; the port's engine gives
the loop's records.  Shepherd's robust loop against the engine (port
only; its JAX runs are ``test_torch_oracles_shepherd.py``'s)."""
import numpy as np
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_pfit import KW as PFIT_KW
from test_torch_pfit import _export_init as pfit_init
from test_torch_robust_runs import _robust_kw

from repro.core import pfit as jpfit
from repro_torch.core import pfit


def test_robust_pfit_loop_matches_jax_loop():
    """pfit under FAULTY (staleness a 0.5, at most 2) for 2 rounds: nobody
    trains in round 0, client 1 trains and delivers in round 1; rewards
    within 1e-3 of JAX's loop, the ledger's totals equal; the port's engine
    gives the loop's rewards within 1e-6 and the same records."""
    kw = dict(PFIT_KW, method="pfit")
    want = jpfit.run_pfit(jpfit.PFITConfig(engine=False, **kw, **_robust_kw("faulty", True)))
    init = pfit_init(jpfit.PFITConfig(**kw))
    got = pfit.run_pfit(pfit.PFITConfig(engine=False, device="cpu", **kw,
                                        **_robust_kw("faulty", False)), init=init)
    np.testing.assert_allclose(got["reward_per_round"], want["reward_per_round"], atol=1e-3)
    for k in ("total_bytes", "total_energy_j", "mean_round_delay_s", "total_sim_time_s",
              "quorum_noops", "mean_round_bytes"):
        assert got[k] == want[k], k
    assert got["total_bytes"] > 0 and got["round_records"][0]["bytes"] == 0
    eng = pfit.run_pfit(pfit.PFITConfig(device="cpu", **kw, **_robust_kw("faulty", False)),
                        init=init)
    np.testing.assert_allclose(eng["reward_per_round"], got["reward_per_round"], atol=1e-6)
    np.testing.assert_equal(eng["round_records"], got["round_records"])
    assert eng["staleness"] == got["staleness"]


def test_robust_shepherd_loop_matches_port_engine():
    """Shepherd under FAULTY: the loop's robust round (the stacked mirror
    over its own LoRA trees) and the engine's give equal records and
    rewards within 1e-6."""
    kw = dict(PFIT_KW, method="shepherd", **_robust_kw("faulty", False))
    init = pfit_init(jpfit.PFITConfig(method="shepherd", **PFIT_KW))
    loop = pfit.run_pfit(pfit.PFITConfig(engine=False, device="cpu", **kw), init=init)
    eng = pfit.run_pfit(pfit.PFITConfig(device="cpu", **kw), init=init)
    np.testing.assert_allclose(loop["reward_per_round"], eng["reward_per_round"], atol=1e-6)
    np.testing.assert_equal(loop["round_records"], eng["round_records"])
    assert loop["staleness"] == eng["staleness"] and loop["total_bytes"] > 0
