"""PFIT's shepherd baseline through the legacy per-client loop against the
JAX package's loop, on the CPU, from the JAX package's draws
(``test_torch_pfit.py``'s ``KW``): its supervised LoRA steps client by
client, ``fedavg`` and each client's own copy of the aggregate, the
evaluation serving each LoRA unmerged; then against the port's engine.
Gates: the reward per round within 1e-3, bytes and delays equal.  The
int8 uplink: ``test_torch_oracles_shepherd_codec.py``."""
import numpy as np
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_pfit import KW, _export_init

from repro.core import pfit as jpfit
from repro_torch.core import pfit


def _ledger(res):
    return [(r["bytes"], r["delay_s"]) for r in res["round_records"]]


def test_shepherd_loop_matches_jax_loop_and_port_engine():
    kw = dict(KW, method="shepherd")
    want = jpfit.run_pfit(jpfit.PFITConfig(engine=False, **kw))
    init = _export_init(jpfit.PFITConfig(**kw))
    got = pfit.run_pfit(pfit.PFITConfig(engine=False, device="cpu", **kw), init=init)
    assert set(want) <= set(got) and got["fused_engine"] is False
    np.testing.assert_allclose(got["reward_per_round"], want["reward_per_round"], atol=1e-3)
    for k in ("mean_round_bytes", "mean_round_delay_s", "total_bytes", "total_energy_j",
              "quorum_noops"):
        assert got[k] == want[k], k
    eng = pfit.run_pfit(pfit.PFITConfig(device="cpu", **kw), init=init)
    np.testing.assert_allclose(got["reward_per_round"], eng["reward_per_round"], atol=1e-3)
    assert _ledger(got) == _ledger(eng) and eng["fused_engine"] is True
    for a, b in zip(got["eval_round0"], eng["eval_round0"]):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
