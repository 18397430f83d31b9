"""Shepherd's merged-LoRA oracle (``PFITConfig(factored=False)``) against
the JAX package's, on the CPU, from the JAX package's draws
(``test_torch_pfit.py``'s ``KW``), engine and loop.  Gates: as the
factored runs' — rewards within 1e-3, bytes and delays equal — and merged
against factored in the port: rewards within 1e-5.  ``run_pftt``'s and the
step builders' ``factored=False``: ``test_torch_oracles_api.py``."""
import numpy as np
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_pfit import KW as PFIT_KW
from test_torch_pfit import _export_init as pfit_init

from repro.core import pfit as jpfit
from repro_torch.core import pfit

TOL = 1e-5


def _ledger(res):
    return [(r["bytes"], r["delay_s"]) for r in res["round_records"]]


def test_shepherd_merged_matches_jax():
    """Shepherd with ``factored=False`` (the LoRA merged into the global in
    its loss, each client's merged copy served without LoRA) against JAX's
    ``run_pfit(factored=False)``: rewards within 1e-3, bytes and delays
    equal; engine and loop; merged against factored within 1e-5."""
    kw = dict(PFIT_KW, method="shepherd")
    want = jpfit.run_pfit(jpfit.PFITConfig(factored=False, **kw))
    init = pfit_init(jpfit.PFITConfig(**kw))
    factored = pfit.run_pfit(pfit.PFITConfig(device="cpu", **kw), init=init)
    for engine in (True, False):
        got = pfit.run_pfit(pfit.PFITConfig(factored=False, engine=engine, device="cpu", **kw),
                            init=init)
        np.testing.assert_allclose(got["reward_per_round"], want["reward_per_round"], atol=1e-3)
        assert _ledger(got) == _ledger(factored)
        assert got["total_bytes"] == want["total_bytes"]
        assert got["mean_round_delay_s"] == want["mean_round_delay_s"]
        np.testing.assert_allclose(got["reward_per_round"], factored["reward_per_round"],
                                   atol=TOL)
