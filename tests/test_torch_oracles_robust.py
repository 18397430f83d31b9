"""PFTT's legacy per-client loop in the robust round against the JAX
package's loop, on the CPU, from the JAX package's draws: method pftt
under ``tests/test_deadline.py``'s MIX fault plan (3 clients, 3 rounds,
``test_torch_robust_runs.py``'s staleness settings), and fedlora under a
merging deadline with the int8 codec and ``factored_agg`` (JAX's codec
uniforms injected).  Gates: every round record equal (with the quantizer,
its floats within ``FLIP_RTOL``, the ``test_torch_comms_runs.py`` bound
for one-step symbol flips), accuracies within 1e-6.  The same runs of the
port's engine agree with its loop."""
import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_comms_runs import FLIP_RTOL, _close_records, _port_init
from test_torch_robust_runs import DL_MERGE, PFTT_ROBUST, _robust_kw

from repro.core import pftt as jpftt
from repro.wireless import arrivals as jarrivals
from repro_torch.core import pftt
from repro_torch.wireless import DeadlineConfig

CODEC_KW = dict(PFTT_ROBUST, method="fedlora", uplink_codec="int8", factored_agg=True)


def _pftt_case(case):
    """(JAX config kwargs, port config kwargs) of a robust PFTT case."""
    if case == "mix":
        return tuple(dict(PFTT_ROBUST, **dict(_robust_kw("mix_dl", jax_side), deadline=None))
                     for jax_side in (True, False))
    return (dict(CODEC_KW, deadline=jarrivals.DeadlineConfig(**DL_MERGE)),
            dict(CODEC_KW, deadline=DeadlineConfig(**DL_MERGE)))


@pytest.mark.parametrize("case", ["mix", "dl_int8_factored_agg"])
def test_robust_pftt_loop_matches_jax_loop(case):
    """MIX: records equal (bytes, delays, energies, per-client reports),
    retransmissions counted; the deadline run: its records within
    ``FLIP_RTOL`` (bits from the int8 entropy code), the simulated time and
    quorum no-ops equal; accuracies within 1e-6 in both.  The port's engine
    from the same init gives the loop's records and accuracies."""
    jkw, kw = _pftt_case(case)
    want = jpftt.run_pftt(jpftt.PFTTConfig(engine=False, **jkw))
    init = _port_init(jpftt.PFTTConfig(**jkw))
    got = pftt.run_pftt(pftt.PFTTConfig(engine=False, device="cpu", **kw), init=init)
    if case == "mix":
        np.testing.assert_equal(got["round_records"], want["round_records"])
        assert got["staleness"]["retransmissions"] > 0
    else:
        _close_records(got["round_records"], want["round_records"], FLIP_RTOL)
        assert got["total_sim_time_s"] > 0 and got["total_bytes"] > 0
    np.testing.assert_allclose(got["acc_per_round"], want["acc_per_round"], atol=1e-6)
    assert got["quorum_noops"] == want["quorum_noops"]
    assert got["fused_engine"] is want["fused_engine"] is False
    eng = pftt.run_pftt(pftt.PFTTConfig(device="cpu", **kw), init=init)
    np.testing.assert_equal(eng["round_records"], got["round_records"])
    np.testing.assert_allclose(eng["acc_per_round"], got["acc_per_round"], atol=1e-6)
    assert eng["staleness"] == got["staleness"]
