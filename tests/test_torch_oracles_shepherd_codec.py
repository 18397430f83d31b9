"""PFIT's shepherd baseline through the legacy per-client loop with the
int8 uplink codec against the JAX package's loop, on the CPU, from the JAX
package's draws and codec uniforms (``test_torch_pfit.py``'s ``KW``): each
client's LoRA coded against its round-input value, the server averaging
the decodes.  Gates: the reward per round within 1e-3; bytes and delays
within ``FLIP_RTOL`` (``test_torch_comms_runs.py``'s bound for the
quantizer's one-step symbol flips)."""
import numpy as np
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_comms_runs import FLIP_RTOL, jax_codec_noise
from test_torch_pfit import KW, _export_init

from repro.core import pfit as jpfit
from repro_torch.core import pfit


def test_shepherd_int8_loop_matches_jax_loop():
    kw = dict(KW, method="shepherd", uplink_codec="int8")
    want = jpfit.run_pfit(jpfit.PFITConfig(engine=False, **kw))
    init = dict(_export_init(jpfit.PFITConfig(**kw)), codec_noise=jax_codec_noise(KW["seed"]))
    got = pfit.run_pfit(pfit.PFITConfig(engine=False, device="cpu", **kw), init=init)
    assert got["fused_engine"] is False and got["uplink_codec"] == want["uplink_codec"]
    np.testing.assert_allclose(got["reward_per_round"], want["reward_per_round"], atol=1e-3)
    for k in ("mean_round_bytes", "mean_round_delay_s", "total_bytes", "total_energy_j"):
        np.testing.assert_allclose(got[k], want[k], rtol=FLIP_RTOL, err_msg=k)
    assert got["quorum_noops"] == want["quorum_noops"] and got["total_bytes"] > 0
