"""The compressed uplink through the port's runners, against the JAX
package, on the CPU, with JAX's codec uniforms (its key chain
``PRNGKey(seed)`` → ``fold_in 0x0C0DEC`` → round → client → leaf) and
count-sketch hashes injected:

* ``run_pftt`` (fedlora, 3 clients, 2 rounds) for every codec, and int4
  with ``factored_agg`` in a robust deadline run: every ledger record equal
  but its floats (bytes from the realized bits, delays, energies, rates),
  within 1e-6 relative under the sketches and within ``FLIP_RTOL`` under
  the quantizers (see ``FLIP_RTOL``); accuracies within 1e-6;
* the launcher's ``--uplink-codec int4 --factored-agg`` and pfit's PPO
  codec under a deadline run (no JAX reference: a
  smoke check of the paths);
* kill and resume with a codec, bit for bit on one CPU thread, and the
  checkpoint pair: a kill between the npz and its JSON sidecar resumes to
  the uninterrupted run.

Widths are ``test_torch_fl.py``'s."""
import functools
import os

import jax
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_comms import jax_hashes, jax_noise
from test_torch_fl import PFTT_KW
from test_torch_fl import _export_init as pftt_init
from test_torch_pfit import KW as PFIT_KW
from test_torch_robust_runs import DL_MERGE, MIX

from repro.core import pftt as jpftt
from repro.wireless import arrivals as jarrivals
from repro.wireless import faults as jfaults
from repro_torch.core import pfit, pftt
from repro_torch.launch import train
from repro_torch.wireless import DeadlineConfig, FaultPlan

BITS_RTOL = 1e-6
# A quantizer's symbol is floor(x/scale + u): where x/scale + u lies within
# the two packages' f32 training difference (~1e-8 after AdamW steps) of an
# integer, the symbols are one step apart.  Each such flip moves a client's
# entropy charge n·H by at most log2(n) + 2 bits (about 13 bits at these
# uploads' ~3k coded elements, 5e-4 of their ~7–28k bits) and its decoded
# value by one scale step.  A run's bits under a quantizer are held within
# 1e-3 (two flips a client-round); one round from identical state holds
# 1e-6 (``test_torch_comms_rounds.py``).
FLIP_RTOL = 1e-3


def jax_codec_noise(seed):
    """``codec_noise(round, client, leaf, shape)`` with the JAX runners'
    uniforms."""
    base = jax.random.fold_in(jax.random.PRNGKey(seed), 0x0C0DEC)
    return lambda rnd, ci, leaf, shape: jax_noise(
        jax.random.fold_in(jax.random.fold_in(base, rnd), ci))(leaf, shape)


# --------------------------------------------------------------- run_pftt
def _close_records(got, want, rtol):
    """Ledger records equal, but floats (bits-derived bytes, delays,
    energies) within ``rtol``; NaN delays equal."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _close_records(got[k], want[k], rtol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close_records(a, b, rtol)
    elif isinstance(want, (bool, np.bool_, str)) or want is None:
        assert got == want
    else:
        np.testing.assert_allclose(float(got), float(want), rtol=rtol)


PFTT_CODEC_KW = dict(PFTT_KW, method="fedlora")
RUN_CASES = {c: dict(uplink_codec=c) for c in ("int8", "int4", "sketch", "countsketch")}
# factored aggregation inside the robust deadline run: one JAX run for both
RUN_CASES["int4_factored_mix_dl"] = dict(uplink_codec="int4", factored_agg=True,
                                         staleness_a=0.5, max_staleness=3)


def _robust_kw(case, jax_side):
    if not case.endswith("mix_dl"):
        return {}
    fp, dc = (jfaults.FaultPlan, jarrivals.DeadlineConfig) if jax_side else (FaultPlan,
                                                                           DeadlineConfig)
    return dict(fault_plan=fp(**MIX), deadline=dc(**DL_MERGE))


def _port_init(jcfg):
    init = pftt_init(jcfg)
    init.update(codec_noise=jax_codec_noise(jcfg.seed), cs_hashes=jax_hashes)
    return init


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_run_pftt_with_codec_matches_jax(case):
    """``run_pftt`` (fedlora) from the JAX init with JAX's uniforms and
    hashes: every round record equal but its floats (the bytes are the
    engine's realized bits / 8; module note), accuracies within 1e-6; the
    int4 deadline run with ``factored_agg`` (MIX, a merging deadline)
    schedules its first uploads at ``payload_bits_upper_bound`` and then
    at the realized sizes, as JAX does."""
    kw = dict(PFTT_CODEC_KW, **RUN_CASES[case])
    jcfg = jpftt.PFTTConfig(**kw, **_robust_kw(case, True))
    want = jpftt.run_pftt(jcfg)
    got = pftt.run_pftt(pftt.PFTTConfig(device="cpu", **kw, **_robust_kw(case, False)),
                        init=_port_init(jcfg))
    rtol = FLIP_RTOL if kw["uplink_codec"].startswith("int") else BITS_RTOL
    _close_records(got["round_records"], want["round_records"], rtol)
    np.testing.assert_allclose(got["acc_per_round"], want["acc_per_round"], atol=1e-6)
    for k in ("total_bytes", "total_energy_j", "mean_round_delay_s", "total_sim_time_s"):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    assert got["uplink_codec"] == want["uplink_codec"] == kw["uplink_codec"]
    assert got["quorum_noops"] == want["quorum_noops"] and got["total_bytes"] > 0


# --------------------------------------------------------------- entry points
def test_launcher_and_pfit_run_with_codec(monkeypatch, capsys):
    """``python -m repro_torch.launch.train --arch roberta-base --fl-clients 2
    --fl-rounds 1 --uplink-codec int4 --factored-agg --device cpu`` (its
    pretraining cut to 5 steps here) charges each client under its
    ``payload_bits_upper_bound`` and that under a quarter of the raw upload;
    pfit (PPO) with int4 under a deadline runs (its first uploads scheduled
    at ``payload_bits_upper_bound``) and charges fewer bytes than the same
    run uncompressed."""
    monkeypatch.setattr(train, "pftt_config", functools.partial(train.pftt_config,
                                                                pretrain_steps=5))
    coded = train.main(["--arch", "roberta-base", "--fl-clients", "2", "--fl-rounds", "1",
                        "--device", "cpu", "--uplink-codec", "int4", "--factored-agg"])
    assert coded["uplink_codec"] == "int4" and "(codec=int4)" in capsys.readouterr().out
    bits = coded["uplink_bits"]
    assert 0 < max(bits["realized"][0]) <= min(bits["upper_bound"]) < 0.25 * min(bits["raw"])
    kw = dict(PFIT_KW, rounds=2, pretrain_steps=2, rm_steps=2,
              deadline=DeadlineConfig(deadline_s=1.0, min_quorum=1))
    res = pfit.run_pfit(pfit.PFITConfig(method="pfit", device="cpu", uplink_codec="int4", **kw))
    raw = pfit.run_pfit(pfit.PFITConfig(method="pfit", device="cpu", **kw))
    assert np.isfinite(res["final_reward"]) and res["total_sim_time_s"] > 0
    assert 0 < res["total_bytes"] < raw["total_bytes"]


# --------------------------------------------------------------- resume
RESUME_KW = dict(PFTT_CODEC_KW, uplink_codec="int4", factored_agg=True, rounds=4,
                 staleness_a=0.5, max_staleness=3)


def _resume_run(ckpt_dir, **kw):
    return pftt.run_pftt(pftt.PFTTConfig(device="cpu", **dict(RESUME_KW, **kw),
                                         fault_plan=FaultPlan(**MIX),
                                         deadline=DeadlineConfig(**DL_MERGE),
                                         ckpt_dir=ckpt_dir),
                         init=pftt_init(jpftt.PFTTConfig(**PFTT_CODEC_KW)))


def _assert_same_run(resumed, full, full_dir, cut_dir):
    for k in ("acc_per_round", "loss_per_round", "staleness", "total_bytes",
              "total_sim_time_s", "quorum_noops"):
        assert resumed[k] == full[k], k
    np.testing.assert_equal(resumed["round_records"], full["round_records"])
    with np.load(os.path.join(full_dir, "pftt_fedlora.npz")) as a, \
            np.load(os.path.join(cut_dir, "pftt_fedlora.npz")) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_kill_and_resume_with_codec_is_bitwise(tmp_path):
    """int4 with ``factored_agg`` under MIX and a merging deadline, on one
    thread (threaded CPU GEMMs differ near 1e-7 from run to run): killed
    after 2 of 4 rounds and resumed from the checkpoint, the run (its
    uniforms, the scheduling sizes it rolled forward, every record and the
    final state) is bit for bit the uninterrupted one."""
    full_dir, cut_dir = str(tmp_path / "full"), str(tmp_path / "cut")
    full = _resume_run(full_dir)
    _resume_run(cut_dir, rounds=2)                                     # "killed" here
    resumed = _resume_run(cut_dir, resume=True)
    assert len(resumed["round_s"]) == 2
    _assert_same_run(resumed, full, full_dir, cut_dir)


def test_kill_between_npz_and_sidecar_resumes_exactly(tmp_path, monkeypatch):
    """A kill after round 2's npz but before its JSON sidecar: the npz holds
    its own host state, so the resumed run equals the uninterrupted one (a
    resume from the stale sidecar would replay round 2 over a state that
    already holds it)."""
    full_dir, cut_dir = str(tmp_path / "full"), str(tmp_path / "cut")
    full = _resume_run(full_dir)
    real = pftt.save_json

    def dying(path, meta):
        if meta["next_round"] == 2:
            raise KeyboardInterrupt             # killed between the two writes
        real(path, meta)

    monkeypatch.setattr(pftt, "save_json", dying)
    with pytest.raises(KeyboardInterrupt):
        _resume_run(cut_dir)
    monkeypatch.setattr(pftt, "save_json", real)
    with open(os.path.join(cut_dir, "pftt_fedlora.json")) as f:
        assert '"next_round": 1' in f.read()          # the sidecar is a round behind
    resumed = _resume_run(cut_dir, resume=True)
    assert len(resumed["round_s"]) == 2
    _assert_same_run(resumed, full, full_dir, cut_dir)
