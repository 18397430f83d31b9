"""The port's robust runners against the JAX package, on the CPU:
``run_pftt`` from the JAX-exported init under ``tests/test_faults.py``'s
``ROBUST_KW`` and under ``tests/test_deadline.py``'s ``MIX`` fault plan and
``DL`` deadline (and under a deadline whose quorum of 1 lets rounds merge),
``run_pfit`` (``pfit`` and ``shepherd``) under ``FAULTY`` from the JAX draws,
the launcher's robust flags, and checkpoint/resume.  Gates: every ledger
record equal, accuracies within 1e-6 (counts over a client's test set),
rewards within 1e-3 (``test_torch_pfit.py``'s); the zero plan bitwise the
synchronous engine; kill and resume bitwise the uninterrupted run; the
port's checkpoint loads in JAX's ``load_checkpoint`` under the same keys.
Widths are ``test_torch_fl.py``'s and ``test_torch_pfit.py``'s."""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_fl import PFTT_KW
from test_torch_fl import _export_init as pftt_init
from test_torch_pfit import KW as PFIT_KW
from test_torch_pfit import _export_init as pfit_init

from repro.checkpoint import ckpt as jckpt
from repro.core import pfit as jpfit
from repro.core import pftt as jpftt
from repro.wireless import arrivals as jarrivals
from repro.wireless import faults as jfaults
from repro_torch import trees
from repro_torch.checkpoint import ckpt, load_checkpoint, save_checkpoint
from repro_torch.core import pfit, pftt
from repro_torch.launch import train
from repro_torch.wireless import DeadlineConfig, FaultPlan

FAULTY = dict(dropout_p=0.3, straggle_p=0.3, max_straggle=2, crash_p=0.15, max_crash=2,
              snr_dip_p=0.25, seed=3)                                 # tests/test_faults.py
MIX = dict(dropout_p=0.25, straggle_p=0.3, max_straggle=2, crash_p=0.1, max_crash=1,
           snr_dip_p=0.2, corrupt_p=0.25, seed=5)                    # tests/test_deadline.py
DL = dict(deadline_s=0.05, backoff_base_s=0.01, max_retries=3, min_quorum=2,
          compute_mean_s=0.005, seed=11)                             # tests/test_deadline.py
# a deadline every delivery meets at these widths and a quorum of 1, so
# rounds merge, one is voided, and with no retry failed payloads are abandoned
DL_MERGE = dict(DL, deadline_s=0.2, max_retries=0, min_quorum=1)
CASES = {   # (fault plan, deadline, staleness_a, max_staleness)
    "faulty": (FAULTY, None, 0.5, 2),
    "mix_dl": (MIX, DL, 0.5, 3),
    "mix_dl_merge": (MIX, DL_MERGE, 0.5, 3),
}
PFTT_ROBUST = dict(PFTT_KW, rounds=3)


@pytest.fixture
def one_thread():
    """One CPU thread for the bitwise checks: the CPU's threaded GEMMs are
    not bitwise repeatable from run to run (two identical runs in one
    process differ near 1e-7 in a loss with 8 threads, never with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _robust_kw(case, jax_side):
    plan, dl, a, max_s = CASES[case]
    fp, dc = (jfaults.FaultPlan, jarrivals.DeadlineConfig) if jax_side else (FaultPlan,
                                                                           DeadlineConfig)
    return dict(fault_plan=fp(**plan), deadline=None if dl is None else dc(**dl),
                staleness_a=a, max_staleness=max_s)


@pytest.fixture(scope="module")
def jax_pftt(tmp_path_factory):
    """JAX's ``run_pftt`` for each case, once for the module; each writes
    its round checkpoints under ``<dir>/<case>``."""
    root = tmp_path_factory.mktemp("jax_ckpt")

    @functools.lru_cache(maxsize=None)
    def run(case):
        return jpftt.run_pftt(jpftt.PFTTConfig(**PFTT_ROBUST, **_robust_kw(case, True),
                                               ckpt_dir=str(root / case))), str(root / case)
    return run


def _port_pftt(case, **kw):
    return pftt.run_pftt(pftt.PFTTConfig(device="cpu", **dict(PFTT_ROBUST, **kw),
                                         **_robust_kw(case, False)),
                         init=pftt_init(jpftt.PFTTConfig(**PFTT_ROBUST)))


@pytest.mark.parametrize("case", list(CASES))
def test_run_pftt_robust_matches_jax(jax_pftt, case, tmp_path):
    """``run_pftt`` (method pftt, 3 clients, 3 rounds) from the JAX init:
    every round record (bytes, delays, energies, per-client reports, and in
    deadline mode the simulated time, quorum no-op, deliveries and
    corruptions) equal, accuracies within 1e-6.  Then the port's checkpoint
    of the last round loads in JAX's ``load_checkpoint`` under the same keys
    as JAX's own (the port's file also holds its host state, under
    ``ckpt.META_KEY``)."""
    want, jdir = jax_pftt(case)
    got = _port_pftt(case, ckpt_dir=str(tmp_path))
    np.testing.assert_equal(got["round_records"], want["round_records"])
    np.testing.assert_allclose(got["acc_per_round"], want["acc_per_round"], atol=1e-6)
    for k in ("total_bytes", "total_energy_j", "total_sim_time_s", "quorum_noops",
              "mean_round_delay_s"):
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k
    assert set(want) <= set(got)
    c = got["staleness"]
    if case == "faulty":
        assert c["retransmissions"] > 0
    else:
        assert got["total_sim_time_s"] > 0 and c["quorum_noops"] == got["quorum_noops"] > 0
    if case == "mix_dl_merge":
        assert got["total_bytes"] > 0 and c["abandoned"] > 0
    with np.load(os.path.join(jdir, "pftt_pftt.npz")) as theirs:
        template = trees.unflatten({k: np.asarray(v) for k, v in theirs.items()})
    port_file = os.path.join(str(tmp_path), "pftt_pftt.npz")
    loaded = jckpt.load_checkpoint(port_file, template)
    with np.load(port_file) as ours:   # and the port's host state beside them
        assert set(ours.files) == set(theirs.files) | {ckpt.META_KEY}
        for k, v in trees.flatten(loaded).items():
            np.testing.assert_array_equal(np.asarray(v), ours[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_pfit():
    return functools.lru_cache(maxsize=None)(lambda m: jpfit.run_pfit(jpfit.PFITConfig(
        method=m, **PFIT_KW, **_robust_kw("faulty", True))))


@pytest.mark.parametrize("method", ["pfit", "shepherd"])
def test_run_pfit_robust_matches_jax(jax_pfit, method):
    """``run_pfit`` under ``FAULTY`` for 2 rounds from the JAX draws: the
    reward per round within 1e-3 and the ledger's totals equal (JAX's result
    has no round records).  The plan's trace for 2 clients: nobody trains
    in round 0, client 1 trains and delivers in round 1."""
    want = jax_pfit(method)
    got = pfit.run_pfit(pfit.PFITConfig(method=method, device="cpu", **PFIT_KW,
                                        **_robust_kw("faulty", False)),
                        init=pfit_init(jpfit.PFITConfig(method=method, **PFIT_KW)))
    np.testing.assert_allclose(got["reward_per_round"], want["reward_per_round"], atol=1e-3)
    for k in ("total_bytes", "total_energy_j", "mean_round_delay_s", "total_sim_time_s",
              "quorum_noops", "mean_round_bytes"):
        assert got[k] == want[k], k
    assert got["total_bytes"] > 0 and got["round_records"][0]["bytes"] == 0
    if method == "pfit":
        assert got["train_reward_per_round"][0] == 0.0


def test_zero_plan_is_bitwise_sync(one_thread):
    """``FaultPlan()`` with discounting off (and any ``max_staleness``) is
    the synchronous engine bit for bit: accuracies, local losses and every
    round record."""
    init = pftt_init(jpftt.PFTTConfig(**PFTT_ROBUST))
    sync = pftt.run_pftt(pftt.PFTTConfig(device="cpu", **PFTT_ROBUST), init=init)
    zero = pftt.run_pftt(pftt.PFTTConfig(device="cpu", **PFTT_ROBUST, fault_plan=FaultPlan(),
                                         max_staleness=2), init=init)
    assert zero["acc_per_round"] == sync["acc_per_round"]
    assert zero["loss_per_round"] == sync["loss_per_round"]
    np.testing.assert_equal(zero["round_records"], sync["round_records"])
    assert sync["staleness"] is None and zero["staleness"]["retransmissions"] == 0


def test_kill_and_resume_is_bitwise(tmp_path, one_thread):
    """Kill after 2 of 4 rounds and resume from the checkpoint under the
    continuous-time round: accuracies, losses, every round record, the
    tracker's counters and the final checkpointed state (trainables,
    optimizer, pending buffer) bitwise the uninterrupted run's."""
    full_dir, cut_dir = str(tmp_path / "full"), str(tmp_path / "cut")
    full = _port_pftt("mix_dl_merge", rounds=4, ckpt_dir=full_dir)
    _port_pftt("mix_dl_merge", rounds=2, ckpt_dir=cut_dir)               # "killed" here
    resumed = _port_pftt("mix_dl_merge", rounds=4, ckpt_dir=cut_dir, resume=True)
    assert len(resumed["round_s"]) == 2
    for k in ("acc_per_round", "loss_per_round", "staleness", "total_bytes",
              "total_sim_time_s", "quorum_noops"):
        assert resumed[k] == full[k], k
    np.testing.assert_equal(resumed["round_records"], full["round_records"])
    with np.load(os.path.join(full_dir, "pftt_pftt.npz")) as a, \
            np.load(os.path.join(cut_dir, "pftt_pftt.npz")) as b:
        assert set(a.files) == set(b.files) and any(k.startswith("pending/") for k in a.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_checkpoint_atomic_and_strict(tmp_path, monkeypatch):
    """A kill during the write leaves the previous checkpoint and no tmp
    file; bf16 is stored as f32 and restored onto the template's dtype; a
    missing leaf or a shape mismatch raises."""
    path = str(tmp_path / "state.npz")
    tree = {"w": torch.arange(4, dtype=torch.float32), "h": [torch.ones(2, dtype=torch.bfloat16)]}
    save_checkpoint(path, tree)
    real_savez = np.savez

    def dying_savez(f, **arrays):       # a kill mid-serialization
        f.write(b"\x00garbage")
        raise KeyboardInterrupt

    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(path, {"w": torch.full((4,), 9.0), "h": [torch.zeros(2)]})
    monkeypatch.setattr(np, "savez", real_savez)
    assert os.listdir(tmp_path) == ["state.npz"]
    with np.load(path) as data:
        assert data["h/0"].dtype == np.float32
    back = load_checkpoint(path, tree)
    assert torch.equal(back["w"], tree["w"]) and back["h"][0].dtype == torch.bfloat16
    assert torch.equal(back["h"][0], tree["h"][0])
    with pytest.raises(KeyError, match="missing leaf x"):
        load_checkpoint(path, dict(tree, x=torch.zeros(1)))
    with pytest.raises(ValueError, match="shape mismatch at w"):
        load_checkpoint(path, dict(tree, w=torch.zeros(5)))


def test_train_launcher_robust_flags(tmp_path, monkeypatch, capsys, one_thread):
    """``launch/train.py`` with the robust flags on the CPU (pretraining cut
    to 5 steps here): the fault plan, staleness and deadline flags build the
    JAX launcher's ``DeadlineConfig``; ``--ckpt-dir`` then ``--resume`` carry
    a run on to more rounds, equal to the uninterrupted run."""
    monkeypatch.setattr(train, "pftt_config", functools.partial(train.pftt_config,
                                                                pretrain_steps=5))
    argv = ["--arch", "roberta-base", "--fl-clients", "2", "--fault-plan",
            "straggle_p=0.5,max_straggle=2,seed=2", "--staleness-a", "0.5",
            "--max-staleness", "2", "--device", "cpu"]
    args = train.parse_args(argv + ["--deadline-s", "0.5", "--min-quorum", "1",
                                    "--max-retries", "2", "--compute-time-s", "0.01"])
    cfg = train.pftt_config(args)
    assert cfg.fault_plan == FaultPlan(straggle_p=0.5, max_straggle=2, seed=2)
    assert dataclasses.asdict(cfg.deadline) == jarrivals.DeadlineConfig(
        deadline_s=0.5, min_quorum=1, max_retries=2, compute_mean_s=0.01).to_dict()
    assert train.pftt_config(train.parse_args(argv)).deadline is None
    assert train.pftt_config(train.parse_args(argv + ["--min-quorum", "1"])).deadline == \
        DeadlineConfig(min_quorum=1)
    ck = ["--ckpt-dir", str(tmp_path)]
    full = train.main(argv + ["--fl-rounds", "3", "--deadline-s", "0.5"])
    train.main(argv + ["--fl-rounds", "2", "--deadline-s", "0.5"] + ck)
    resumed = train.main(argv + ["--fl-rounds", "3", "--deadline-s", "0.5", "--resume"] + ck)
    assert resumed["acc_per_round"] == full["acc_per_round"]
    np.testing.assert_equal(resumed["round_records"], full["round_records"])
    assert "continuous-time round: sim time" in capsys.readouterr().out
