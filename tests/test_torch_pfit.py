"""``run_pfit`` (the port's PFIT engine path, paper §IV-C and Fig. 4)
against the JAX package's ``run_pfit``, on the CPU, from the JAX package's
own draws: the policy before pretraining, both reward models before
training, each client's kept heads, each shepherd client's LoRA, and the
Gumbel noise of every sampling stream (``jax.random.gumbel`` under each
stream's key, as ``jax.random.categorical`` draws it).  Settings are
``tests/test_cohort_engine.py``'s PFIT ones (2 clients, batch 4, d 48,
2 layers, gen 8, prompt 6, 15 + 15 steps).  Gates: the reward per round
within 1e-3 (the JAX package's own engine-vs-loop tolerance), every
round's bytes and delay exactly equal, the reward models' pair accuracy
equal.  Held against the unsharded JAX engine only."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro import trees as jtrees
from repro.configs import get_config as jget_config
from repro.core import pfit as jpfit
from repro.models import Model as JModel
from repro.models import peft as jpeft
from repro.rlhf import reward_model as jrm
from repro_torch.core import pfit
from repro_torch.launch import pfit as launch_pfit
from repro_torch.fl import PopulationConfig
from repro_torch.sharding import ClientMesh
from repro_torch.wireless import DeadlineConfig, FaultPlan

KW = dict(n_clients=2, rounds=2, rollout_batch=4, pretrain_steps=15, rm_steps=15,
          d_model=48, n_layers=2, gen_len=8, prompt_len=6, seed=0)
ROUNDS = {"pfit": 2, "shepherd": 2, "sfl": 1, "pfl": 1}


def _np(tree):
    return {k: np.asarray(v) for k, v in jtrees.flatten(tree).items()}


def _export_init(cfg):
    """The JAX package's draws for ``run_pfit`` (its keys: the policy from
    PRNGKey(seed), the reward models from fold_in 11 and 12, the kept heads
    from PRNGKey(seed + ci), shepherd's LoRA from fold_in 200 + ci, the
    sampling noise of stream s from fold_in s)."""
    key = jax.random.PRNGKey(cfg.seed)
    mcfg = jget_config("gpt2-small").reduced(d_model=cfg.d_model, repeats=cfg.n_layers)
    params = JModel(mcfg).init(key)
    out = {"policy": _np(params),
           "rm_help": _np(jrm.RewardModel.create(jax.random.fold_in(key, 11)).params),
           "rm_safe": _np(jrm.RewardModel.create(jax.random.fold_in(key, 12)).params)}
    h = mcfg.n_heads
    n_keep = max(1, int(round(h * (1.0 - jpfit._method_settings(cfg)["sparsity"]))))
    out["keep"] = [np.asarray(jax.random.permutation(jax.random.PRNGKey(cfg.seed + ci),
                                                     h)[:n_keep])
                   for ci in range(cfg.n_clients)]
    if cfg.method == "shepherd":
        params["value_head"] = jnp.zeros((mcfg.d_model, 1), jnp.float32)
        pc = jpeft.PEFTConfig(lora_rank=cfg.lora_rank, lora_targets=("mixer/wq", "mixer/wv"))
        out["lora"] = [_np(jpeft.init_lora(jax.random.fold_in(key, 200 + ci), params, pc))
                       for ci in range(cfg.n_clients)]

    def noise(stream, batch):
        keys = jax.random.split(jax.random.fold_in(key, stream), cfg.gen_len)
        draws = [torch.tensor(np.asarray(jax.random.gumbel(k, (batch, mcfg.vocab_size),
                                                           jnp.float32)))
                 for k in keys]
        return lambda step: draws[step]

    out["noise"] = noise
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """Each method's JAX ``run_pfit``, run once for the module."""
    return functools.lru_cache(maxsize=None)(
        lambda m: jpfit.run_pfit(jpfit.PFITConfig(method=m, **dict(KW, rounds=ROUNDS[m]))))


@pytest.mark.parametrize("method", pfit.METHODS)
def test_run_pfit_matches_jax(jax_runs, method):
    """``pfit`` and ``shepherd`` over 2 rounds, ``sfl`` and ``pfl`` over
    one: the reward per round within 1e-3, every round's bytes and delay
    exactly equal, the pair accuracies equal, the JAX result keys all
    present."""
    want = jax_runs(method)
    jcfg = jpfit.PFITConfig(method=method, **dict(KW, rounds=ROUNDS[method]))
    got = pfit.run_pfit(pfit.PFITConfig(method=method, device="cpu",
                                        **dict(KW, rounds=ROUNDS[method])),
                        init=_export_init(jcfg))
    assert set(want) <= set(got)
    np.testing.assert_allclose(got["reward_per_round"], want["reward_per_round"], atol=1e-3)
    assert got["rm_pair_acc"] == want["rm_pair_acc"]
    for k in ("mean_round_bytes", "mean_round_delay_s", "total_bytes", "total_energy_j",
              "total_sim_time_s", "quorum_noops", "uplink_codec", "method"):
        assert got[k] == want[k], k
    assert len(got["round_records"]) == ROUNDS[method]
    assert len(got["round_s"]) == ROUNDS[method] and got["pretrain_s"] > 0
    n_eval = (2 * KW["rollout_batch"], KW["prompt_len"] + KW["gen_len"])
    assert [e["tokens"].shape for e in got["eval_round0"]] == [n_eval] * KW["n_clients"]
    assert len(got["rollouts_round0"]) == (0 if method == "shepherd" else KW["n_clients"])


def test_launcher_runs_on_cpu_and_refuses_without_gpu(monkeypatch, capsys):
    """``python -m repro_torch.launch.pfit --rounds 2 --clients 2 --device
    cpu`` (its pretraining and reward-model steps cut to 10 here: the
    command itself takes about 30 s) exits with a result; without
    ``--device cpu`` and with no GPU it raises."""
    monkeypatch.setattr(launch_pfit, "PFITConfig",
                        functools.partial(pfit.PFITConfig, pretrain_steps=10, rm_steps=10))
    res = launch_pfit.main(["--rounds", "2", "--clients", "2", "--device", "cpu"])
    assert len(res["reward_per_round"]) == 2 and np.isfinite(res["final_reward"])
    assert "reward curve:" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch_pfit.main(["--rounds", "1"])


def _pop():
    from repro_torch.fl import PopulationConfig
    return PopulationConfig(population=8, cohort_size=2)


@pytest.mark.parametrize("option, err, match", [
    (dict(uplink_codec="int8", population=_pop()), ValueError, "shepherd"),
    (dict(method="sfl", factored_agg=True, population=_pop()), ValueError, "shepherd"),
    (dict(method="shepherd", population=_pop(), engine=False), ValueError, "engine"),
    (dict(method="pfl", population=_pop()), ValueError, "shepherd")])
def test_unported_options_name_their_item(option, err, match):
    """Population mode raises the JAX package's own errors for the PPO
    methods and the loop (the loop itself runs: test_torch_oracles_pfit*)."""
    with pytest.raises(err, match=match):
        pfit.run_pfit(pfit.PFITConfig(device="cpu", **option))


@pytest.mark.parametrize("option", [
    dict(fault_plan=FaultPlan(dropout_p=0.5, seed=1), max_staleness=1),
    dict(deadline=DeadlineConfig(deadline_s=1.0, min_quorum=1))], ids=["fault_plan", "deadline"])
def test_robust_options_run(option):
    """The robust round's options run (one round, pretraining and reward
    models cut to 2 steps): the result carries the tracker's counters, and
    a deadline round its simulated time."""
    res = pfit.run_pfit(pfit.PFITConfig(device="cpu", **dict(
        KW, rounds=1, pretrain_steps=2, rm_steps=2), **option))
    assert np.isfinite(res["final_reward"]) and set(res["staleness"]) == {
        "pending", "abandoned", "retransmissions", "quorum_noops"}
    assert (res["total_sim_time_s"] > 0) == ("deadline" in option)


def test_mesh_is_refused():
    """A mesh whose process group is not initialised raises before any work
    (no fallback to world size 1)."""
    for kw in ({}, {"population": PopulationConfig(population=8, cohort_size=2)}):
        with pytest.raises(RuntimeError, match="not initialised"):
            pfit.run_pfit(pfit.PFITConfig(device="cpu", method="shepherd", **kw),
                          mesh=ClientMesh(("data",), (2,)))
