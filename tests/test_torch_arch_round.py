"""The port's universal arch round (``repro_torch.core.arch_round``) against
the JAX package's ``run_arch_round``, and the launcher's arch branch.

JAX's test size (2 clients, 1 round, 2 local steps, batch 3 ragged, seq 12,
d_model 32), f32 on the CPU.  The port starts from the JAX package's draws
(``PRNGKey(0)`` params, ``fold_in(key, 100 + ci)`` factors) and replays the
same numpy batch draws, so the two rounds see the same numbers.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

import repro.core.arch_round as jar
from repro import trees as jtrees
from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models import peft as jpeft
from repro.sharding import MeshCtx
from repro_torch import bridge
from repro_torch.core import arch_round
from repro_torch.launch import train
from repro_torch.sharding import ClientMesh

ARCHS = ("gpt2-small", "llama3.2-1b", "gemma3-12b", "internvl2-26b", "dbrx-132b",
         "jamba-v0.1-52b", "mamba2-1.3b", "deepseek-v2-236b", "whisper-base")
KW = dict(n_clients=2, rounds=1, local_steps=2, batch=3, seq_len=12, d_model=32)
LOSS_TOL = 1e-5
FACTOR_TOL = 1e-5
# AdamW moves an element by lr·m̂/(√v̂ + eps), eps 1e-8: at a gradient of
# about eps a rounding-level difference between the two packages' sums (a
# near-cancelled gradient) moves the element by up to lr a step.  Elements
# where some client's gradient at some step lies in (0, G_TINY) are held to
# AdamW's largest move instead, 2·lr a step, and counted.
G_TINY = 1e-7


def _export_init(arch):
    """The JAX package's draws of ``run_arch_round``: params and each
    client's factors, as flat numpy."""
    mcfg = jget_config(arch).reduced(d_model=KW["d_model"], repeats=1)
    key = jax.random.PRNGKey(0)
    params = JModel(mcfg, meshctx=MeshCtx.single_device()).init(key, max_seq=KW["seq_len"])
    pc = jpeft.PEFTConfig(lora_rank=4, lora_alpha=8.0,
                          lora_targets=jar.arch_lora_targets(mcfg))
    flat = lambda t: {k: np.asarray(v) for k, v in jtrees.flatten(t).items()}  # noqa: E731
    return {"params": flat(params),
            "lora": [flat(jpeft.init_lora(jax.random.fold_in(key, 100 + ci), params, pc))
                     for ci in range(KW["n_clients"])]}


def _jax_round(arch, monkeypatch):
    """JAX's ``run_arch_round`` and the global factors its last round step
    broadcast (read from the round step ``build_supervised_round`` built)."""
    got = {}
    build = jar.build_supervised_round

    def capture(*a, **k):
        step = build(*a, **k)

        def round_step(*args):
            out = step(*args)
            got["cohort"] = out[0]
            return out
        return round_step

    monkeypatch.setattr(jar, "build_supervised_round", capture)
    res = jar.run_arch_round(jar.ArchRoundConfig(arch=arch, **KW))
    monkeypatch.undo()
    return res, {k: np.asarray(v)[0] for k, v in jtrees.flatten(got["cohort"]).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_round_matches_jax(arch, monkeypatch):
    """Per-round losses within 1e-5 of JAX's; the global factors after the
    round within 1e-5 of JAX's (AdamW's tiny-gradient elements within its
    largest move, at most 2 % of them); the port's own dense-merge oracle
    within 1e-5; no dense merge in the engine, one round step a round."""
    want, jglobal = _jax_round(arch, monkeypatch)
    grads = []
    vag = arch_round.value_and_grad

    def recording(fn, tree):
        loss, g = vag(fn, tree)
        grads.append(bridge.to_numpy(g))
        return loss, g

    monkeypatch.setattr(arch_round, "value_and_grad", recording)
    got = arch_round.run_arch_round(
        arch_round.ArchRoundConfig(arch=arch, device="cpu", oracle=True, **KW),
        init=_export_init(arch))
    assert got["lora_targets"] == want["lora_targets"]
    assert got["ragged"] and got["dispatches_per_round"] == 1.0
    assert got["dense_merges_in_engine"] == 0 == want["dense_merges_in_engine"]
    np.testing.assert_allclose(got["loss_per_round"], want["loss_per_round"],
                               atol=LOSS_TOL, rtol=0)
    assert got["oracle_loss_max_err"] <= 1e-5
    # the engine's steps come first (the oracle's follow): clients × steps
    engine = grads[:KW["n_clients"] * KW["local_steps"]]
    tglobal = bridge.to_numpy(got["global_lora"])
    assert set(tglobal) == set(jglobal)
    lr, n_tiny, n_all = 1e-3, 0, 0
    for path, want_v in jglobal.items():
        tiny = np.zeros(want_v.shape, bool)
        for g in engine:
            if path in g:
                a = np.abs(g[path])
                tiny |= (a > 0) & (a < G_TINY)
        err = np.abs(tglobal[path] - want_v)
        assert (err[~tiny] <= FACTOR_TOL).all(), (path, err[~tiny].max())
        assert (err[tiny] <= 2 * lr * KW["local_steps"]).all(), path
        n_tiny += int(tiny.sum())
        n_all += tiny.size
    assert n_tiny <= 0.02 * n_all, (n_tiny, n_all)


def test_arch_round_launcher_and_refusals():
    """``--fl-clients`` with a non-roberta arch runs the arch round and
    ``--assert-fused`` passes on the CPU, deepseek-v2 (MLA) and whisper
    (encoder-decoder) included; a mesh without a process group raises;
    ``--population``
    with another arch keeps the JAX launcher's SystemExit."""
    res = train.main(["--arch", "llama3.2-1b", "--fl-clients", "2", "--fl-rounds", "1",
                      "--assert-fused", "--device", "cpu"])
    assert res["dense_merges_in_engine"] == 0 and res["oracle_loss_max_err"] <= 1e-5
    args = train.parse_args(["--arch", "gemma3-12b", "--fl-clients", "4", "--batch", "8",
                             "--fl-seq", "24", "--fl-dmodel", "256", "--device", "cpu"])
    cfg = train.arch_round_config(args)
    assert (cfg.batch, cfg.seq_len, cfg.d_model, cfg.n_clients, cfg.oracle) == (
        4, 24, 256, 4, False)
    cfg = arch_round.ArchRoundConfig(arch="llama3.2-1b", device="cpu", **KW)
    with pytest.raises(RuntimeError, match="not initialised"):
        arch_round.run_arch_round(cfg, mesh=ClientMesh(("data",), (2,)))
    for arch in ("deepseek-v2-236b", "whisper-base"):
        res = train.main(["--arch", arch, "--fl-clients", "2", "--fl-rounds", "1",
                          "--assert-fused", "--device", "cpu"])
        assert res["dense_merges_in_engine"] == 0 and res["oracle_loss_max_err"] <= 1e-5
    with pytest.raises(SystemExit, match="roberta-base"):
        train.parse_args(["--arch", "llama3.2-1b", "--population", "8"])


def test_arch_lora_targets_match_jax():
    """The target table and its first-seen order, for every config."""
    from repro.configs import list_configs
    from repro_torch.configs import get_config
    assert arch_round.MIXER_TARGETS == jar.MIXER_TARGETS
    for name in list_configs():
        assert arch_round.arch_lora_targets(get_config(name)) == \
            jar.arch_lora_targets(jget_config(name))


def test_round_batches_replay_jax_draws():
    """``_draw_round_batches`` and ``_fold_valid`` equal the JAX package's
    on the same ``RandomState`` (internvl2's patches included)."""
    from repro_torch.configs import get_config
    for arch in ("internvl2-26b", "llama3.2-1b"):
        mcfg = get_config(arch).reduced(d_model=32)
        a = arch_round._draw_round_batches(mcfg, np.random.RandomState(3), [3, 2], 2, 12)
        b = jar._draw_round_batches(jget_config(arch).reduced(d_model=32),
                                    np.random.RandomState(3), [3, 2], 2, 12)
        for ca, cb in zip(a, b):
            for sa, sb in zip(ca, cb):
                assert sa.keys() == sb.keys()
                for k in sa:
                    np.testing.assert_array_equal(sa[k], sb[k])
    batch = {"mask": torch.ones(3, 4), "valid": torch.tensor([1.0, 1.0, 0.0])}
    folded = arch_round._fold_valid(batch)
    assert "valid" not in folded and folded["mask"][2].sum() == 0
