"""Generic per-architecture federated round — the port of
``repro.core.arch_round``, the config zoo's arch-matrix workload.

``run_arch_round`` runs a reduced FedLoRA-style cohort round on any
architecture (dense gpt2 and the llamas, gemma3's windowed layers, the
internvl2 VLM, MoE dbrx, deepseek-v2's MLA with MoE, the jamba hybrid,
mamba2, whisper's encoder-decoder): per-client rank-r LoRA
factor trees train through ``core/cohort.build_supervised_round`` — one
round step a round — against the shared frozen base, with FedAvg over the
factors and the broadcast back inside the step.  It shows the universal
factored path:

* the LoRA side channel stays factored through every mixer family
  (``peft.dense_merge_count()`` does not move while the engine runs);
* ragged cohorts (unequal per-client batch sizes, the default) run as one
  round step over ``HostBatchStacker``'s padded batches (the ``"valid"``
  sample weights fold into the LM token mask);
* ``oracle=True`` replays the identical padded batches through the
  per-client dense-merge loop (``peft.apply_lora`` each step) and reports
  the largest per-(round, client, step) loss deviation.

``mesh`` (a ``sharding.ClientMesh``) shards the client axis over the ranks
of its process group, ghost-padding a cohort that does not divide them;
every rank draws every batch, runs its rows, and gathers the losses.
``init`` takes the JAX package's draws for parity runs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import bridge, resolve_device, synchronize, trees
from repro_torch.configs import get_config
from repro_torch.core.aggregation import fedavg_stacked
from repro_torch.core.cohort import HostBatchStacker, build_supervised_round
from repro_torch.models import peft as peft_mod
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw, value_and_grad
from repro_torch.sharding import cohort_sharding

# which mixer projections carry LoRA per layer family — the universal
# factored contract (models/ssm.py, models/mla.py, blocks._qkv)
MIXER_TARGETS = {
    "attn": ("mixer/wq", "mixer/wv"),
    "local": ("mixer/wq", "mixer/wv"),
    "enc": ("mixer/wq", "mixer/wv"),
    "dec": ("mixer/wq", "mixer/wv"),
    "mla": ("mixer/wq_a", "mixer/wq_b", "mixer/wkv_a", "mixer/wkv_b"),
    "mamba": ("mixer/in_proj", "mixer/out_proj"),
}


def arch_lora_targets(mcfg) -> tuple:
    """LoRA target paths covering every mixer family in the config's stage
    patterns, in first-seen order."""
    targets = []
    for stage in mcfg.stages:
        for kind in stage.pattern:
            for t in MIXER_TARGETS.get(kind.mixer, ()):
                if t not in targets:
                    targets.append(t)
    return tuple(targets)


@dataclasses.dataclass(frozen=True)
class ArchRoundConfig:
    arch: str
    n_clients: int = 4
    rounds: int = 2
    local_steps: int = 2
    batch: int = 4
    seq_len: int = 16
    d_model: int = 64
    repeats: int = 1
    lora_rank: int = 4
    lr: float = 1e-3
    seed: int = 0
    ragged: bool = True    # vary per-client batch size (pad-and-mask path)
    oracle: bool = False   # replay the dense-merge loop, report parity
    device: str = "cuda"


def _draw_round_batches(mcfg, rng, sizes, local_steps, seq_len):
    """[client][step] host LM batches; the sample axis is ragged when
    ``sizes`` differ (the stacker pads and masks).  The same draws from
    ``rng`` (a numpy ``RandomState``) as the JAX package."""
    out = []
    for b in sizes:
        steps = []
        for _ in range(local_steps):
            toks = rng.randint(6, mcfg.vocab_size, size=(b, seq_len + 1))
            batch = {"tokens": toks[:, :-1].astype(np.int32),
                     "labels": toks[:, 1:].astype(np.int32),
                     "mask": np.ones((b, seq_len), np.float32)}
            if mcfg.is_encoder_decoder:
                batch["frames"] = rng.randn(
                    b, mcfg.encoder_seq, mcfg.d_model).astype(np.float32)
            if mcfg.n_prefix_tokens:
                batch["patches"] = rng.randn(
                    b, mcfg.n_prefix_tokens, mcfg.prefix_dim).astype(np.float32)
            steps.append(batch)
        out.append(steps)
    return out


def _fold_valid(batch):
    """Padded-row sample weights → the LM token mask (exact: padded rows
    then weigh zero in lm_loss's tot/cnt)."""
    b = dict(batch)
    v = b.pop("valid", None)
    if v is not None:
        b["mask"] = b["mask"] * v[:, None]
    return b


def run_arch_round(cfg: ArchRoundConfig, mesh=None, client_axes=None,
                   init: Optional[Dict] = None) -> Dict:
    """Run the factored cohort round for one architecture; see the module
    docstring.  ``init`` (parity runs): {"params": flat numpy params,
    "lora": [flat numpy LoRA tree per client]}, the JAX package's
    ``PRNGKey(seed)`` and ``fold_in(key, 100 + ci)`` draws; without it the
    base and factors are drawn from torch generators seeded with ``seed``
    and 100 + ci.  Beside the JAX package's keys the result has
    ``round_s``, each round step's seconds (ending in a synchronize), and
    ``global_lora``, the aggregated factors.  ``mesh`` (+ ``client_axes``):
    the cohort sharded over the mesh's ranks; the oracle then replays the
    real clients on every rank."""
    cs = cohort_sharding(mesh, cfg.n_clients, client_axes)   # this process's rows
    device = resolve_device(cfg.device)
    mcfg = get_config(cfg.arch).reduced(d_model=cfg.d_model, repeats=cfg.repeats)
    model = Model(mcfg, device=device)
    targets = arch_lora_targets(mcfg)
    pc = peft_mod.PEFTConfig(lora_rank=cfg.lora_rank, lora_alpha=2.0 * cfg.lora_rank,
                             lora_targets=targets)
    scale = peft_mod.lora_scale(pc)
    if init is not None:
        params = bridge.params_from_numpy(init["params"], mcfg, device=device)
        loras = [bridge.lora_from_numpy(flat, mcfg, device=device)
                 for flat in init["lora"]]
    else:
        params = model.init(torch.Generator().manual_seed(cfg.seed), max_seq=cfg.seq_len)
        loras = [peft_mod.init_lora(torch.Generator().manual_seed(100 + ci), params, pc)
                 for ci in range(cfg.n_clients)]
    opt = adamw(cfg.lr, update_mask=lambda p: not p.endswith("/mask"))

    def local_step(lora, opt_state, batch):
        loss, g = value_and_grad(
            lambda lf: model.lm_loss(params, _fold_valid(batch), lora=lf,
                                     lora_scale=scale), lora)
        upd, opt_state = opt.update(g, opt_state, lora)
        return trees.tree_add(lora, upd), opt_state, loss

    round_step = build_supervised_round(local_step, None, cs=cs)
    cohort = cs.take(trees.stack(loras))
    cohort_opt = cs.take(trees.stack([opt.init(lf) for lf in loras]))
    stacker = HostBatchStacker(device, rows=cs.rows)

    rng = np.random.RandomState(cfg.seed)
    sizes = ([max(1, cfg.batch - (ci % 2)) for ci in range(cfg.n_clients)]
             if cfg.ragged and cfg.n_clients > 1 else [cfg.batch] * cfg.n_clients)
    round_batches = [_draw_round_batches(mcfg, rng, sizes, cfg.local_steps, cfg.seq_len)
                     for _ in range(cfg.rounds)]
    weights = torch.from_numpy(cs.take_vec(np.ones(cfg.n_clients))).to(device)

    eng_losses, padded_rounds, round_s = [], [], []
    dispatches = merges_in_engine = 0
    for rnd in range(cfg.rounds):
        batches = stacker(cs.pad(round_batches[rnd]))
        if cfg.oracle:   # the real clients' padded batches, every rank
            padded_rounds.append(batches if mesh is None
                                 else HostBatchStacker(device)(round_batches[rnd]))
        m0 = peft_mod.dense_merge_count()
        synchronize(device)
        t0 = time.perf_counter()
        cohort, cohort_opt, losses = round_step(cohort, cohort_opt, batches, weights)
        synchronize(device)
        round_s.append(time.perf_counter() - t0)
        merges_in_engine += peft_mod.dense_merge_count() - m0
        dispatches += 1
        eng_losses.append(cs.gather(losses).cpu().numpy())

    result = {
        "arch": cfg.arch,
        "lora_targets": list(targets),
        "ragged": len(set(sizes)) > 1,
        "n_ghosts": cs.n_pad,
        "dispatches_per_round": dispatches / max(cfg.rounds, 1),
        "dense_merges_in_engine": int(merges_in_engine),
        "loss_per_round": [float(lo.mean()) for lo in eng_losses],
        "round_s": round_s,
        "global_lora": trees.map_leaves(lambda leaf: leaf[0], cohort),
    }

    if cfg.oracle:
        # the dense-merge loop over the IDENTICAL padded batches: each step
        # materializes W + s·A·B and runs the plain projections
        def oracle_step(lora, opt_state, batch):
            loss, g = value_and_grad(
                lambda lf: model.lm_loss(peft_mod.apply_lora(params, lf, pc),
                                         _fold_valid(batch)), lora)
            upd, opt_state = opt.update(g, opt_state, lora)
            return trees.tree_add(lora, upd), opt_state, loss

        o_loras = list(loras)
        o_opts = [opt.init(lf) for lf in o_loras]
        max_err = 0.0
        for rnd in range(cfg.rounds):
            stacked = padded_rounds[rnd]
            for ci in range(cfg.n_clients):
                for si in range(cfg.local_steps):
                    batch = {k: v[ci, si] for k, v in stacked.items()}
                    o_loras[ci], o_opts[ci], loss = oracle_step(o_loras[ci], o_opts[ci],
                                                                batch)
                    max_err = max(max_err, abs(float(loss) - float(eng_losses[rnd][ci, si])))
            agg = fedavg_stacked(trees.stack(o_loras),
                                 torch.ones(cfg.n_clients, device=device))
            o_loras = [agg] * cfg.n_clients
        result["oracle_loss_max_err"] = float(max_err)

    return result
