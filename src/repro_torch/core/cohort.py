"""Federated cohort engine (the port of ``repro.core.cohort``'s
synchronous rounds: ``build_supervised_round`` for PFTT and PFIT's
shepherd baseline, ``build_ppo_round`` for PFIT's personalized RLHF).

Per-client trainable state and optimizer state stay stacked along a
leading client axis (``trees.stack``).  One round:

    for each client, in client order: its local steps, or
      its rollout, double-reward score and PPO epochs       # training
    weighted mean of the uploaded subtree over the outage
      weight vector (one stacked op per leaf; PFIT's under
      each client's sparsity mask, against the global)       # server
    broadcast of the aggregate into every client's slot
      (on its masked entries), skipped when every client
      is in outage (Σw = 0)                                  # downlink

The JAX engine ``vmap``s the clients and ``scan``s their steps inside one
compiled program.  Here the client axis is a Python loop over views of the
stacked state: ``torch.func.vmap`` cannot carry the kernels (ctypes
launches), and a client-stacked ``lora_fused`` is beyond the reference
(ROADMAP queue 2).  The stacked buffers are updated in place and returned,
as the JAX engine donates them.

Not ported yet, and refused by name: the robust round (pending buffer,
fault masks, staleness; ROADMAP queue 1 item 1), uplink codecs and the SVD
factor aggregation (item 2, ``comms``), on-device health scalars (item 3,
``obs``) and the client-sharded mesh (item 8, multi-device).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import trees
from repro_torch.core.aggregation import (broadcast_merge_stacked, fedavg_stacked,
                                          masked_fedavg_stacked)
from repro_torch.rlhf.ppo import PPOConfig, make_ppo_fns
from repro_torch.rlhf.rollout import generate

# Where each option the port does not run yet is ported: the one table the
# engine, ``run_pftt``, ``run_pfit`` and the launchers refuse from.
LATER = {
    "robust": "ROADMAP queue 1 item 1 (the robust round: fault plans, deadlines, "
              "staleness, quorum)",
    "min_quorum": "ROADMAP queue 1 item 1 (the robust round's quorum gate)",
    "checkpoint": "ROADMAP queue 1 item 1 (checkpoint/resume)",
    "codec": "ROADMAP queue 1 item 2 (comms: uplink codecs)",
    "factored_agg": "ROADMAP queue 1 item 2 (comms: factored aggregation)",
    "health": "ROADMAP queue 1 item 3 (obs: cohort health and telemetry)",
    "population": "ROADMAP queue 1 item 4 (population)",
    "arch_round": "ROADMAP queue 1 item 6 (arch zoo: the other architectures' rounds)",
    "mesh": "ROADMAP queue 1 item 8 (multi-device)",
    "legacy_loop": "no item: the cohort engine replaces the legacy per-client loop",
}


def not_ported(what: str, **options) -> None:
    """Raise for the first set option of ``what`` that is not ported."""
    for name, on in options.items():
        if on:
            raise NotImplementedError(f"{what}: {name!r} is not ported; {LATER[name]}")


def client_view(stacked, ci: int):
    """Client ``ci``'s tree: views of the stacked leaves."""
    return trees.map_leaves(lambda leaf: leaf[ci], stacked)


def write_client(stacked, ci: int, tree) -> None:
    """Copy client ``ci``'s tree into its slot of the stacked leaves."""
    trees.map_leaves(lambda leaf, new: leaf[ci].copy_(new), stacked, tree)


class HostBatchStacker:
    """Stacks the round's [client][step] host batches into the engine's
    (n_clients, local_steps, …) layout, one transfer to ``device`` per leaf.

    Ragged cohorts (clients with unequal per-step batch shapes) are padded
    with zeros to the per-leaf maximum and get an extra ``"valid"`` leaf, a
    (n_clients, local_steps, max_batch) f32 mask with 1.0 on real sample
    rows (axis 0 of every leaf is the sample axis); ``Model.cls_loss``
    weights samples by it, so padded rows contribute exactly zero.  Uniform
    cohorts get no ``"valid"`` leaf."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

    def __call__(self, per_client_batches):
        nc, ns = len(per_client_batches), len(per_client_batches[0])
        steps = [step for cb in per_client_batches for step in cb]
        out, ragged = {}, False
        for k in steps[0]:
            leaves = [np.asarray(step[k]) for step in steps]
            shape = tuple(np.max([leaf.shape for leaf in leaves], axis=0))
            buf = np.zeros((len(leaves),) + shape, leaves[0].dtype)
            for i, leaf in enumerate(leaves):
                buf[(i,) + tuple(slice(0, d) for d in leaf.shape)] = leaf
                ragged |= leaf.shape != shape
            out[k] = buf.reshape((nc, ns) + shape)
        if ragged:
            first = next(iter(out.values()))
            rows = np.array([len(np.asarray(next(iter(step.values())))) for step in steps])
            valid = np.arange(first.shape[2])[None] < rows[:, None]
            out["valid"] = valid.astype(np.float32).reshape(nc, ns, -1)
        return {k: torch.from_numpy(v).to(self.device) for k, v in out.items()}


def build_cohort_eval(eval_fn: Callable):
    """Per-client eval over a stacked cohort.  ``eval_fn(trainable,
    *per_client_data) -> tuple of tensors`` is the single-client eval; the
    returned ``cohort_eval(stacked_trainable, *stacked_data)`` runs it for
    each client under ``torch.no_grad()`` and stacks each output over the
    clients (ragged test sets are padded with a validity mask that rides in
    as one of the stacked args)."""
    def cohort_eval(stacked_trainable, *stacked_data):
        n = stacked_data[0].shape[0]
        with torch.no_grad():
            outs = [eval_fn(client_view(stacked_trainable, ci),
                            *(d[ci] for d in stacked_data)) for ci in range(n)]
        return tuple(torch.stack(col) for col in zip(*outs))

    return cohort_eval


def build_supervised_round(local_step_fn: Callable,
                           upload_pred: Optional[Callable[[str], bool]] = None,
                           *, mesh=None, codec=None, factored_agg: bool = False,
                           robust: bool = False, health: bool = False):
    """Per-client local steps + FedAvg + broadcast as one round.

    ``local_step_fn(trainable, opt_state, batch) -> (trainable, opt_state,
    loss)`` is one client's step; ``upload_pred`` selects the uploaded and
    aggregated subtree by path (None → the whole tree).

    Returns ``round_step(stacked_trainable, stacked_opt, batches, weights)
    -> (stacked_trainable, stacked_opt, losses)``: ``batches`` leaves have
    leading (n_clients, local_steps) axes, ``weights`` is the (n_clients,)
    outage vector, ``losses`` the (n_clients, local_steps) local losses.
    The other arguments are the JAX builder's; setting one raises."""
    not_ported("build_supervised_round", mesh=mesh is not None, codec=codec is not None,
               factored_agg=factored_agg, robust=robust, health=health)
    pred = upload_pred or (lambda p: True)

    def round_step(st_trainable, st_opt, batches, weights):
        n, steps = next(iter(batches.values())).shape[:2]
        losses = torch.empty((n, steps), dtype=torch.float32,
                             device=weights.device)
        for ci in range(n):
            tr, op = client_view(st_trainable, ci), client_view(st_opt, ci)
            for si in range(steps):
                tr, op, losses[ci, si] = local_step_fn(
                    tr, op, {k: v[ci, si] for k, v in batches.items()})
            write_client(st_trainable, ci, tr)
            write_client(st_opt, ci, op)

        # server: weighted mean of the uploaded subtree over the surviving
        # clients, broadcast into every client's slot; an all-outage round
        # (Σw = 0) keeps every client's local values
        flat_agg = trees.flatten(fedavg_stacked(trees.select(st_trainable, pred),
                                                weights))
        gate = weights.sum() > 0

        def put(path, loc):
            if path in flat_agg:
                loc.copy_(torch.where(gate, flat_agg[path][None].to(loc.dtype), loc))
            return loc

        trees.map_with_path(put, st_trainable)
        return st_trainable, st_opt, losses

    return round_step


def build_ppo_round(model, opt, ppo_cfg: PPOConfig, prompt_len: int, gen_len: int,
                    quality_fn: Callable, *, lambda_regs=None,
                    reg_pred: Optional[Callable[[str], bool]] = None, mesh=None,
                    codec=None, robust: bool = False, min_quorum: int = 0):
    """PFIT's round: per client, in client order, a rollout, the
    personalized reward, ``prep`` and ``ppo_epochs`` masked clipped steps;
    then the masked aggregation against the global and the masked
    broadcast, gated on Σw > 0.

    ``quality_fn(tokens, resp_mask, alpha_help, alpha_safe)`` scores a
    rollout batch with the double reward.  ``lambda_regs`` is the
    per-client weight of the negative squared L2 pull toward the global
    over the ``reg_pred`` subtree (default ``stages``); None or all zeros
    skips it.

    Returns ``round_step(st_params, st_opt, global_params, st_masks,
    prompts, noises, alphas_help, alphas_safe, weights, rollouts=None) ->
    (st_params, st_opt, new_global, mean_rewards, mean_kls)``: per-client
    state stacked on a leading client axis (updated in place), ``prompts``
    (n, B, P), ``noises`` one Gumbel hook per client (``rlhf.rollout``) in
    place of the JAX package's keys, the alphas sequences of floats,
    ``weights`` the (n,) outage vector.  ``rollouts`` (a list) receives
    each client's (tokens, per-step sampling margins).  The other
    arguments are those of the JAX package's function; setting one
    raises."""
    not_ported("build_ppo_round", mesh=mesh is not None, codec=codec is not None,
               robust=robust, min_quorum=min_quorum > 0)
    prep, step = make_ppo_fns(model, opt, ppo_cfg, prompt_len)
    reg_pred = reg_pred or (lambda p: p.startswith("stages"))
    lams = None if lambda_regs is None else [float(x) for x in lambda_regs]
    use_reg = lams is not None and any(x > 0 for x in lams)

    def round_step(st_params, st_opt, global_params, st_masks, prompts, noises,
                   alphas_help, alphas_safe, weights, rollouts=None):
        n, b = prompts.shape[:2]
        dev = weights.device
        mean_rewards = torch.empty(n, dtype=torch.float32, device=dev)
        mean_kls = torch.empty(n, dtype=torch.float32, device=dev)
        resp = torch.cat([torch.zeros(b, prompt_len, device=dev),
                          torch.ones(b, gen_len, device=dev)], 1)
        for ci in range(n):
            params, opt_state = client_view(st_params, ci), client_view(st_opt, ci)
            margins = None if rollouts is None else []
            toks = generate(model, params, prompts[ci], gen_len, noises[ci],
                            temperature=ppo_cfg.temperature, margins=margins)
            if rollouts is not None:
                rollouts.append((toks, torch.stack(margins, 1)))
            with torch.no_grad():
                reward = quality_fn(toks, resp, alphas_help[ci], alphas_safe[ci])
                if use_reg:
                    reward = reward - lams[ci] * trees.tree_l2(
                        trees.select(params, reg_pred), trees.select(global_params, reg_pred))
            old_logp, adv, ret, resp_mask, mean_kl = prep(params, global_params, toks, reward)
            mask = client_view(st_masks, ci)
            for _ in range(ppo_cfg.ppo_epochs):
                params, opt_state, _, _ = step(params, opt_state, toks, old_logp, adv,
                                               ret, resp_mask, mask)
            write_client(st_params, ci, params)
            write_client(st_opt, ci, opt_state)
            mean_rewards[ci], mean_kls[ci] = reward.mean(), mean_kl

        # server: sparse-mask-weighted aggregation over the surviving clients
        # (all outage: every denominator 0, the global kept), then each client
        # resumes from the new global on its own masked entries
        new_global = masked_fedavg_stacked(global_params, st_params, st_masks, weights)
        merged = broadcast_merge_stacked(st_params, new_global, st_masks,
                                         gate=weights.sum() > 0)
        trees.map_leaves(lambda dst, src: dst.copy_(src), st_params, merged)
        return st_params, st_opt, new_global, mean_rewards, mean_kls

    return round_step
