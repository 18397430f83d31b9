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

Both builders take ``robust=True`` (``docs/robustness.md``): the round then
carries a pending-payload buffer (each client's latest produced-but-unmerged
upload) and takes the round's fault masks (``train``, ``recv``, ``rejoin``),
the staleness-discounted weights of ``core/robust.StalenessTracker`` and the
deadline mask; ``min_quorum`` voids a round with fewer deliveries.  The
JAX body trains every client and selects the old state back where
``train`` is 0; here a client that does not train is never run nor
written, which leaves the same state.  Every gate is a device tensor.

Both builders take ``codec`` (``repro_torch.comms``): after local
training each client's upload is coded against the round-input value of
the uploaded subtree (for PPO the whole params, charged only on the
client's sparsity mask) and the server aggregates the lossy decode; the
round step takes one uniform hook per client (``codec_noises``, in place
of the JAX package's keys) and returns each client's payload bits.  The
state is updated in place, so the reference is a copy taken before any
client trains.  ``factored_agg`` aggregates LoRA factor pairs by the SVD
re-projection (``core.aggregation.factored_fedavg_stacked``).

``build_supervised_round(health=True)`` returns one trailing dict of
training-health scalars (``repro_torch.obs.health.cohort_health``), computed
from the round's own tensors before the broadcast writes the state, with no
host synchronisation; it changes nothing the round writes.

Both builders take the cohort's layout as ``cs=`` (a
``sharding.CohortSharding``, from ``sharding.cohort_sharding(mesh, n,
client_axes)``): under a mesh the client axis is sharded over the processes
of a ``torch.distributed`` group, each rank holding its rows of every
stacked input (ghost-padded to a multiple of the shard count).  Each rank
runs its own clients; the aggregation sums every rank's weighted partial
sums in one ``all_reduce`` (``core/aggregation.py``), the gates read the
summed weights, and every rank broadcasts the same global into its rows.
Anything without a client axis (the frozen base, the PPO global, the
reward models) every rank holds whole.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import trees
from repro_torch.comms.codec import roundtrip
from repro_torch.core.aggregation import (_pad_mask, broadcast_merge_stacked,
                                          factored_fedavg_stacked, fedavg_stacked,
                                          masked_fedavg_stacked)
from repro_torch.obs.health import cohort_health
from repro_torch.rlhf.ppo import PPOConfig, make_ppo_fns
from repro_torch.rlhf.rollout import generate
from repro_torch.sharding import CohortSharding, gather_clients, psum

def client_view(stacked, ci: int):
    """Client ``ci``'s tree: views of the stacked leaves."""
    return trees.map_leaves(lambda leaf: leaf[ci], stacked)


def write_client(stacked, ci: int, tree) -> None:
    """Copy client ``ci``'s tree into its slot of the stacked leaves."""
    trees.map_leaves(lambda leaf, new: leaf[ci].copy_(new), stacked, tree)


def own_copies(client_trees, agg, recv=None):
    """The legacy per-client loop's downlink: each client's tree with the
    aggregate merged in (where ``recv[ci]`` > 0; every client without
    ``recv``), each from its own copy of ``agg``, so that a later in-place
    write to one client's tree reaches no other client."""
    return [trees.merge(t, _clone_tree(agg)) if recv is None or recv[ci] > 0 else t
            for ci, t in enumerate(client_trees)]


def host_batch(batch, device):
    """One client's step batch of numpy leaves on ``device`` (the legacy
    loop's batch: the engine's stacked row, unpadded)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


class HostBatchStacker:
    """Stacks the round's [client][step] host batches into the engine's
    (n_clients, local_steps, …) layout, one transfer to ``device`` per leaf.

    Ragged cohorts (clients with unequal per-step batch shapes) are padded
    with zeros to the per-leaf maximum and get an extra ``"valid"`` leaf, a
    (n_clients, local_steps, max_batch) f32 mask with 1.0 on real sample
    rows (axis 0 of every leaf is the sample axis); ``Model.cls_loss``
    weights samples by it, so padded rows contribute exactly zero.  Uniform
    cohorts get no ``"valid"`` leaf.

    ``rows`` (a slice of the cohort; a sharded rank's ``CohortSharding.rows``):
    only those clients are stacked and moved, with the shapes and the
    ``"valid"`` decision of the whole cohort, so every rank's layout is its
    rows of the unsharded one."""

    def __init__(self, device="cpu", rows: Optional[slice] = None):
        self.device = torch.device(device)
        self.rows = rows if rows is not None else slice(None)

    def __call__(self, per_client_batches):
        ns = len(per_client_batches[0])
        steps = [step for cb in per_client_batches for step in cb]
        mine = per_client_batches[self.rows]
        nc = len(mine)
        out, ragged = {}, False
        for k in steps[0]:
            shapes = [np.shape(step[k]) for step in steps]
            shape = tuple(np.max(shapes, axis=0))
            ragged |= any(sh != shape for sh in shapes)
            leaves = [np.asarray(step[k]) for cb in mine for step in cb]
            buf = np.zeros((len(leaves),) + shape, leaves[0].dtype)
            for i, leaf in enumerate(leaves):
                buf[(i,) + tuple(slice(0, d) for d in leaf.shape)] = leaf
            out[k] = buf.reshape((nc, ns) + shape)
        if ragged:
            first = next(iter(out.values()))
            rows = np.array([len(np.asarray(next(iter(step.values()))))
                             for cb in mine for step in cb])
            valid = np.arange(first.shape[2])[None] < rows[:, None]
            out["valid"] = valid.astype(np.float32).reshape(nc, ns, -1)
        return {k: torch.from_numpy(v).to(self.device) for k, v in out.items()}


def stack_host_batches(per_client_batches, device="cpu"):
    """[client][step] list of {name: np.ndarray} → one dict of tensors on
    ``device`` with leading (n_clients, local_steps) axes — the engine's
    data layout.  One-shot helper; a round loop holds a
    ``HostBatchStacker`` instead."""
    return HostBatchStacker(device)(per_client_batches)


def build_cohort_eval(eval_fn: Callable, mesh=None):
    """Per-client eval over a stacked cohort.  ``eval_fn(trainable,
    *per_client_data) -> tuple of tensors`` is the single-client eval; the
    returned ``cohort_eval(stacked_trainable, *stacked_data)`` runs it for
    each client under ``torch.no_grad()`` and stacks each output over the
    clients (ragged test sets are padded with a validity mask that rides in
    as one of the stacked args).  Under ``mesh`` each rank runs its own rows
    and every output is gathered over the ranks: each rank returns the
    whole padded cohort's."""
    def cohort_eval(stacked_trainable, *stacked_data):
        n = stacked_data[0].shape[0]
        with torch.no_grad():
            outs = [eval_fn(client_view(stacked_trainable, ci),
                            *(d[ci] for d in stacked_data)) for ci in range(n)]
        cols = tuple(torch.stack(col) for col in zip(*outs))
        return cols if mesh is None else tuple(gather_clients(c, mesh) for c in cols)

    return cohort_eval


def _where_clients(mask, new, old):
    """Per-client select over stacked trees: leaf ← ``new`` where the
    client's ``mask`` entry > 0, else ``old`` (new tensors; pure
    selection, so every value is bitwise one of the two)."""
    return trees.map_leaves(
        lambda n, o: torch.where(_pad_mask(mask, n.dim()) > 0, n, o), new, old)


def _zero_clients(mask, tree):
    """Zero every leaf row whose client ``mask`` entry > 0 (crash-rejoin
    optimizer reset: AdamW's moments and step count re-init to zeros)."""
    return trees.map_leaves(
        lambda leaf: torch.where(_pad_mask(mask, leaf.dim()) > 0,
                                 torch.zeros_like(leaf), leaf), tree)


def _training_clients(train_m) -> list:
    """The clients whose ``train_m`` entry > 0: the only ones the robust
    bodies run and write (one small device-to-host read a round)."""
    return [ci for ci, t in enumerate(train_m.tolist()) if t > 0]


def _clone_tree(tree):
    """New storage of every leaf (``None`` leaves stay ``None``)."""
    return trees.map_leaves(torch.clone, tree)


def _code_uploads(codec, uploaded, ref, clients, noises, bit_weights=None):
    """The listed clients' uploads through ``codec``'s roundtrip, each
    against its row of ``ref`` (and ``bit_weights``) with its uniform hook
    ``noises[ci]``: (stacked decoded uploads, (n,) f32 payload bits).  Rows
    of the other clients hold zeros and 0 bits (the robust bodies never
    send them)."""
    decoded = trees.map_leaves(torch.zeros_like, uploaded)
    first = next(iter(trees.flatten(uploaded).values()))
    bits = torch.zeros(first.shape[0], dtype=torch.float32, device=first.device)
    for ci in clients:
        dec, bits[ci] = roundtrip(
            codec, client_view(uploaded, ci), ref=client_view(ref, ci),
            bit_weights=None if bit_weights is None else client_view(bit_weights, ci),
            **({} if noises is None else {"noise": noises[ci]}))
        write_client(decoded, ci, dec)
    return decoded, bits


def _quorum_gate(w, min_quorum: int, mesh=None):
    """The merge gate on the device: something was delivered (Σw > 0) and
    at least ``min_quorum`` clients delivered (0: the plain Σw > 0); under
    ``mesh`` both counts are summed over the ranks."""
    if mesh is None:
        return torch.logical_and(w.sum() > 0, (w > 0).float().sum() >= min_quorum)
    tot = psum(torch.stack([w.sum(), (w > 0).float().sum()]), mesh)
    return torch.logical_and(tot[0] > 0, tot[1] >= min_quorum)


def _any_weight(w, mesh=None):
    """Σw > 0 over the whole cohort (the all-outage gate)."""
    return (w.sum() if mesh is None else psum(w.sum(), mesh)) > 0


def build_supervised_round(local_step_fn: Callable,
                           upload_pred: Optional[Callable[[str], bool]] = None,
                           *, cs: Optional[CohortSharding] = None, codec=None, factored_agg: bool = False,
                           robust: bool = False, min_quorum: int = 0,
                           health: bool = False):
    """Per-client local steps + FedAvg + broadcast as one round.

    ``local_step_fn(trainable, opt_state, batch) -> (trainable, opt_state,
    loss)`` is one client's step; ``upload_pred`` selects the uploaded and
    aggregated subtree by path (None → the whole tree).

    Returns ``round_step(stacked_trainable, stacked_opt, batches, weights)
    -> (stacked_trainable, stacked_opt, losses)``: ``batches`` leaves have
    leading (n_clients, local_steps) axes, ``weights`` is the (n_clients,)
    outage vector, ``losses`` the (n_clients, local_steps) local losses.

    ``codec``: the step takes a trailing ``codec_noises`` (one hook
    ``noise(leaf_index, shape) -> uniforms`` per client) and returns a
    trailing (n,) f32 ``payload_bits``; the server aggregates the decoded
    uploads.  ``factored_agg``: LoRA factor pairs aggregate by the SVD
    re-projection.

    ``robust``: the straggler-tolerant signature, ``round_step(st_trainable,
    st_opt, pending, batches, train_m, agg_w, recv_m, rejoin_m, ontime_m) ->
    (st_trainable, st_opt, pending, losses)``.  ``pending`` is the stacked
    buffer of each client's latest produced-but-unmerged upload (the
    uploaded subtree, zeros at first); ``train_m``/``recv_m``/``rejoin_m``
    are the round's (n,) fault masks (``wireless.faults``), ``agg_w`` the
    staleness-discounted weights (``core/robust.StalenessTracker``) and
    ``ontime_m`` the deadline mask (1 = arrived before the cutoff).  Only
    ``train`` clients run their steps and are written (the others keep
    their state, their losses 0); a fresh upload supersedes the pending
    payload and the others retransmit it; the server merges with ``agg_w ·
    ontime_m``, gated on Σw > 0 and at least ``min_quorum`` deliveries (on
    the device); only ``recv`` clients take the broadcast; ``rejoin``
    clients' optimizer state is zeroed.  The returned ``pending`` is new
    storage.  All-ones masks and undiscounted weights give bitwise the
    synchronous round.  With a codec only ``train`` clients are coded (the
    others' bits are 0) and the trailing ``codec_noises``/``payload_bits``
    are the synchronous step's.

    ``health``: the step returns one more, trailing output: a dict of
    0-dimensional f32 tensors (``obs.health.HEALTH_KEYS``) measured on the
    round's tensors against a copy of the round-input uploaded subtree —
    the synchronous body over the (decoded) uploads, the robust one over
    what went on the air (stragglers' pending payloads included).

    ``cs`` (the cohort's layout over a client mesh): every stacked input
    and output holds this rank's rows, the aggregation and the gates are
    summed over the ranks, and the health scalars are the whole cohort's,
    the ghost rows left out."""
    mesh = None if cs is None else cs.mesh
    pred = upload_pred or (lambda p: True)
    agg_fn = functools.partial(factored_fedavg_stacked if factored_agg else fedavg_stacked,
                               mesh=mesh)

    def upload(st_trainable, ref, clients, codec_noises):
        """What the clients put on the air: the uploaded subtree, or with a
        codec its lossy decode and the bits."""
        uploaded = trees.select(st_trainable, pred)
        if codec is None:
            return uploaded, None
        return _code_uploads(codec, uploaded, ref, clients, codec_noises)

    def train_clients(st_trainable, st_opt, batches, clients, losses):
        for ci in clients:
            tr, op = client_view(st_trainable, ci), client_view(st_opt, ci)
            for si in range(losses.shape[1]):
                tr, op, losses[ci, si] = local_step_fn(
                    tr, op, {k: v[ci, si] for k, v in batches.items()})
            write_client(st_trainable, ci, tr)
            write_client(st_opt, ci, op)

    def broadcast(st_trainable, agg, sel):
        """Write the aggregate into every stacked slot where ``sel`` (a
        scalar gate, or one per client) holds; elsewhere keep local."""
        flat_agg = trees.flatten(agg)

        def put(path, loc):
            if path in flat_agg:
                loc.copy_(torch.where(_pad_mask(sel, loc.dim()),
                                      flat_agg[path][None].to(loc.dtype), loc))
            return loc

        trees.map_with_path(put, st_trainable)

    def round_input(st_trainable):
        """A copy of the round-input uploaded subtree: the codec's delta
        reference and the health scalars' update baseline (the state is
        updated in place, so it is taken before any client trains)."""
        if codec is None and not health:
            return None
        return _clone_tree(trees.select(st_trainable, pred))

    def outputs(out, bits, hstats):
        out = out if codec is None else out + (bits,)
        return out if not health else out + (hstats,)

    def ghost_kw():
        """The health scalars' mesh and this rank's ghost rows."""
        return {"mesh": mesh, "ghost": None if cs is None else cs.ghosts()}

    def round_step(st_trainable, st_opt, batches, weights, codec_noises=None):
        n, steps = next(iter(batches.values())).shape[:2]
        losses = torch.empty((n, steps), dtype=torch.float32,
                             device=weights.device)
        up_in = round_input(st_trainable)
        train_clients(st_trainable, st_opt, batches, range(n), losses)
        uploaded, bits = upload(st_trainable, up_in, range(n), codec_noises)
        gate = _any_weight(weights, mesh)
        # health before the broadcast: without a codec ``uploaded`` holds
        # views of the state the broadcast overwrites
        hstats = None if not health else cohort_health(
            uploaded, up_in, losses, weights, gate,
            raw=None if codec is None else trees.select(st_trainable, pred),
            decoded=None if codec is None else uploaded, **ghost_kw())
        # server: weighted mean of the uploads over the surviving clients,
        # broadcast into every client's slot; an all-outage round (Σw = 0)
        # keeps every client's local values
        broadcast(st_trainable, agg_fn(uploaded, weights), gate)
        return outputs((st_trainable, st_opt, losses), bits, hstats)

    def robust_step(st_trainable, st_opt, pending, batches, train_m, agg_w,
                    recv_m, rejoin_m, ontime_m, codec_noises=None):
        n, steps = next(iter(batches.values())).shape[:2]
        losses = torch.zeros((n, steps), dtype=torch.float32, device=agg_w.device)
        up_in = round_input(st_trainable)
        clients = _training_clients(train_m)
        train_clients(st_trainable, st_opt, batches, clients, losses)
        uploaded, bits = upload(st_trainable, up_in, clients, codec_noises)
        # what goes on the air: a fresh upload supersedes the pending
        # payload; stragglers retransmit it.  A deadline miss merges at
        # weight 0 (it stays pending); an under-quorum round is a no-op.
        send = _where_clients(train_m, uploaded, pending)
        w = agg_w * ontime_m
        gate = _quorum_gate(w, min_quorum, mesh)
        hstats = None
        if health:
            # the codec's error over the clients it coded: the other rows of
            # ``uploaded`` hold zeros, and their raw rows are taken equal
            raw = None if codec is None else _where_clients(
                train_m, trees.select(st_trainable, pred), uploaded)
            hstats = cohort_health(send, up_in, losses, w, gate, train_m=train_m, raw=raw,
                                   decoded=None if codec is None else uploaded,
                                   **ghost_kw())
        broadcast(st_trainable, agg_fn(send, w), torch.logical_and(gate, recv_m > 0))
        trees.map_leaves(lambda dst, src: dst.copy_(src), st_opt,
                         _zero_clients(rejoin_m, st_opt))
        return outputs((st_trainable, st_opt, send, losses), bits, hstats)

    return robust_step if robust else round_step


def build_ppo_round(model, opt, ppo_cfg: PPOConfig, prompt_len: int, gen_len: int,
                    quality_fn: Callable, *, lambda_regs=None,
                    reg_pred: Optional[Callable[[str], bool]] = None,
                    cs: Optional[CohortSharding] = None, codec=None, robust: bool = False,
                    min_quorum: int = 0):
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
    prompts, noises, alphas_help, alphas_safe, weights, codec_noises=None,
    rollouts=None) -> (st_params, st_opt, new_global, mean_rewards,
    mean_kls)``: per-client state stacked on a leading client axis (updated
    in place), ``prompts`` (n, B, P), ``noises`` one Gumbel hook per client
    (``rlhf.rollout``) in place of the JAX package's keys, the alphas
    sequences of floats, ``weights`` the (n,) outage vector.  ``rollouts``
    (a list) receives each client's (tokens, per-step sampling margins).

    ``codec``: each client's post-PPO params are coded against its
    round-input params (a copy, 2 × 124 M elements at gpt2-small's width for
    two clients), the bit charge restricted to the client's sparsity mask,
    before the masked aggregation; ``codec_noises`` (one uniform hook per
    client) is then needed and the step returns a trailing (n,)
    ``payload_bits``.

    ``robust``: ``round_step(st_params, st_opt, global_params, pending,
    st_masks, prompts, noises, alphas_help, alphas_safe, agg_w, train_m,
    recv_m, rejoin_m, ontime_m, codec_noises=None, rollouts=None) ->
    (st_params, st_opt, new_global, pending, mean_rewards, mean_kls)``
    (and ``payload_bits`` with a codec, 0 for the clients that do not
    train), the contract of
    ``build_supervised_round(robust=True)``: only ``train`` clients run
    (their rewards and KLs, the others' 0), the masked aggregation takes
    fresh uploads and retransmitted pending payloads at ``agg_w ·
    ontime_m``, the masked broadcast reaches ``recv`` clients only, and
    ``rejoin`` clients' optimizer state is zeroed.  A round the gate voids
    (nothing delivered, or under ``min_quorum``) keeps the global and every
    client; the JAX package's fused body returns the ungated aggregate as
    its global there, its per-client loop keeps the global (ROADMAP queue
    3), and the port follows the loop.

    ``cs``: as in ``build_supervised_round``, each rank holding its rows
    of every per-client input, the global model whole on every rank, the
    masked aggregation's numerators and denominators summed over the ranks.
    ``lambda_regs`` covers the real cohort; each rank takes its rows of it
    (a ghost takes client 0's)."""
    mesh = None if cs is None else cs.mesh
    prep, step = make_ppo_fns(model, opt, ppo_cfg, prompt_len)
    reg_pred = reg_pred or (lambda p: p.startswith("stages"))
    lams = None if lambda_regs is None else [float(x) for x in lambda_regs]
    use_reg = lams is not None and any(x > 0 for x in lams)
    if use_reg and cs is not None:
        lams = cs.local(lams)

    def train_clients(clients, st_params, st_opt, global_params, st_masks, prompts,
                      noises, alphas_help, alphas_safe, rollouts, mean_rewards, mean_kls):
        b = prompts.shape[1]
        dev = mean_rewards.device
        resp = torch.cat([torch.zeros(b, prompt_len, device=dev),
                          torch.ones(b, gen_len, device=dev)], 1)
        for ci in clients:
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

    def upload(st_params, ref, st_masks, clients, codec_noises):
        """The clients' uploads: the params, or with a codec the lossy
        decode of each one's masked delta and the bits."""
        if codec is None:
            return st_params, None
        return _code_uploads(codec, st_params, ref, clients, codec_noises, st_masks)

    def round_step(st_params, st_opt, global_params, st_masks, prompts, noises,
                   alphas_help, alphas_safe, weights, codec_noises=None, rollouts=None):
        n = prompts.shape[0]
        mean_rewards = torch.empty(n, dtype=torch.float32, device=weights.device)
        mean_kls = torch.empty(n, dtype=torch.float32, device=weights.device)
        ref = None if codec is None else _clone_tree(st_params)   # round-input params
        train_clients(range(n), st_params, st_opt, global_params, st_masks, prompts,
                      noises, alphas_help, alphas_safe, rollouts, mean_rewards, mean_kls)
        uploaded, bits = upload(st_params, ref, st_masks, range(n), codec_noises)
        del ref
        # server: sparse-mask-weighted aggregation over the surviving clients
        # (all outage: every denominator 0, the global kept), then each client
        # resumes from the new global on its own masked entries
        new_global = masked_fedavg_stacked(global_params, uploaded, st_masks, weights,
                                           mesh=mesh)
        merged = broadcast_merge_stacked(st_params, new_global, st_masks,
                                         gate=_any_weight(weights, mesh))
        trees.map_leaves(lambda dst, src: dst.copy_(src), st_params, merged)
        out = (st_params, st_opt, new_global, mean_rewards, mean_kls)
        return out if codec is None else out + (bits,)

    def robust_step(st_params, st_opt, global_params, pending, st_masks, prompts,
                    noises, alphas_help, alphas_safe, agg_w, train_m, recv_m, rejoin_m,
                    ontime_m, codec_noises=None, rollouts=None):
        n = prompts.shape[0]
        mean_rewards = torch.zeros(n, dtype=torch.float32, device=agg_w.device)
        mean_kls = torch.zeros(n, dtype=torch.float32, device=agg_w.device)
        ref = None if codec is None else _clone_tree(st_params)
        clients = _training_clients(train_m)
        train_clients(clients, st_params, st_opt, global_params, st_masks, prompts, noises,
                      alphas_help, alphas_safe, rollouts, mean_rewards, mean_kls)
        uploaded, bits = upload(st_params, ref, st_masks, clients, codec_noises)
        del ref
        # fresh uploads supersede the pending payloads; stragglers and
        # outage clients retransmit theirs with the staleness discount; a
        # deadline miss merges at weight 0 (it stays pending)
        send = _where_clients(train_m, uploaded, pending)
        w = agg_w * ontime_m
        gate = _quorum_gate(w, min_quorum, mesh)
        new_global = trees.map_leaves(
            lambda a, g: torch.where(gate, a, g),
            masked_fedavg_stacked(global_params, send, st_masks, w, mesh=mesh), global_params)
        merged = broadcast_merge_stacked(st_params, new_global, st_masks, gate=gate)
        trees.map_leaves(lambda dst, src: dst.copy_(src), st_params,
                         _where_clients(recv_m, merged, st_params))
        trees.map_leaves(lambda dst, src: dst.copy_(src), st_opt,
                         _zero_clients(rejoin_m, st_opt))
        out = (st_params, st_opt, new_global, send, mean_rewards, mean_kls)
        return out if codec is None else out + (bits,)

    return robust_step if robust else round_step
