"""PFTT — Personalized Federated Task Tuning (paper §IV-D), the port of
``repro.core.pftt``'s engine path.

Universal adapters (and the classifier head) are aggregated globally each
round; local LoRA is trained but never uploaded, giving per-client
personalization.  The baselines of the paper's Fig. 5 are method variants:

* ``vanilla_fl`` — adapters + LoRA + head all uploaded and aggregated
* ``fedbert``    — split learning: the client trains embeddings + head, the
                   body stays frozen; round traffic adds the activation
                   exchange of split learning
* ``fedlora``    — LoRA-only federated fine-tuning, LoRA aggregated

Every round runs over a simulated Rayleigh uplink (outage → the client's
update is dropped that round) and is logged to a ``CommLedger`` (bytes,
delay, energy).  Execution goes through the cohort engine
(``core/cohort.py``), LoRA factored (``peft.lora_proj`` → ``lora_fused``);
encoder attention runs the non-causal ``flash_attn`` kernel.

The JAX package's two parity oracles run too.  ``PFTTConfig(factored=
False)`` merges the LoRA into the weights inside every loss and eval
(``_merge_trainable``: plain matmuls of ``W + s·A·B``, no ``lora_fused``
launch), in the engine and in the loop alike.  ``PFTTConfig(engine=False)``
is the legacy per-client loop: each client keeps its own trainable and
optimizer trees, runs its steps through the same ``local_step``, and the
server stacks the uploads it received and averages them (the list API's
``fedavg``, or ``factored_fedavg_stacked`` under ``factored_agg``; the
robust round at ``agg_w``), each client merging its own copy.  As
in the JAX package, the loop writes no checkpoint, ignores ``mesh``, has
no health scalars and no ``gather``/``device-step`` spans, and its result
says ``"fused_engine": False``.

Parity with the JAX package from identical state: JAX's PRNG streams cannot
be reproduced in torch, so ``run_pftt(cfg, init=...)`` takes numpy trees
exported from the JAX package — the base before MLM pretraining, the
adapter leaves, each client's initial LoRA — in place of the port's
``torch.Generator`` draws.  Every numpy draw (corpora, MLM masks,
partition, batches, channel) is the copied code's own, draw for draw.

``fault_plan`` and/or a non-inert ``deadline`` switch the round to the
straggler-tolerant robust engine (``cohort.build_supervised_round(robust=
True)``, ``core/robust.StalenessTracker``; ``docs/robustness.md``).
``ckpt_dir`` saves the stacked state after every round (one atomic npz
that also holds the host state's JSON, then the same JSON as a sidecar for
readers); ``resume`` restarts from the npz alone and replays the host draws
of the skipped rounds, so the continued run is the uninterrupted one.

``uplink_codec`` compresses each client's upload inside the round
(``repro_torch.comms``; the ledger charges the encoded bits, plus fedbert's
activation exchange) and ``factored_agg`` aggregates the LoRA factor pairs
by the SVD re-projection.  The codec's uniforms come from
``init["codec_noise"](round, client, leaf_index, shape)`` when given (the
JAX package's draws), else ``comms.codec.codec_uniforms`` of (seed, round,
client, leaf).  In deadline mode a codec's first scheduling size is
``payload_bits_upper_bound``; each realized size replaces it.

``telemetry`` (``repro_torch.obs.TelemetryConfig``) threads one
``SpanTracer`` and one ``RunTelemetry`` through the run: the JAX package's
spans (``gather``, ``encode``, ``device-step`` — ended by a device
synchronize, so it times the device — ``eval``, ``checkpoint``), one
``round`` event a round (with the round's health scalars, returned by the
round step itself) written before that round's checkpoint, and the
``run``/``resume``/``compile``/``checkpoint`` events; ``trace`` writes
``trace.json``, ``torch_profile`` brackets the run in ``torch.profiler``.

``population`` (``repro_torch.fl.PopulationConfig``) runs sampled-cohort
population mode (``_run_pftt_population``): a host ``PopulationStore`` of
every client's state, a cohort drawn each round into the robust round
body, the tracker spanning the population.

``run_pftt(cfg, mesh=...)`` (a ``sharding.ClientMesh`` over an initialised
process group) shards the cohort over the ranks: every rank draws the
whole run's host streams (pretraining, data, channel, faults, batches)
from the same seeds and keeps its rows of the ghost-padded cohort
(``sharding.cohort_sharding``); the round's aggregation and gates sum over
the ranks; accuracies, bits and losses are gathered, so every rank
computes the same ledger and result.  Only rank 0 writes telemetry and
checkpoints; a checkpoint holds the real cohort gathered from every rank,
in the unsharded format, so a run resumes at any world size.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import bridge, resolve_device, synchronize, trees
from repro_torch.checkpoint import load_checkpoint, load_meta, save_checkpoint, save_json
from repro_torch.comms import ChannelBudget, get_codec, payload_bits_upper_bound
from repro_torch.comms.codec import codec_uniforms, roundtrip, round_noises
from repro_torch.configs import get_config
from repro_torch.core.aggregation import factored_fedavg_stacked, fedavg_stacked
from repro_torch.core.cohort import (HostBatchStacker, build_cohort_eval,
                                     build_supervised_round, host_batch, own_copies)
from repro_torch.core.robust import round_extra, round_reports, robust_runtime
from repro_torch.data import (SPECIAL, ClassificationCorpus, batch_iterator,
                              dirichlet_partition)
from repro_torch.models import peft as peft_mod
from repro_torch.models.transformer import Model
from repro_torch.obs import close_run, open_run
from repro_torch.optim import adamw, value_and_grad
from repro_torch.sharding import cohort_sharding
from repro_torch.wireless import (CommLedger, DeadlineConfig, FaultPlan, RayleighChannel,
                                  tree_bytes)

METHODS = ("pftt", "vanilla_fl", "fedbert", "fedlora")


@dataclasses.dataclass(frozen=True)
class PFTTConfig:
    method: str = "pftt"
    n_clients: int = 4
    rounds: int = 40
    local_steps: int = 10
    batch: int = 16
    seq_len: int = 32
    d_model: int = 128
    lora_rank: int = 8
    adapter_dim: int = 8
    dirichlet_alpha: float = 0.3
    lr: float = 1e-3
    pretrain_steps: int = 200
    pretrain_lr: float = 1e-3
    samples_per_client: int = 400
    test_samples: int = 200
    snr_db: float = 5.0
    seed: int = 0
    verbose: bool = False
    engine: bool = True            # the cohort engine (False: legacy loop)
    factored: bool = True          # unmerged LoRA (False: the merged oracle,
                                   # W + s·A·B materialized per loss)
    uplink_codec: str = "none"
    factored_agg: bool = False
    tx_power_w: float = 0.5        # uplink transmit power (ChannelBudget)
    fault_plan: Optional[FaultPlan] = None   # the straggler-tolerant robust
                                   # round (the zero plan is bitwise the
                                   # synchronous engine)
    staleness_alpha: float = 1.0   # FedAsync α (cancels under normalization)
    staleness_a: float = 0.0       # staleness exponent a in α·(1+s)^(-a)
    max_staleness: int = 0         # drop pending payloads older than this;
                                   # 0 = synchronous drop-on-failure
    deadline: Optional[DeadlineConfig] = None  # continuous-time round
                                   # (wireless/arrivals.py); inert or None is
                                   # the round-granular robust runtime
    ckpt_dir: Optional[str] = None # save the stacked round state each round
    resume: bool = False           # restart from ckpt_dir's last round
    population: Optional[object] = None   # fl.PopulationConfig: sampled-
                                   # cohort population mode
    telemetry: Optional[object] = None    # obs.TelemetryConfig: JSONL round
                                   # events, span tracing, health scalars
    device: Optional[str] = None   # None/"cuda": the GPU (raises without);
                                   # "cpu": the kernels' plain versions


def _upload_pred(method: str):
    """Which paths are uploaded/aggregated (within the trainable tree)."""
    if method == "pftt":
        return lambda p: p.startswith("shared/")
    if method in ("vanilla_fl", "fedlora", "fedbert"):
        return lambda p: True
    raise ValueError(method)


def _build_trainable(method: str, params, lora):
    """trainable := {'shared': subtree uploaded, 'local': kept on-client}."""
    if method == "pftt":
        shared = trees.select(params, lambda p: peft_mod.is_adapter_path(p)
                              or p.startswith("cls_head"))
        return {"shared": shared, "local": {"lora": lora}}
    if method == "vanilla_fl":
        shared = trees.select(params, lambda p: peft_mod.is_adapter_path(p)
                              or p.startswith("cls_head"))
        return {"shared": {"base": shared, "lora": lora}, "local": {}}
    if method == "fedlora":
        shared = trees.select(params, lambda p: p.startswith("cls_head"))
        return {"shared": {"base": shared, "lora": lora}, "local": {}}
    if method == "fedbert":
        shared = trees.select(params, lambda p: p.startswith(
            ("embed", "pos_embed", "cls_head")))
        return {"shared": shared, "local": {}}
    raise ValueError(method)


def _split_trainable(method: str, base_params, trainable):
    """(effective params without LoRA merged, unmerged LoRA tree)."""
    if method == "pftt":
        return (trees.merge(base_params, trainable["shared"]),
                trainable["local"].get("lora"))
    if method in ("vanilla_fl", "fedlora"):
        return (trees.merge(base_params, trainable["shared"]["base"]),
                trainable["shared"]["lora"])
    if method == "fedbert":
        return trees.merge(base_params, trainable["shared"]), None
    raise ValueError(method)


def _merge_trainable(method: str, base_params, trainable, peft_cfg):
    """Effective params from (frozen base, trainable) with LoRA merged — the
    merged parity oracle of the factored path."""
    full, lora = _split_trainable(method, base_params, trainable)
    if lora is not None:
        full = peft_mod.apply_lora(full, lora, peft_cfg)
    return full


def _effective_fn(cfg: PFTTConfig, frozen, peft_cfg):
    """``effective(trainable) -> (params, lora, lora_scale)`` per
    ``cfg.factored``: the unmerged factors beside the base, or (the merged
    oracle) the LoRA merged in, no factors, scale 1."""
    scale = peft_mod.lora_scale(peft_cfg)

    def effective(t):
        if cfg.factored:
            full, lora = _split_trainable(cfg.method, frozen, t)
            return full, lora, scale
        return _merge_trainable(cfg.method, frozen, t, peft_cfg), None, 1.0

    return effective


def _tensor_tree(flat, like, device):
    """Replace the leaves of ``like`` whose path is in ``flat`` (numpy)."""
    return trees.map_with_path(
        lambda p, v: torch.from_numpy(np.array(flat[p])).to(device=device, dtype=v.dtype)
        if p in flat else v, like)


def _setup_backbone(cfg: PFTTConfig, init: Optional[Dict] = None):
    """Reduced RoBERTa, MLM pretraining over all topics, PEFT insertion.
    Returns (model, mcfg, params, peft_cfg, corpus, generator, rng,
    use_lora, pretrain seconds)."""
    device = resolve_device(cfg.device)
    rng = np.random.RandomState(cfg.seed)
    gen = torch.Generator().manual_seed(cfg.seed)

    # ---- model: reduced roberta (the paper's backbone), pretrained on IID data
    mcfg = get_config("roberta-base").reduced(d_model=cfg.d_model, repeats=2)
    model = Model(mcfg, device=device)
    base = model.init(gen)
    if init is not None:
        base = bridge.params_from_numpy(init["base"], mcfg, device=device)

    # self-supervised MLM pretraining over ALL topics; the downstream
    # 4-class task is then learned federated
    pre_corpus = ClassificationCorpus(n_classes=8, seq_len=cfg.seq_len,
                                      seed=cfg.seed, skew=0.8)
    corpus = ClassificationCorpus(seq_len=cfg.seq_len, seed=cfg.seed)
    pre = pre_corpus.sample(2048, rng=rng)
    opt_pre = adamw(cfg.pretrain_lr)
    st = opt_pre.init(base)
    it = batch_iterator(pre, cfg.batch, seed=cfg.seed)
    synchronize(device)
    t0 = time.perf_counter()
    loss = None
    for _ in range(cfg.pretrain_steps):
        toks = next(it)["tokens"]
        mpos = rng.rand(*toks.shape) < 0.15
        inp = np.where(mpos, SPECIAL["mask"], toks)
        batch = {"tokens": torch.from_numpy(inp).to(device),
                 "labels": torch.from_numpy(toks).to(device),
                 "mask": torch.from_numpy(mpos.astype(np.float32)).to(device)}
        loss, g = value_and_grad(lambda p, b=batch: model.lm_loss(p, b), base)
        upd, st = opt_pre.update(g, st, base)
        base = trees.tree_add(base, upd)
    synchronize(device)
    pretrain_s = time.perf_counter() - t0
    if cfg.verbose and loss is not None:
        print(f"[pftt:{cfg.method}] MLM pretrain loss {float(loss):.3f}")

    # ---- PEFT insertion
    peft_cfg = peft_mod.PEFTConfig(
        lora_rank=cfg.lora_rank, adapter_dim=cfg.adapter_dim,
        lora_targets=("mixer/wq", "mixer/wv"))
    use_adapters = cfg.method in ("pftt", "vanilla_fl")
    use_lora = cfg.method in ("pftt", "vanilla_fl", "fedlora")
    params = base
    if use_adapters:
        params = peft_mod.init_adapters(gen, base, mcfg, peft_cfg)
        if init is not None:
            params = _tensor_tree(init["adapters"], params, device)
    return (model, mcfg, params, peft_cfg, corpus, gen, rng, use_lora,
            pretrain_s)


def _codec(cfg: PFTTConfig, init: Optional[Dict]):
    """The run's uplink codec (None: uncompressed); JAX's count-sketch
    hashes when ``init`` carries them."""
    codec = get_codec(cfg.uplink_codec)
    if init is not None and "cs_hashes" in init and cfg.uplink_codec == "countsketch":
        codec = dataclasses.replace(codec, hashes=init["cs_hashes"])
    return codec


def _comm_record(ledger) -> Dict:
    """The ledger's newest round without its per-client reports (a round
    event's ``comm``)."""
    return {k: v for k, v in ledger.rounds[-1].items() if k != "per_client"}


def run_pftt(cfg: PFTTConfig, init: Optional[Dict] = None, mesh=None,
             client_axes=None) -> Dict:
    """The cohort engine for one method, synchronous or robust.  ``init``
    (optional): {"base": flat numpy params before pretraining, "adapters":
    flat numpy adapter leaves, "lora": [flat numpy LoRA tree per client],
    "codec_noise": ``(round, client, leaf_index, shape) -> uniforms``,
    "cs_hashes": the count-sketch codec's ``hashes`` hook} — the JAX
    package's draws, for parity runs.  Returns the JAX package's
    result keys plus the port's: the tracker's ``staleness`` counters
    (None when synchronous), the mean local loss of each round
    (``loss_per_round``, a non-training client's counted as 0, as in the
    JAX body), each round's health scalars (``health_per_round``, None
    without telemetry), ``uplink_bits`` (each client-round's realized payload bits
    beside each client's raw ``tree_bytes``·8 and, with a codec, its
    ``payload_bits_upper_bound``; under a codec a non-training client's
    realized bits are 0) and the timings ``pretrain_s`` and ``round_s``
    (the rounds this process ran).  ``mesh`` (+ ``client_axes``): shard the
    cohort over the mesh's ranks (module docstring)."""
    if cfg.method not in METHODS:
        raise ValueError(f"method {cfg.method!r} not in {METHODS}")
    if cfg.population is not None:
        return _run_pftt_population(cfg, init, mesh, client_axes)
    use_engine = cfg.engine
    # this process's rows (the legacy loop ignores ``mesh``, as JAX's does)
    cs = cohort_sharding(mesh if use_engine else None, cfg.n_clients, client_axes)
    cfg = cfg if cs.lead else dataclasses.replace(cfg, verbose=False)
    codec = _codec(cfg, init)
    (model, mcfg, params, peft_cfg, corpus, gen, rng, use_lora,
     pretrain_s) = _setup_backbone(cfg, init)
    device = model.device

    # ---- non-IID client data (Dirichlet over labels, paper §V-B.2)
    all_data = corpus.sample(cfg.samples_per_client * cfg.n_clients, rng=rng)
    parts = dirichlet_partition(all_data["label"], cfg.n_clients,
                                cfg.dirichlet_alpha, seed=cfg.seed)
    client_test, client_iters, client_batch_sizes = [], [], []
    for ci, idx in enumerate(parts):
        cut = max(1, int(len(idx) * 0.8))
        tr = {k: v[idx[:cut]] for k, v in all_data.items()}
        client_test.append({k: v[idx[cut:]] for k, v in all_data.items()})
        client_batch_sizes.append(min(cfg.batch, max(2, len(idx[:cut]))))
        client_iters.append(batch_iterator(tr, client_batch_sizes[-1],
                                           seed=cfg.seed + ci))

    # ---- per-client trainable state (the engine stacks it on a client axis)
    opt = adamw(cfg.lr, update_mask=lambda p: not p.endswith("/mask"))
    clients: List[Dict] = []
    for ci in range(cfg.n_clients):
        lora = None
        if use_lora:
            lora = (peft_mod.init_lora(gen, params, peft_cfg) if init is None
                    else bridge.lora_from_numpy(init["lora"][ci], mcfg, device=device))
        t = _build_trainable(cfg.method, params, lora)
        clients.append({"trainable": t, "opt_state": opt.init(t)})

    effective = _effective_fn(cfg, params, peft_cfg)

    def local_step(trainable, opt_state, batch):
        def loss_fn(t):
            full, lora, ls = effective(t)
            return model.cls_loss(full, batch, lora=lora, lora_scale=ls)[0]
        loss, g = value_and_grad(loss_fn, trainable)
        upd, opt_state = opt.update(g, opt_state, trainable)
        return trees.tree_add(trainable, upd), opt_state, loss

    # ---- eval: every client's test set padded to one shape (validity-masked;
    # ghost rows hold no valid sample, so they drop out of the accuracies)
    max_test = max([len(te["label"]) for te in client_test] + [1])
    seq = client_test[0]["tokens"].shape[1]
    t_toks = np.zeros((cs.total, max_test, seq), np.int32)
    t_labels = np.zeros((cs.total, max_test), np.int32)
    t_valid = np.zeros((cs.total, max_test), np.float32)
    for ci, te in enumerate(client_test):
        n = len(te["label"])
        t_toks[ci, :n] = te["tokens"]
        t_labels[ci, :n] = te["label"]
        t_valid[ci, :n] = 1.0
    t_toks, t_labels, t_valid = (torch.from_numpy(np.ascontiguousarray(a[cs.rows])).to(device)
                                 for a in (t_toks, t_labels, t_valid))

    def eval_client(trainable, tokens, label, valid):
        full, lora, ls = effective(trainable)
        hidden, _ = model.forward(full, tokens, lora=lora, lora_scale=ls)
        pred = (hidden[:, 0] @ full["cls_head"]).float().argmax(-1)
        correct = (pred == label).float() * valid
        return correct.sum(), valid.sum()

    eval_cohort = build_cohort_eval(eval_client, mesh=cs.mesh)

    def eval_round_accs(stacked_trainable):
        """Per-client accuracies (clients with an empty test set dropped)."""
        corr, cnt = (t.cpu().numpy() for t in
                     eval_cohort(stacked_trainable, t_toks, t_labels, t_valid))
        return [float(c / n) for c, n in zip(corr, cnt) if n > 0]

    channel = RayleighChannel(mean_snr_db=cfg.snr_db, seed=cfg.seed)
    budget = ChannelBudget(channel, tx_power_w=cfg.tx_power_w)
    ledger = CommLedger()
    upload_pred = _upload_pred(cfg.method)

    def act_bits() -> float:
        """fedbert split learning: the per-step activation exchange."""
        if cfg.method != "fedbert":
            return 0.0
        return cfg.local_steps * cfg.batch * cfg.seq_len * cfg.d_model * 4 * 2 * 8

    def payload_bytes(trainable) -> float:
        return tree_bytes(trees.select(trainable, upload_pred)) + act_bits() / 8

    # ---- the straggler-tolerant runtime (core/robust.py, wireless/faults.py)
    dl, trace, tracker = robust_runtime(cfg, channel)
    robust = tracker is not None
    arrivals = tracker.arrivals if robust else None

    # ---- observability (repro_torch.obs): spans, JSONL round events and
    # the health scalars the round step returns (the engine's only)
    tracer, tele, health, prof = open_run(cfg.telemetry, device, write=cs.lead)
    health = health and use_engine
    payloads = [payload_bytes(cl["trainable"]) for cl in clients]
    agg_fn = factored_fedavg_stacked if cfg.factored_agg else fedavg_stacked
    if use_engine:
        round_step = build_supervised_round(
            local_step, upload_pred, cs=cs, codec=codec, factored_agg=cfg.factored_agg,
            robust=robust, min_quorum=dl.min_quorum if dl else 0, health=health)
        cohort_tr = cs.take(trees.stack([cl["trainable"] for cl in clients]))
        cohort_opt = cs.take(trees.stack([cl["opt_state"] for cl in clients]))
        stacker = HostBatchStacker(device, rows=cs.rows)
    # the pending-payload buffer: zeros of the uploaded subtree (a zero
    # payload never merges: its weight is 0 until a real one replaces it);
    # the loop keeps one tree a client
    pending = None
    if robust:
        pending = (trees.map_leaves(torch.zeros_like, trees.select(cohort_tr, upload_pred))
                   if use_engine else
                   [trees.map_leaves(torch.zeros_like, trees.select(cl["trainable"], upload_pred))
                    for cl in clients])
    # the continuous-time round schedules by the payload size known at
    # dispatch: exact for uncompressed uploads; a codec's fresh uploads
    # reserve the worst-case encoded size until a realized size replaces it
    est_bits = None
    if dl is not None:
        est_bits = np.asarray(
            [p * 8 for p in payloads] if codec is None else
            [payload_bits_upper_bound(codec, trees.select(cl["trainable"], upload_pred))
             + act_bits() for cl in clients], np.float64)
    codec_noise = (init or {}).get("codec_noise") or functools.partial(
        codec_uniforms, cfg.seed, device=device)

    def vec(v, fill=0.0):
        """A round vector on the device: this rank's rows, ghosts ``fill``."""
        return torch.from_numpy(cs.take_vec(v, fill)).to(device)

    def engine_round(rnd, gains, rplan):
        """One round of the cohort engine: (losses, the clients' payload
        bits, the health scalars or None)."""
        nonlocal cohort_tr, cohort_opt, pending
        # every client's batches, in (client, step) order, every round,
        # training or not: the host streams stay aligned
        with tracer.span("gather"):
            batches = stacker(cs.pad([[next(client_iters[ci]) for _ in range(cfg.local_steps)]
                                      for ci in range(cfg.n_clients)]))
        noise_arg = ()
        if codec is not None:
            with tracer.span("encode"):   # keyed by client id (a ghost: client 0's)
                noise_arg = (cs.local(round_noises(codec_noise, rnd, cfg.n_clients)),)
        if robust:
            # deadline mode hands the engine the pre-deadline weights and the
            # on-time mask apart; the body multiplies them and derives the
            # quorum gate again, so host and device agree
            ontime = rplan.ontime if dl is not None else np.ones(cfg.n_clients, np.float32)
            # ghosts train and receive like real clients, never rejoin, and
            # carry zero weight
            with tracer.span("device-step"):
                outs = round_step(
                    cohort_tr, cohort_opt, pending, batches, vec(rplan.train, 1.0),
                    vec(rplan.agg_w_pre if dl is not None else rplan.agg_w),
                    vec(rplan.recv, 1.0), vec(rplan.rejoin), vec(ontime, 1.0), *noise_arg)
                synchronize(device)
            cohort_tr, cohort_opt, pending, losses = outs[:4]
        else:
            weights = vec(channel.outage_weights(gains))
            with tracer.span("device-step"):
                outs = round_step(cohort_tr, cohort_opt, batches, weights, *noise_arg)
                synchronize(device)
            cohort_tr, cohort_opt, losses = outs[:3]
        # the bits follow the outputs above; the health dict comes last
        bits = ([p * 8 for p in payloads] if codec is None
                else [b + act_bits() for b in cs.gather(outs[4 if robust else 3]).tolist()])
        return cs.gather(losses), bits, outs[-1] if health else None

    def loop_train(rnd, rplan):
        """The legacy loop's training: each client in turn runs its local
        steps on its own trees and codes its upload.  Returns (losses, the
        clients' payload bits, their uploads: None where a client did not
        train)."""
        noises = None if codec is None else round_noises(codec_noise, rnd, cfg.n_clients)
        losses = torch.zeros((cfg.n_clients, cfg.local_steps), device=device)
        bits = [p * 8 for p in payloads] if codec is None else [0.0] * cfg.n_clients
        uploads = [None] * cfg.n_clients
        for ci, cl in enumerate(clients):
            # every client draws its round's batches even when a fault
            # skips its training: the host stream stays the engine's
            round_batches = [next(client_iters[ci]) for _ in range(cfg.local_steps)]
            if robust and rplan.train[ci] == 0:
                continue
            ref = trees.select(cl["trainable"], upload_pred)   # the round-input upload
            for si, batch in enumerate(round_batches):
                cl["trainable"], cl["opt_state"], losses[ci, si] = local_step(
                    cl["trainable"], cl["opt_state"], host_batch(batch, device))
            uploads[ci] = trees.select(cl["trainable"], upload_pred)
            if codec is not None:
                uploads[ci], b = roundtrip(codec, uploads[ci], ref=ref, noise=noises[ci])
                bits[ci] = float(b) + act_bits()
        return losses, bits, uploads

    def loop_aggregate(rplan, reports, uploads):
        """The legacy loop's server: the robust round's stacked mirror
        (fresh uploads supersede pending ones, weights ``agg_w``, ``recv``
        gates the merge, ``rejoin`` zeroes the optimizer), or the
        synchronous mean over the clients out of outage (``fedavg``); each
        client merges its own copy of the aggregate."""
        nonlocal pending
        if robust:
            pending = [uploads[ci] if rplan.train[ci] > 0 else pending[ci]
                       for ci in range(cfg.n_clients)]
            send, recv = (pending if float(rplan.agg_w.sum()) > 0 else None), rplan.recv
            weights = torch.as_tensor(rplan.agg_w, device=device)
        else:
            send = [uploads[ci] for ci, r in enumerate(reports) if not r.outage] or None
            recv = weights = None
        if send is not None:
            agg = agg_fn(trees.stack(send), weights)
            for cl, t in zip(clients, own_copies([cl["trainable"] for cl in clients], agg,
                                                 recv)):
                cl["trainable"] = t
        if robust:
            for ci, cl in enumerate(clients):
                if rplan.rejoin[ci] > 0:
                    cl["opt_state"] = trees.map_leaves(torch.zeros_like, cl["opt_state"])

    accs_per_round, loss_per_round, round_s, bits_per_round = [], [], [], []
    health_per_round = []

    # ---- round-level checkpoint/resume (the engine's, as in JAX): the
    # stacked state restores exactly; the host streams (fading draws,
    # compute-time draws, each client's batches) are replayed to the
    # resume point
    ckpt_file = meta_file = None
    start_round = 0
    if cfg.ckpt_dir and use_engine:
        ckpt_file = os.path.join(cfg.ckpt_dir, f"pftt_{cfg.method}.npz")
        meta_file = os.path.join(cfg.ckpt_dir, f"pftt_{cfg.method}.json")
        if cfg.resume and os.path.exists(ckpt_file):
            # the host state rides inside the npz: the pair cannot disagree
            meta = load_meta(ckpt_file)
            start_round = int(meta["next_round"])
            accs_per_round[:] = meta["accs_per_round"]
            loss_per_round[:] = meta.get("loss_per_round", [])
            health_per_round[:] = meta.get("health_per_round", [])
            ledger.rounds[:] = meta["ledger_rounds"]
            # the file holds the real cohort whatever the world size
            tpl = {"trainable": trees.stack([cl["trainable"] for cl in clients]),
                   "opt": trees.stack([cl["opt_state"] for cl in clients])}
            if robust:
                tpl["pending"] = trees.select(tpl["trainable"], upload_pred)
                tracker.load_state_dict(meta["tracker"])
                if dl is not None and "est_bits" in meta:
                    est_bits = np.asarray(meta["est_bits"], np.float64)
            state = cs.take(load_checkpoint(ckpt_file, tpl))
            cohort_tr, cohort_opt = state["trainable"], state["opt"]
            pending = state.get("pending")
            for _ in range(start_round):          # burn the skipped rounds'
                channel.realize(cfg.n_clients)    # host draws
                if arrivals is not None:
                    arrivals.burn_round()
                for ci in range(cfg.n_clients):
                    for _s in range(cfg.local_steps):
                        next(client_iters[ci])

    run_meta = {"mode": "cohort", "method": cfg.method, "n_clients": cfg.n_clients,
                "rounds": cfg.rounds, "engine": use_engine, "codec": cfg.uplink_codec}
    if start_round > 0:
        tele.resume(start_round, run_meta)
    else:
        tele.start(run_meta)

    for rnd in range(start_round, cfg.rounds):
        t0 = time.perf_counter()
        gains = channel.realize(cfg.n_clients)
        rplan = None
        if robust:
            rf = trace.round(rnd)
            gains = gains * rf.gain_scale       # injected SNR dips
            rplan = tracker.begin_round(rf, channel.outage_weights(gains),
                                        gains=gains, fresh_bits=est_bits)
        if use_engine:
            losses, bits, hstats = engine_round(rnd, gains, rplan)
        else:
            (losses, bits, uploads), hstats = loop_train(rnd, rplan), None
        bits_per_round.append(bits)
        extra = None
        if robust:
            fresh = np.asarray(bits, np.float64)
            charged = tracker.end_round(rplan, fresh)
            reports = round_reports(budget, rplan, charged, gains)
            extra = round_extra(rplan)
            if dl is not None and codec is not None:   # the realized encoded size
                est_bits = np.where(np.asarray(rplan.train) > 0, fresh, est_bits)   # schedules next
        else:
            reports = budget.round_reports(bits, gains)
        ledger.log_round(reports, extra, round_id=rnd)
        if not use_engine:
            loop_aggregate(rplan, reports, uploads)
        with tracer.span("eval"):
            accs = eval_round_accs(cohort_tr if use_engine else
                                   trees.stack([cl["trainable"] for cl in clients]))
        accs_per_round.append(float(np.mean(accs)))
        loss_per_round.append(float(losses.mean()))
        health_per_round.append(None if hstats is None else
                                {k: float(v) for k, v in hstats.items()})
        synchronize(device)
        round_s.append(time.perf_counter() - t0)
        # the round event before the checkpoint (the exactly-once contract:
        # a kill between the two records the round again on resume)
        if tele.enabled:
            if rnd == start_round:   # this process built its kernels here
                tele.compile_event(rnd, tracer.totals().get("device-step", 0.0))
            tele.round_event(rnd, {
                "acc": accs_per_round[-1], "cohort": None,
                "comm": _comm_record(ledger),
                "staleness": tracker.counters() if robust else None,
                "health": health_per_round[-1]}, wall={"phases": tracer.pop_round()})
        if ckpt_file is not None:   # round-level checkpoint (kill-safe)
            with tracer.span("checkpoint"):
                state = {"trainable": cohort_tr, "opt": cohort_opt}
                if robust:
                    state["pending"] = pending
                state = cs.gather_tree(state)    # the real cohort, from every rank
                meta = {"next_round": rnd + 1, "accs_per_round": accs_per_round,
                        "loss_per_round": loss_per_round,
                        "health_per_round": health_per_round, "ledger_rounds": ledger.rounds}
                if robust:
                    meta["tracker"] = tracker.state_dict()
                    if dl is not None:
                        meta["est_bits"] = [float(b) for b in est_bits]
                if cs.lead:
                    save_checkpoint(ckpt_file, state, meta=meta)
                    save_json(meta_file, meta)
            tele.checkpoint(rnd)
        if cfg.verbose and rnd % 5 == 0:
            print(f"[pftt:{cfg.method}] round {rnd} acc {accs_per_round[-1]:.3f} "
                  f"bytes {ledger.rounds[-1]['bytes']:,} "
                  f"outages {ledger.rounds[-1]['outages']}")

    close_run(cfg.telemetry, tele, prof)
    return {
        "method": cfg.method,
        "acc_per_round": accs_per_round,
        "final_acc": accs_per_round[-1],
        "mean_round_bytes": ledger.mean_round_bytes,
        "mean_round_delay_s": ledger.mean_round_delay,
        "total_bytes": ledger.total_bytes,
        "total_energy_j": ledger.total_energy_j,
        "total_sim_time_s": ledger.total_sim_time_s,
        "quorum_noops": ledger.quorum_noops,
        "round_records": ledger.rounds,
        "uplink_codec": cfg.uplink_codec,
        "eval_dispatches_per_round": 1.0,   # one cohort-eval call a round
        "fused_engine": use_engine,         # False: the legacy per-client loop
        "ragged_cohort": len(set(client_batch_sizes)) > 1,
        "staleness": tracker.counters() if robust else None,
        "loss_per_round": loss_per_round,
        "health_per_round": health_per_round,
        "uplink_bits": {"realized": bits_per_round, "raw": [p * 8 for p in payloads],
                        "upper_bound": None if codec is None else [
                            payload_bits_upper_bound(
                                codec, trees.select(cl["trainable"], upload_pred)) + act_bits()
                            for cl in clients]},
        "pretrain_s": pretrain_s,
        "round_s": round_s,
    }


def _run_pftt_population(cfg: PFTTConfig, init: Optional[Dict] = None, mesh=None,
                         client_axes=None) -> Dict:
    """Sampled-cohort population mode (``cfg.population``): the host holds
    a ``PopulationStore`` of every client's trainable/opt/pending trees;
    each round a ``ClientSampler`` draws a ``cohort_size`` cohort, the
    ``PopulationRunner`` gathers the sampled rows (the server's global
    overlaid into the uploaded subtree: the downlink), the robust round
    body a ``n_clients=cohort_size`` run builds runs once, and the rows are
    copied back.  The ``StalenessTracker`` spans the population, so a
    straggler's pending payload survives rounds it is not sampled in.
    Non-IID data, availability and mobility come from the
    ``wireless.scenarios.Scenario`` trace; a ``FaultPlan`` and a
    ``DeadlineConfig`` compose on top as in cohort mode.

    ``init`` as ``run_pftt``'s, its ``"lora"`` holding every population
    client's (JAX's ``fold_in(key, 100 + i)`` draws); without it client i's
    LoRA comes from its own generator.  ``codec_noise`` is keyed by client
    id.  ``ckpt_dir`` saves the store, the global and the runner's host
    state (sampler mid-stream, tracker, reset flags) in one atomic npz.
    ``mesh``: the cohort is sharded over the ranks, every rank holding the
    whole store (``PopulationRunner``'s ghost rows and gathers)."""
    from repro_torch.comms.streams import stream_key
    from repro_torch.fl.population import (ClientSampler, CohortTestSets, PopulationData,
                                           PopulationRunner, PopulationStore,
                                           stacked_client_init)
    from repro_torch.wireless.scenarios import Scenario

    pop = cfg.population
    if not cfg.engine:
        raise ValueError("population mode runs the fused engine only "
                         "(PFTTConfig(engine=True))")
    N, K = pop.population, pop.cohort_size
    scen = pop.scenario or Scenario()
    if scen.n_classes != 4:
        raise ValueError("the PFTT classification task is 4-class; "
                         f"scenario has n_classes={scen.n_classes}")
    cs = cohort_sharding(mesh, K, client_axes)
    cfg = cfg if cs.lead else dataclasses.replace(cfg, verbose=False)
    codec = _codec(cfg, init)
    (model, mcfg, params, peft_cfg, corpus, gen, rng, use_lora,
     pretrain_s) = _setup_backbone(cfg, init)
    device = model.device
    strace = scen.realize(N, cfg.rounds)

    # ---- a shared class-bucketed pool; clients draw lazily from their
    # Dirichlet label distribution (nothing to replay on resume)
    pool_n = int(np.clip(cfg.samples_per_client * 16, 1024, 16384))
    pool = corpus.sample(pool_n, rng=rng)
    data = PopulationData(pool, strace.class_probs, seed=cfg.seed)

    # ---- the N-client store, on the host
    opt = adamw(cfg.lr, update_mask=lambda p: not p.endswith("/mask"))
    upload_pred = _upload_pred(cfg.method)

    def client_init(i):
        lora = None
        if use_lora:
            lora = (bridge.lora_from_numpy(init["lora"][i], mcfg, device=device)
                    if init is not None else peft_mod.init_lora(
                        torch.Generator().manual_seed(stream_key(cfg.seed, 100 + i)),
                        params, peft_cfg))
        t = _build_trainable(cfg.method, params, lora)
        return {"t": t, "o": opt.init(t)}

    stacked = stacked_client_init(client_init, N)
    pend_np = trees.map_leaves(np.zeros_like, trees.select(stacked["t"], upload_pred))
    store = PopulationStore({"trainable": stacked["t"], "opt": stacked["o"],
                             "pending": pend_np})
    shared0 = trees.select(store.row("trainable", 0), upload_pred)
    global_shared = trees.map_leaves(np.array, shared0)
    shared0_t = trees.map_leaves(torch.from_numpy, shared0)

    # ---- the wireless runtime over the POPULATION
    channel = RayleighChannel(mean_snr_db=cfg.snr_db, seed=cfg.seed)
    budget = ChannelBudget(channel, tx_power_w=cfg.tx_power_w)
    ledger = CommLedger()
    dl, trace, tracker = robust_runtime(cfg, channel, N, always=True)
    ab = 0.0 if cfg.method != "fedbert" else \
        cfg.local_steps * cfg.batch * cfg.seq_len * cfg.d_model * 4 * 2 * 8
    payload_bits = tree_bytes(shared0_t) * 8 + ab
    est_bits = None
    if dl is not None:
        est_bits = np.full(N, payload_bits if codec is None else
                           payload_bits_upper_bound(codec, shared0_t) + ab, np.float64)
    codec_noise = None if codec is None else (
        (init or {}).get("codec_noise")
        or functools.partial(codec_uniforms, cfg.seed, device=device))

    # ---- the round body: the one a cohort_size-client robust run builds
    effective = _effective_fn(cfg, params, peft_cfg)

    def local_step(trainable, opt_state, batch):
        def loss_fn(t):
            full, lora, ls = effective(t)
            return model.cls_loss(full, batch, lora=lora, lora_scale=ls)[0]
        loss, g = value_and_grad(loss_fn, trainable)
        upd, opt_state = opt.update(g, opt_state, trainable)
        return trees.tree_add(trainable, upd), opt_state, loss

    # ---- observability: the runner owns the round's spans
    tracer, tele, health, prof = open_run(cfg.telemetry, device, write=cs.lead)
    round_step = build_supervised_round(
        local_step, upload_pred, cs=cs, codec=codec, factored_agg=cfg.factored_agg,
        robust=True, min_quorum=dl.min_quorum if dl is not None else 0, health=health)
    runner = PopulationRunner(
        pop=pop, store=store, global_shared=global_shared, upload_pred=upload_pred,
        channel=channel, budget=budget, ledger=ledger, tracker=tracker, trace=trace,
        strace=strace, sampler=ClientSampler(pop.sampler, N, K,
                                             seed=cfg.seed + 1000 * pop.seed),
        device=device, arrivals=tracker.arrivals, dl=dl, cs=cs, est_bits=est_bits,
        act_bits=ab, tracer=tracer, health=health)
    stacker = HostBatchStacker(device, rows=cs.rows)

    # ---- cohort eval: the sampled clients' held-out draws refill one
    # buffer and score in one cohort-eval call a round (ghost rows: no valid
    # sample)
    n_eval = int(min(max(cfg.test_samples, 4), 64))
    test_sets = CohortTestSets(data, n_eval, ("tokens", "label"))
    e_valid = torch.from_numpy(np.repeat(cs.take_vec(np.ones(K)), n_eval)
                               .reshape(-1, n_eval)).to(device)

    def eval_client(trainable, tokens, label, valid):
        full, lora, ls = effective(trainable)
        hidden, _ = model.forward(full, tokens, lora=lora, lora_scale=ls)
        pred = (hidden[:, 0] @ full["cls_head"]).float().argmax(-1)
        correct = (pred == label).float() * valid
        return correct.sum(), valid.sum()

    eval_cohort = build_cohort_eval(eval_client, mesh=mesh)

    def eval_ids(cohort_tr, ids):
        corr, cnt = (t.cpu().numpy() for t in eval_cohort(
            cohort_tr, *test_sets(cs.local(ids), device), e_valid))
        return [float(c / n) for c, n in zip(corr, cnt) if n > 0]

    def draw(cid, rnd):
        return data.round_batches(cid, rnd, cfg.local_steps, cfg.batch)

    # ---- checkpoint/resume: the store, the global and the runner's host
    # state in one npz; the channel and arrival draws are burnt
    accs_per_round: List[float] = []
    loss_per_round: List[float] = []
    health_per_round: List = []
    cohorts: List[List[int]] = []
    ckpt_file = meta_file = None
    start_round = 0
    if cfg.ckpt_dir:
        ckpt_file = os.path.join(cfg.ckpt_dir, f"pftt_pop_{cfg.method}.npz")
        meta_file = os.path.join(cfg.ckpt_dir, f"pftt_pop_{cfg.method}.json")
        if cfg.resume and os.path.exists(ckpt_file):
            meta = load_meta(ckpt_file)
            start_round = int(meta["next_round"])
            accs_per_round[:] = meta["accs_per_round"]
            loss_per_round[:] = meta["loss_per_round"]
            health_per_round[:] = meta["health_per_round"]
            cohorts[:] = meta["cohorts"]
            ledger.rounds[:] = meta["ledger_rounds"]
            runner.load_state_dict(meta["runner"])
            runner.load_checkpoint_tree(load_checkpoint(ckpt_file, runner.checkpoint_tree()))
            runner.burn_rounds(start_round)

    run_meta = {"mode": "population", "method": cfg.method, "population": N, "cohort": K,
                "rounds": cfg.rounds, "sampler": pop.sampler, "codec": cfg.uplink_codec}
    if start_round > 0:
        tele.resume(start_round, run_meta)
    else:
        tele.start(run_meta)

    for rnd in range(start_round, cfg.rounds):
        out = runner.run_round(rnd, round_step=round_step, stacker=stacker,
                               draw_batches=draw, payload_bits=payload_bits,
                               codec_noise=codec_noise)
        with tracer.span("eval"):
            accs = eval_ids(out["cohort_tr"], out["ids"])
        accs_per_round.append(float(np.mean(accs)) if accs else 0.0)
        loss_per_round.append(float(out["losses"].mean()))
        health_per_round.append(out["health"])
        cohorts.append([int(i) for i in out["ids"]])
        # the round event before the checkpoint, as in run_pftt
        if tele.enabled:
            if rnd == start_round:
                tele.compile_event(rnd, tracer.totals().get("device-step", 0.0))
            tele.round_event(rnd, {
                "acc": accs_per_round[-1], "cohort": cohorts[-1],
                "comm": _comm_record(ledger), "staleness": tracker.counters(),
                "health": out["health"]}, wall={"phases": tracer.pop_round()})
        if ckpt_file is not None:
            with tracer.span("checkpoint"):
                meta = {"next_round": rnd + 1, "accs_per_round": accs_per_round,
                        "loss_per_round": loss_per_round,
                        "health_per_round": health_per_round, "cohorts": cohorts,
                        "ledger_rounds": ledger.rounds, "runner": runner.state_dict()}
                if cs.lead:    # every rank holds the same store
                    save_checkpoint(ckpt_file, runner.checkpoint_tree(), meta=meta)
                    save_json(meta_file, meta)
            tele.checkpoint(rnd)
        if cfg.verbose and rnd % 5 == 0:
            print(f"[pftt-pop:{cfg.method}] round {rnd} "
                  f"cohort acc {accs_per_round[-1]:.3f} "
                  f"sampled {cohorts[-1][:8]}… "
                  f"host {runner.host_overhead_frac:.1%}")

    close_run(cfg.telemetry, tele, prof)
    return {
        "method": cfg.method,
        "acc_per_round": accs_per_round,
        "final_acc": accs_per_round[-1] if accs_per_round else 0.0,
        "mean_round_bytes": ledger.mean_round_bytes,
        "mean_round_delay_s": ledger.mean_round_delay,
        "total_bytes": ledger.total_bytes,
        "total_energy_j": ledger.total_energy_j,
        "total_sim_time_s": ledger.total_sim_time_s,
        "quorum_noops": ledger.quorum_noops,
        "round_records": ledger.rounds,
        "uplink_codec": cfg.uplink_codec,
        "fused_engine": True,
        "population": N,
        "cohort_size": K,
        "sampler": pop.sampler,
        "scenario": scen.to_dict(),
        "participation_frac": float(runner.seen.mean()),
        "host_overhead_frac": runner.host_overhead_frac,
        "host_s": runner.host_s,
        "round_s": runner.round_s,
        "round_wall": list(runner.round_wall),
        "store_bytes": store.nbytes(),
        "cohorts": cohorts,
        "staleness": tracker.counters(),
        "loss_per_round": loss_per_round,
        "health_per_round": health_per_round,
        "pretrain_s": pretrain_s,
    }
