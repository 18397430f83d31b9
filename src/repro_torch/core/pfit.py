"""PFIT — Personalized Federated Instruction Tuning (paper §IV-C), the port
of ``repro.core.pfit``'s engine path.

Each client fine-tunes the last K layers of a shared policy (a reduced
GPT-2) with PPO against a personalized reward: a client-specific linear
combination of the helpfulness and safety reward models, minus the
squared L2 pull toward the global model.  A head-structured sparsity mask
(the paper's 40 % "sparse attention update") cuts both the trainable
attention parameters and the upload bytes, and the server aggregates only
the masked entries.  Fig. 4's baselines are method variants:

* ``sfl``      — a single reward model (helpfulness only), 20 % sparsity
* ``pfl``      — the personalized double reward, no sparsity
* ``shepherd`` — federated LoRA instruction tuning (supervised, no RLHF),
                 its LoRA trained and served unmerged (``lora_fused``)

Execution goes through the cohort engine (``core/cohort.py``): the PPO
methods through ``build_ppo_round`` (rollouts through the serving path:
causal ``flash_attn`` prefill, ``decode_attn`` decode), shepherd through
``build_supervised_round``.

The JAX package's two parity oracles run too.  ``PFITConfig(factored=
False)`` merges shepherd's LoRA into the global inside its loss and serves
each client's merged copy in the evaluation (no ``lora_fused`` launch).
``PFITConfig(engine=False)`` is the legacy per-client loop: each client
keeps its own trees; shepherd's local steps and the PPO methods' rollout,
double reward, L2 pull and ``PPOTrainer.round`` run client by client
through the same functions as the engine's, each upload coded against the
client's round-input tree; the server aggregates with the list API
(``fedavg``, ``masked_fedavg``) or, robust, the stacked mirror, and every
client merges its own copy.  As in the JAX package the loop ignores
``mesh`` and has no health scalars or ``gather``/``device-step`` spans.

Parity with the JAX package from identical state: ``run_pfit(cfg,
init=...)`` takes the JAX draws as numpy in place of the port's
``torch.Generator`` ones — the policy before pretraining, both reward
models before training, each client's kept heads, each shepherd client's
LoRA — and a Gumbel noise hook for every sampling stream.  Every numpy
draw (corpus, batches, pairs, channel) is the copied code's own.

``fault_plan`` and/or a non-inert ``deadline`` switch both engines to the
straggler-tolerant robust round (``robust=True``; ``core/robust.py``,
``docs/robustness.md``).  The JAX package checkpoints PFTT only; so does
the port.

``uplink_codec`` compresses the uploads inside the round
(``repro_torch.comms``): the PPO methods code each client's whole params
against the round-input params, charged on its sparsity mask; shepherd
codes its LoRA tree, and ``factored_agg`` aggregates shepherd's factor
pairs by the SVD re-projection (the PPO methods have no factors; the flag
leaves them as the JAX package does).  The uniforms come from
``init["codec_noise"](round, client, leaf_index, shape)`` when given, else
``comms.codec.codec_uniforms``; deadline mode schedules a codec's first
upload at ``payload_bits_upper_bound`` and each realized size after.

``telemetry`` threads one ``SpanTracer`` and one ``RunTelemetry`` through
the run as in ``run_pftt`` (spans ``gather``, ``encode``, ``device-step``,
``eval``; ``run``, ``compile`` and ``round`` events); the health scalars
ride shepherd's supervised round only, as in the JAX package (the PPO
body has none).  ``population`` runs shepherd's sampled-cohort population
mode (``_run_pfit_population``); the PPO methods raise the JAX package's
``ValueError`` there.

``run_pfit(cfg, mesh=...)`` shards the cohort over the ranks of a
``sharding.ClientMesh`` as ``run_pftt`` does: every rank makes every host
draw and pretrains the same policy and reward models, runs its rows of the
ghost-padded cohort (rollout noise keyed by client id, never by rank), and
gathers the rewards and bits; each rank evaluates its own real clients and
the per-client rewards are gathered.  Only rank 0 writes telemetry.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import bridge, resolve_device, synchronize, trees
from repro_torch.comms import ChannelBudget, get_codec, payload_bits_upper_bound
from repro_torch.comms.codec import codec_uniforms, roundtrip, round_noises
from repro_torch.configs import get_config
from repro_torch.core.aggregation import (factored_fedavg_stacked, fedavg_stacked,
                                          masked_fedavg, masked_fedavg_stacked)
from repro_torch.core.cohort import (HostBatchStacker, build_cohort_eval, build_ppo_round,
                                     build_supervised_round, host_batch, own_copies)
from repro_torch.core.pftt import _comm_record
from repro_torch.core.robust import round_extra, round_reports, robust_runtime
from repro_torch.core.rewards import ClientPreference, DoubleReward
from repro_torch.data.partition import client_topic_preferences
from repro_torch.data.synthetic import N_TOPICS, InstructionCorpus
from repro_torch.models import peft as peft_mod
from repro_torch.models.transformer import Model
from repro_torch.obs import close_run, open_run
from repro_torch.optim import adamw, value_and_grad
from repro_torch.rlhf.ppo import PPOConfig, PPOTrainer
from repro_torch.rlhf.reward_model import (RewardModel, reward_model_config,
                                           train_reward_model)
from repro_torch.rlhf.rollout import generate, gumbel_stream
from repro_torch.sharding import cohort_sharding
from repro_torch.wireless import (CommLedger, DeadlineConfig, FaultPlan, RayleighChannel,
                                  tree_bytes)

METHODS = ("pfit", "sfl", "pfl", "shepherd")
EVAL_TEMPERATURE = 0.8
EVAL_STREAM = 999          # eval noise streams 999 + ci; rollouts rnd·17 + ci


@dataclasses.dataclass(frozen=True)
class PFITConfig:
    method: str = "pfit"
    n_clients: int = 4
    rounds: int = 20
    rollout_batch: int = 16
    prompt_len: int = 16
    gen_len: int = 24
    last_k: int = 2
    sparsity: float = 0.4          # pfit 0.4 | sfl 0.2 | pfl 0.0
    d_model: int = 128
    n_layers: int = 4
    lr: float = 4e-4
    pretrain_steps: int = 300
    pretrain_lr: float = 1e-3
    rm_steps: int = 250
    lambda_reg: float = 1e-5
    shepherd_steps: int = 10       # supervised LoRA steps per round
    lora_rank: int = 8
    snr_db: float = 5.0
    seed: int = 0
    verbose: bool = False
    engine: bool = True            # the cohort engine (False: legacy loop)
    factored: bool = True          # shepherd's LoRA unmerged (False: the
                                   # merged oracle in training and eval)
    uplink_codec: str = "none"
    factored_agg: bool = False
    tx_power_w: float = 0.5        # uplink transmit power (ChannelBudget)
    fault_plan: Optional[FaultPlan] = None   # the straggler-tolerant robust
                                   # round (the zero plan is bitwise the
                                   # synchronous engine)
    staleness_alpha: float = 1.0   # FedAsync α (cancels under normalization)
    staleness_a: float = 0.0       # staleness exponent a in α·(1+s)^(-a)
    max_staleness: int = 0         # pending payloads older than this drop;
                                   # 0 = synchronous drop-on-failure
    deadline: Optional[DeadlineConfig] = None  # continuous-time round
                                   # (wireless/arrivals.py); inert or None is
                                   # the round-granular robust runtime
    ppo: PPOConfig = PPOConfig()
    population: Optional[object] = None   # fl.PopulationConfig: shepherd's
                                   # sampled-cohort population mode
    telemetry: Optional[object] = None    # obs.TelemetryConfig
    device: Optional[str] = None   # None/"cuda": the GPU (raises without);
                                   # "cpu": the kernels' plain versions


def _method_settings(cfg: PFITConfig):
    if cfg.method == "pfit":
        return dict(sparsity=cfg.sparsity, double=True)
    if cfg.method == "sfl":
        return dict(sparsity=0.2, double=False)
    if cfg.method == "pfl":
        return dict(sparsity=0.0, double=True)
    if cfg.method == "shepherd":
        return dict(sparsity=0.0, double=False)
    raise ValueError(cfg.method)


def _is_stage(path: str) -> bool:
    return path.startswith("stages")


def _shepherd_loss(model, cfg: PFITConfig, global_params, peft_cfg):
    """``loss(lora, batch)``: shepherd's LM loss on the frozen global, the
    LoRA unmerged or (``factored=False``) merged into the weights."""
    lscale = peft_mod.lora_scale(peft_cfg)

    def loss(lora, batch):
        if cfg.factored:
            return model.lm_loss(global_params, batch, lora=lora, lora_scale=lscale)
        return model.lm_loss(peft_mod.apply_lora(global_params, lora, peft_cfg), batch)

    return loss


def _pretrain_policy(model, params, corpus, steps, lr, batch, verbose):
    """LM pretraining on the instruction corpus so that generation is
    topical before RL starts (the "pre-trained LLM" of Step 1); batches
    from numpy ``RandomState(7)``."""
    opt = adamw(lr)
    st = opt.init(params)
    rng = np.random.RandomState(7)
    device = model.device
    loss = None
    for _ in range(steps):
        s = corpus.sample(batch, helpful_p=0.6, unsafe_p=0.3, rng=rng)
        toks = torch.from_numpy(s["tokens"]).to(device)
        batch_d = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                   "mask": torch.from_numpy(s["mask"][:, 1:]).to(device)}
        loss, g = value_and_grad(lambda p: model.lm_loss(p, batch_d), params)
        upd, st = opt.update(g, st, params)
        params = trees.tree_add(params, upd)
    if verbose and loss is not None:
        print(f"[pfit] policy pretrain loss {float(loss):.3f}")
    return params


def run_pfit(cfg: PFITConfig, init: Optional[Dict] = None, mesh=None,
             client_axes=None) -> Dict:
    """The cohort engine for one method, synchronous or robust.  ``init`` (optional,
    the JAX package's draws for parity runs): {"policy": flat numpy params
    before pretraining, "rm_help"/"rm_safe": flat numpy reward-model params
    before training, "keep": each client's kept heads, "lora": each
    shepherd client's flat numpy LoRA, "noise": ``noise(stream, batch) ->
    hook``, "codec_noise": ``(round, client, leaf_index, shape) ->
    uniforms``}; a missing entry is drawn by the port.  Returns the JAX
    package's result keys plus the port's: ``round_records`` (the ledger's
    rounds), ``staleness`` (the tracker's counters; None when synchronous),
    ``train_reward_per_round`` (the clients' mean rollout reward, PPO
    methods; a non-training client's counted as 0), ``rollouts_round0``
    and ``eval_round0`` (round 0's sampled tokens and per-step sampling
    margins, per client, numpy), ``health_per_round`` (shepherd with
    telemetry; else Nones) and
    the timings ``pretrain_s``, ``rm_s`` and ``round_s`` (a round's
    training, ledger and evaluation, host clock ending in a synchronize).
    ``mesh`` (+ ``client_axes``): shard the cohort (module docstring);
    ``rollouts_round0``/``eval_round0`` then hold this rank's clients."""
    if cfg.method not in METHODS:
        raise ValueError(f"method {cfg.method!r} not in {METHODS}")
    if cfg.population is not None:
        return _run_pfit_population(cfg, init, mesh, client_axes)
    use_engine = cfg.engine
    # this process's rows (the legacy loop ignores ``mesh``, as JAX's does)
    cs = cohort_sharding(mesh if use_engine else None, cfg.n_clients, client_axes)
    cfg = cfg if cs.lead else dataclasses.replace(cfg, verbose=False)
    codec = get_codec(cfg.uplink_codec)
    init = init or {}
    ms = _method_settings(cfg)
    device = resolve_device(cfg.device)
    rng = np.random.RandomState(cfg.seed)
    gen = torch.Generator().manual_seed(cfg.seed)

    # ---- policy: reduced GPT-2 (the paper's local LLM), LM-pretrained
    mcfg = get_config("gpt2-small").reduced(d_model=cfg.d_model, repeats=cfg.n_layers)
    model = Model(mcfg, device=device)
    corpus = InstructionCorpus(seq_len=cfg.prompt_len + cfg.gen_len,
                               prompt_len=cfg.prompt_len, seed=cfg.seed)
    params = (bridge.params_from_numpy(init["policy"], mcfg, device=device)
              if "policy" in init else model.init(gen))
    synchronize(device)
    t0 = time.perf_counter()
    params = _pretrain_policy(model, params, corpus, cfg.pretrain_steps,
                              cfg.pretrain_lr, 16, cfg.verbose)
    synchronize(device)
    pretrain_s = time.perf_counter() - t0
    params["value_head"] = torch.zeros((mcfg.d_model, 1), device=device)

    # ---- double reward models (helpfulness + safety), BT-trained
    rm_data = corpus.sample(1024, helpful_p=0.5, unsafe_p=0.4, rng=rng)

    def reward_model(name):
        rm = RewardModel.create(gen, device=device)
        if name in init:
            rm.params = bridge.params_from_numpy(init[name], reward_model_config(),
                                                 device=device)
        return rm

    t0 = time.perf_counter()
    rm_h = reward_model("rm_help")
    rm_h_params, rmh_stats = train_reward_model(rm_h, rm_data, "help", steps=cfg.rm_steps)
    rm_s = reward_model("rm_safe")
    rm_s_params, rms_stats = train_reward_model(rm_s, rm_data, "safe", steps=cfg.rm_steps)
    synchronize(device)
    rm_s_time = time.perf_counter() - t0
    double = DoubleReward(rm_h, rm_h_params, rm_s, rm_s_params)
    if cfg.verbose:
        print(f"[pfit] rm pair-acc help={rmh_stats['pair_acc']:.3f} "
              f"safe={rms_stats['pair_acc']:.3f}")

    # ---- clients: diverse (α_help, α_safe) preferences + topic skew
    topic_prefs = client_topic_preferences(cfg.n_clients, N_TOPICS, 0.3, seed=cfg.seed)
    prefs = []
    for ci in range(cfg.n_clients):
        a = ci / max(cfg.n_clients - 1, 1)       # 0 … 1
        if ms["double"]:
            prefs.append(ClientPreference(alpha_help=0.25 + 0.5 * a,
                                          alpha_safe=0.75 - 0.5 * a,
                                          lambda_reg=cfg.lambda_reg))
        else:  # single (helpfulness-only) reward model
            prefs.append(ClientPreference(alpha_help=1.0, alpha_safe=0.0,
                                          lambda_reg=cfg.lambda_reg))

    # ---- trainable masks: last-K layers × head sparsity (paper Step 1)
    lastk_mask = peft_mod.last_k_layers_mask(params, mcfg, cfg.last_k)
    keeps = init.get("keep", [None] * cfg.n_clients)
    client_masks = [
        trees.map_leaves(lambda a, b: a * b, lastk_mask,
                         peft_mod.head_sparsity_mask(params, mcfg, ms["sparsity"],
                                                     seed=cfg.seed + ci, keep=keeps[ci]))
        for ci in range(cfg.n_clients)]

    opt = adamw(cfg.lr)
    peft_cfg = peft_mod.PEFTConfig(lora_rank=cfg.lora_rank,
                                   lora_targets=("mixer/wq", "mixer/wv"))
    lscale = peft_mod.lora_scale(peft_cfg)
    global_params = params
    shepherd = cfg.method == "shepherd"
    loras = []
    if shepherd:
        loras = [bridge.lora_from_numpy(init["lora"][ci], mcfg, device=device)
                 if "lora" in init else peft_mod.init_lora(gen, params, peft_cfg)
                 for ci in range(cfg.n_clients)]
    # the loop's per-client trees: shepherd's LoRA, or the PPO methods' params
    kind = "lora" if shepherd else "params"
    clients = [] if use_engine else [
        {kind: t, "opt_state": opt.init(t)}
        for t in (loras if shepherd else [params] * cfg.n_clients)]
    shepherd_loss = _shepherd_loss(model, cfg, global_params, peft_cfg)

    def shepherd_local_step(lora, opt_state, batch):
        """Supervised LoRA step on the frozen global (the factors unmerged,
        or merged under ``factored=False``)."""
        loss, g = value_and_grad(lambda lo: shepherd_loss(lo, batch), lora)
        upd, opt_state = opt.update(g, opt_state, lora)
        return trees.tree_add(lora, upd), opt_state, loss

    channel = RayleighChannel(mean_snr_db=cfg.snr_db, seed=cfg.seed)
    budget = ChannelBudget(channel, tx_power_w=cfg.tx_power_w)
    ledger = CommLedger()

    vocab = mcfg.vocab_size
    noise_for: Callable = init.get("noise") or (
        lambda stream, batch: gumbel_stream(cfg.seed, stream, cfg.gen_len, batch,
                                            vocab, device))

    def quality_fn(toks, mask, ah, asafe):
        return double.quality(toks, mask, ClientPreference(ah, asafe))

    # fixed eval prompt sets and noise per client (the same every round)
    eval_prompts, eval_noise = [], []
    for ci in range(cfg.n_clients):
        s = corpus.sample(2 * cfg.rollout_batch, topic_probs=topic_prefs[ci],
                          rng=np.random.RandomState(1000 + ci))
        eval_prompts.append(torch.from_numpy(s["tokens"][:, :cfg.prompt_len]).to(device))
        eval_noise.append(noise_for(EVAL_STREAM + ci, 2 * cfg.rollout_batch))
    eval_mask = torch.cat([torch.zeros(2 * cfg.rollout_batch, cfg.prompt_len, device=device),
                           torch.ones(2 * cfg.rollout_batch, cfg.gen_len, device=device)], 1)

    def eval_reward(client_params, client_loras=None, record=None):
        """Mean personalized quality reward on the fixed eval prompts over
        the real clients, each rank scoring its own rows (ghosts score 0,
        dropped after the gather); ``client_loras[i]`` serves row i's LoRA
        unmerged.  ``record`` (a list) receives each client's (tokens,
        margins)."""
        vals = []
        for i, (ci, p) in enumerate(zip(cs.local(range(cfg.n_clients)), client_params)):
            if cs.rows.start + i >= cfg.n_clients:     # a ghost row
                vals.append(torch.zeros((), device=device))
                continue
            margins = None if record is None else []
            toks = generate(model, p, eval_prompts[ci], cfg.gen_len, eval_noise[ci],
                            temperature=EVAL_TEMPERATURE, margins=margins,
                            lora=None if client_loras is None else client_loras[i],
                            lora_scale=lscale)
            if record is not None:
                record.append((toks, torch.stack(margins, 1)))
            with torch.no_grad():
                vals.append(quality_fn(toks, eval_mask, prefs[ci].alpha_help,
                                       prefs[ci].alpha_safe).mean())
        return float(cs.gather(torch.stack(vals)).double().mean())

    def eval_round(client_trees, record):
        """The round's evaluation over each client's tree (shepherd's LoRA:
        served unmerged beside the shared base, or merged into its own copy
        under ``factored=False``; the PPO methods' params)."""
        if not shepherd:
            return eval_reward(client_trees, record=record)
        if cfg.factored:
            return eval_reward([global_params] * len(client_trees), client_trees, record=record)
        return eval_reward([peft_mod.merge_lora(global_params, lo, peft_cfg)
                            for lo in client_trees], record=record)

    # ---- the straggler-tolerant runtime (core/robust.py, wireless/faults.py)
    dl, trace, tracker = robust_runtime(cfg, channel)
    robust = tracker is not None
    min_quorum = dl.min_quorum if dl is not None else 0

    # ---- observability: health rides the engine's shepherd round only
    tracer, tele, health, prof = open_run(cfg.telemetry, device, write=cs.lead)
    health = health and shepherd and use_engine

    payloads = ([tree_bytes(lo) for lo in loras] if shepherd else
                [tree_bytes(params, nonzero_mask=client_masks[ci])
                 for ci in range(cfg.n_clients)])
    if use_engine and shepherd:
        round_step = build_supervised_round(shepherd_local_step, codec=codec,
                                            factored_agg=cfg.factored_agg, robust=robust,
                                            min_quorum=min_quorum, health=health, cs=cs)
        cohort_tr = cs.take(trees.stack(loras))
        cohort_opt = cs.take(trees.stack([opt.init(lo) for lo in loras]))
        stacker = HostBatchStacker(device, rows=cs.rows)
    elif use_engine:
        ppo_round_step = build_ppo_round(
            model, opt, cfg.ppo, cfg.prompt_len, cfg.gen_len, quality_fn,
            lambda_regs=[p.lambda_reg for p in prefs], codec=codec, robust=robust,
            min_quorum=min_quorum, cs=cs)
        cohort_tr = trees.stack([params] * cs.n_local)
        cohort_opt = trees.stack([opt.init(params)] * cs.n_local)
        st_masks = cs.take(trees.stack(client_masks))
    else:
        ppo = PPOTrainer(model, opt, cfg.ppo, cfg.prompt_len)
    # the pending-payload buffer (zeros never merge: their weight is 0; the
    # loop keeps one tree a client) and the deadline round's scheduling
    # sizes (exact for uncompressed uploads; a codec's worst case until a
    # realized size replaces it)
    pending = None
    if robust:
        pending = (trees.map_leaves(torch.zeros_like, cohort_tr) if use_engine else
                   [trees.map_leaves(torch.zeros_like, cl[kind]) for cl in clients])
    est_bits = None
    if dl is not None:
        est_bits = np.asarray(
            [p * 8 for p in payloads] if codec is None else
            [payload_bits_upper_bound(codec, t) for t in
             (loras if shepherd else [params] * cfg.n_clients)],
            np.float64)
    codec_noise = init.get("codec_noise") or functools.partial(
        codec_uniforms, cfg.seed, device=device)

    def vec(v, fill=0.0):
        """A round vector on the device: this rank's rows, ghosts ``fill``."""
        return torch.from_numpy(cs.take_vec(v, fill)).to(device)

    def shepherd_batch(ci):
        s = corpus.sample(cfg.rollout_batch, topic_probs=topic_prefs[ci],
                          helpful_p=0.9, unsafe_p=0.05, rng=rng)
        return {"tokens": s["tokens"][:, :-1], "labels": s["tokens"][:, 1:],
                "mask": s["mask"][:, 1:]}

    def engine_round(rnd, gains, rplan, record):
        """One round of the cohort engine: (each client's mean rollout
        reward or None, the clients' payload bits, the health scalars or
        None)."""
        nonlocal cohort_tr, cohort_opt, global_params, pending
        if robust:
            # deadline mode: the pre-deadline weights and the on-time mask
            # apart (the body multiplies them and derives the quorum gate)
            ontime = rplan.ontime if dl is not None else np.ones(cfg.n_clients, np.float32)
            margs = (vec(rplan.agg_w_pre if dl is not None else rplan.agg_w),
                     vec(rplan.train, 1.0), vec(rplan.recv, 1.0), vec(rplan.rejoin),
                     vec(ontime, 1.0))
        else:
            weights = vec(channel.outage_weights(gains))
        noise_arg = ()
        if codec is not None:
            with tracer.span("encode"):
                noise_arg = (cs.local(round_noises(codec_noise, rnd, cfg.n_clients)),)
        # every client's batches or prompts and noise streams are drawn every
        # round, training or not: the host streams stay aligned
        mean_rewards = None
        if shepherd:
            with tracer.span("gather"):
                batches = stacker(cs.pad([[shepherd_batch(ci)
                                           for _ in range(cfg.shepherd_steps)]
                                          for ci in range(cfg.n_clients)]))
            with tracer.span("device-step"):
                if robust:
                    agg_w, train_m, recv_m, rejoin_m, ontime_m = margs
                    outs = round_step(cohort_tr, cohort_opt, pending, batches, train_m, agg_w,
                                      recv_m, rejoin_m, ontime_m, *noise_arg)
                    cohort_tr, cohort_opt, pending = outs[:3]
                else:
                    outs = round_step(cohort_tr, cohort_opt, batches, weights, *noise_arg)
                    cohort_tr, cohort_opt = outs[:2]
                synchronize(device)
            # the bits follow the losses; the health dict comes last
            bits_out = outs[4 if robust else 3] if codec is not None else None
        else:
            with tracer.span("gather"):
                prompts = torch.from_numpy(np.stack(cs.local(
                    [corpus.sample(cfg.rollout_batch, topic_probs=topic_prefs[ci],
                                   rng=rng)["tokens"][:, :cfg.prompt_len]
                     for ci in range(cfg.n_clients)]))).to(device)
                noises = [noise_for(rnd * 17 + ci, cfg.rollout_batch)
                          for ci in cs.local(range(cfg.n_clients))]
            alphas = (cs.local([p.alpha_help for p in prefs]),
                      cs.local([p.alpha_safe for p in prefs]))
            with tracer.span("device-step"):
                if robust:
                    outs = ppo_round_step(cohort_tr, cohort_opt, global_params, pending,
                                          st_masks, prompts, noises, *alphas, *margs,
                                          *noise_arg, rollouts=record)
                    cohort_tr, cohort_opt, global_params, pending, mean_rewards = outs[:5]
                else:
                    outs = ppo_round_step(cohort_tr, cohort_opt, global_params, st_masks,
                                          prompts, noises, *alphas, weights, *noise_arg,
                                          rollouts=record)
                    cohort_tr, cohort_opt, global_params, mean_rewards = outs[:4]
                synchronize(device)
            mean_rewards = cs.gather(mean_rewards)
            bits_out = outs[-1] if codec is not None else None   # its last output
        # the engine's realized payload bits with a codec
        bits = ([p * 8 for p in payloads] if codec is None
                else cs.gather(bits_out).tolist())
        return mean_rewards, bits, outs[-1] if health else None

    def loop_train(rnd, rplan, record):
        """The legacy loop's training: each client in turn on its own trees
        — shepherd's local steps, or a rollout, the double reward less
        ``λ_reg`` times the L2 distance of the stages to the global (both
        before the round) and ``PPOTrainer.round`` under the client's mask —
        then its upload coded against its round-input tree.  Returns (each
        client's mean rollout reward or None, the clients' payload bits,
        their uploads: None where a client did not train)."""
        noises = None if codec is None else round_noises(codec_noise, rnd, cfg.n_clients)
        mean_rewards = None if shepherd else torch.zeros(cfg.n_clients, device=device)
        bits = [p * 8 for p in payloads] if codec is None else [0.0] * cfg.n_clients
        uploads = [None] * cfg.n_clients
        resp = torch.cat([torch.zeros(cfg.rollout_batch, cfg.prompt_len, device=device),
                          torch.ones(cfg.rollout_batch, cfg.gen_len, device=device)], 1)
        # every client draws its round's samples even when a fault skips its
        # training: the host stream stays the engine's
        draws = [[shepherd_batch(ci) for _ in range(cfg.shepherd_steps)] if shepherd else
                 corpus.sample(cfg.rollout_batch, topic_probs=topic_prefs[ci], rng=rng)
                 for ci in range(cfg.n_clients)]
        for ci, cl in enumerate(clients):
            if robust and rplan.train[ci] == 0:
                continue
            ref = cl[kind]                                   # the round-input tree
            if shepherd:
                for b in draws[ci]:
                    cl["lora"], cl["opt_state"], _ = shepherd_local_step(
                        cl["lora"], cl["opt_state"], host_batch(b, device))
            else:
                margins = None if record is None else []
                prompts = torch.from_numpy(draws[ci]["tokens"][:, :cfg.prompt_len]).to(device)
                toks = generate(model, cl["params"], prompts, cfg.gen_len,
                                noise_for(rnd * 17 + ci, cfg.rollout_batch),
                                temperature=cfg.ppo.temperature, margins=margins)
                if record is not None:
                    record.append((toks, torch.stack(margins, 1)))
                with torch.no_grad():
                    reward = quality_fn(toks, resp, prefs[ci].alpha_help, prefs[ci].alpha_safe)
                    if prefs[ci].lambda_reg > 0:
                        reward = reward - prefs[ci].lambda_reg * trees.tree_l2(
                            trees.select(cl["params"], _is_stage),
                            trees.select(global_params, _is_stage))
                cl["params"], cl["opt_state"], _ = ppo.round(
                    cl["params"], global_params, cl["opt_state"], toks, reward,
                    grad_mask=client_masks[ci])
                mean_rewards[ci] = reward.mean()
            uploads[ci] = cl[kind]
            if codec is not None:
                uploads[ci], b = roundtrip(
                    codec, cl[kind], ref=ref, noise=noises[ci],
                    bit_weights=None if shepherd else client_masks[ci])
                bits[ci] = float(b)
        return mean_rewards, bits, uploads

    def loop_aggregate(rplan, reports, uploads):
        """The legacy loop's server: shepherd's (factored) FedAvg of the
        LoRA, or the PPO methods' masked FedAvg against the global and the
        masked broadcast; the robust round's stacked mirror (fresh uploads
        supersede pending ones, weights ``agg_w``, ``recv`` gates the merge,
        ``rejoin`` zeroes the optimizer) or the synchronous mean over the
        clients out of outage.  Each client merges its own copy."""
        nonlocal global_params, pending
        if robust:
            pending = [uploads[ci] if rplan.train[ci] > 0 else pending[ci]
                       for ci in range(cfg.n_clients)]
            send, recv = (pending if float(rplan.agg_w.sum()) > 0 else None), rplan.recv
            weights = torch.as_tensor(rplan.agg_w, device=device)
        else:
            alive = [ci for ci, r in enumerate(reports) if not r.outage]
            send, recv, weights = [uploads[ci] for ci in alive] or None, None, None
        if send is not None and shepherd:
            agg = (factored_fedavg_stacked if cfg.factored_agg else fedavg_stacked)(
                trees.stack(send), weights)
            for cl, lo in zip(clients, own_copies([cl["lora"] for cl in clients], agg, recv)):
                cl["lora"] = lo
        elif send is not None:
            global_params = (masked_fedavg_stacked(global_params, trees.stack(send),
                                                   trees.stack(client_masks), weights)
                             if robust else
                             masked_fedavg(global_params, send,
                                           [client_masks[ci] for ci in alive]))
            # clients resume from the global on their masked entries
            for ci, cl in enumerate(clients):
                if recv is None or recv[ci] > 0:
                    cl["params"] = trees.map_leaves(
                        lambda loc, glob, m: torch.where(
                            torch.broadcast_to(m, loc.shape) > 0, glob.to(loc.dtype), loc),
                        cl["params"], global_params, client_masks[ci])
        if robust:
            for ci, cl in enumerate(clients):
                if rplan.rejoin[ci] > 0:
                    cl["opt_state"] = trees.map_leaves(torch.zeros_like, cl["opt_state"])

    reward_curve, train_reward, round_s, health_per_round = [], [], [], []
    rollouts0, eval0 = [], []
    tele.start({"mode": "cohort", "method": cfg.method, "n_clients": cfg.n_clients,
                "rounds": cfg.rounds, "engine": use_engine, "codec": cfg.uplink_codec})
    for rnd in range(cfg.rounds):
        t0 = time.perf_counter()
        gains = channel.realize(cfg.n_clients)
        rplan = None
        if robust:
            rf = trace.round(rnd)
            gains = gains * rf.gain_scale       # injected SNR dips
            rplan = tracker.begin_round(rf, channel.outage_weights(gains),
                                        gains=gains, fresh_bits=est_bits)
        record = rollouts0 if rnd == 0 else None
        if use_engine:
            mean_rewards, bits, hstats = engine_round(rnd, gains, rplan, record)
        else:
            (mean_rewards, bits, uploads), hstats = loop_train(rnd, rplan, record), None
        if mean_rewards is not None:
            train_reward.append(float(mean_rewards.mean()))
        extra = None
        if robust:
            fresh = np.asarray(bits, np.float64)
            charged = tracker.end_round(rplan, fresh)
            reports = round_reports(budget, rplan, charged, gains)
            extra = round_extra(rplan)
            if dl is not None and codec is not None:   # the realized encoded size
                est_bits = np.where(np.asarray(rplan.train) > 0, fresh, est_bits)
        else:
            reports = budget.round_reports(bits, gains)
        ledger.log_round(reports, extra, round_id=rnd)
        if not use_engine:
            loop_aggregate(rplan, reports, uploads)

        record = eval0 if rnd == 0 else None
        with tracer.span("eval"):
            reward_curve.append(eval_round(
                trees.unstack(cohort_tr) if use_engine else [cl[kind] for cl in clients],
                record))
        health_per_round.append(None if hstats is None else
                                {k: float(v) for k, v in hstats.items()})
        synchronize(device)
        round_s.append(time.perf_counter() - t0)
        if tele.enabled:
            if rnd == 0:   # the kernels are built at their first use, here
                tele.compile_event(rnd, tracer.totals().get("device-step", 0.0))
            tele.round_event(rnd, {
                "reward": reward_curve[-1], "cohort": None,
                "comm": _comm_record(ledger),
                "staleness": tracker.counters() if robust else None,
                "health": health_per_round[-1]}, wall={"phases": tracer.pop_round()})
        if cfg.verbose:
            print(f"[pfit:{cfg.method}] round {rnd} reward {reward_curve[-1]:.4f} "
                  f"bytes {ledger.rounds[-1]['bytes']:,}")

    close_run(cfg.telemetry, tele, prof)

    def to_np(recs):
        return [{"tokens": t.cpu().numpy(), "margin": m.cpu().numpy()} for t, m in recs]

    return {
        "method": cfg.method,
        "reward_per_round": reward_curve,
        "final_reward": reward_curve[-1],
        "mean_round_bytes": ledger.mean_round_bytes,
        "mean_round_delay_s": ledger.mean_round_delay,
        "total_bytes": ledger.total_bytes,
        "total_energy_j": ledger.total_energy_j,
        "total_sim_time_s": ledger.total_sim_time_s,
        "quorum_noops": ledger.quorum_noops,
        "uplink_codec": cfg.uplink_codec,
        "rm_pair_acc": {"help": rmh_stats["pair_acc"], "safe": rms_stats["pair_acc"]},
        "round_records": ledger.rounds,
        "fused_engine": use_engine,         # False: the legacy per-client loop
        "staleness": tracker.counters() if robust else None,
        "train_reward_per_round": train_reward,
        "rollouts_round0": to_np(rollouts0),
        "eval_round0": to_np(eval0),
        "health_per_round": health_per_round,
        "pretrain_s": pretrain_s,
        "rm_s": rm_s_time,
        "round_s": round_s,
    }


def _run_pfit_population(cfg: PFITConfig, init: Optional[Dict] = None, mesh=None,
                         client_axes=None) -> Dict:
    """Sampled-cohort population mode for the shepherd baseline: a
    ``PopulationStore`` of every client's LoRA/opt/pending trees, per-round
    sampling and gather/scatter around the supervised robust round body,
    the ``StalenessTracker`` spanning the population.  Non-IID here is a
    per-client TOPIC skew (the scenario's Dirichlet draw over the
    instruction corpus's ``N_TOPICS``).  Each round is scored by the
    sampled clients' LM loss on a held-out topical draw, as in the JAX
    package (generation stays in cohort mode).  The PPO methods raise, as
    in the JAX package: they carry full per-client parameter trees.

    ``init``: {"policy": flat numpy params before pretraining, "lora": every
    client's flat numpy LoRA (JAX's ``fold_in(key, 200 + i)``),
    "codec_noise": keyed by client id}; without it client i's LoRA comes
    from its own generator.  ``mesh``: the cohort sharded over the ranks,
    every rank holding the whole store (``PopulationRunner``)."""
    from repro_torch.comms.streams import stream_key
    from repro_torch.fl.population import (ClientSampler, CohortTestSets, PopulationData,
                                           PopulationRunner, PopulationStore,
                                           stacked_client_init)
    from repro_torch.wireless.scenarios import Scenario

    pop = cfg.population
    if cfg.method != "shepherd":
        raise ValueError(
            "population mode supports the shepherd (supervised LoRA) "
            f"method only, not {cfg.method!r}: PPO methods carry full "
            "per-client parameter trees, which don't fit the "
            "KB-per-client population regime")
    if not cfg.engine:
        raise ValueError("population mode runs the fused engine only")
    N, K = pop.population, pop.cohort_size
    scen = pop.scenario or Scenario(n_classes=N_TOPICS)
    if scen.n_classes != N_TOPICS:
        raise ValueError(f"pfit population scenarios partition over the "
                         f"instruction corpus's {N_TOPICS} topics; got "
                         f"n_classes={scen.n_classes}")
    cs = cohort_sharding(mesh, K, client_axes)
    cfg = cfg if cs.lead else dataclasses.replace(cfg, verbose=False)
    init = init or {}
    codec = get_codec(cfg.uplink_codec)
    device = resolve_device(cfg.device)
    rng = np.random.RandomState(cfg.seed)
    gen = torch.Generator().manual_seed(cfg.seed)
    mcfg = get_config("gpt2-small").reduced(d_model=cfg.d_model, repeats=cfg.n_layers)
    model = Model(mcfg, device=device)
    corpus = InstructionCorpus(seq_len=cfg.prompt_len + cfg.gen_len,
                               prompt_len=cfg.prompt_len, seed=cfg.seed)
    params = (bridge.params_from_numpy(init["policy"], mcfg, device=device)
              if "policy" in init else model.init(gen))
    synchronize(device)
    t0 = time.perf_counter()
    params = _pretrain_policy(model, params, corpus, cfg.pretrain_steps,
                              cfg.pretrain_lr, 16, cfg.verbose)
    synchronize(device)
    pretrain_s = time.perf_counter() - t0
    global_params = params

    strace = scen.realize(N, cfg.rounds)
    pool_n = int(np.clip(cfg.rollout_batch * 64, 512, 4096))
    pool = corpus.sample(pool_n, helpful_p=0.9, unsafe_p=0.05, rng=rng)
    data = PopulationData(pool, strace.class_probs, seed=cfg.seed, label_key="topic")

    peft_cfg = peft_mod.PEFTConfig(lora_rank=cfg.lora_rank,
                                   lora_targets=("mixer/wq", "mixer/wv"))
    opt = adamw(cfg.lr)

    def client_init(i):
        lora = (bridge.lora_from_numpy(init["lora"][i], mcfg, device=device) if "lora" in init
                else peft_mod.init_lora(torch.Generator().manual_seed(
                    stream_key(cfg.seed, 200 + i)), params, peft_cfg))
        return {"t": lora, "o": opt.init(lora)}

    stacked = stacked_client_init(client_init, N)
    store = PopulationStore({"trainable": stacked["t"], "opt": stacked["o"],
                             "pending": trees.map_leaves(np.zeros_like, stacked["t"])})
    lora0 = store.row("trainable", 0)
    lora0_t = trees.map_leaves(torch.from_numpy, lora0)

    channel = RayleighChannel(mean_snr_db=cfg.snr_db, seed=cfg.seed)
    budget = ChannelBudget(channel, tx_power_w=cfg.tx_power_w)
    ledger = CommLedger()
    dl, trace, tracker = robust_runtime(cfg, channel, N, always=True)
    payload_bits = tree_bytes(lora0_t) * 8
    est_bits = None
    if dl is not None:
        est_bits = np.full(N, payload_bits if codec is None else
                           payload_bits_upper_bound(codec, lora0_t), np.float64)
    codec_noise = None if codec is None else (
        init.get("codec_noise") or functools.partial(codec_uniforms, cfg.seed, device=device))

    shepherd_loss = _shepherd_loss(model, cfg, global_params, peft_cfg)

    def shepherd_local_step(lora, opt_state, batch):
        loss, g = value_and_grad(lambda lo: shepherd_loss(lo, batch), lora)
        upd, opt_state = opt.update(g, opt_state, lora)
        return trees.tree_add(lora, upd), opt_state, loss

    tracer, tele, health, prof = open_run(cfg.telemetry, device, write=cs.lead)
    round_step = build_supervised_round(
        shepherd_local_step, cs=cs, codec=codec, factored_agg=cfg.factored_agg, robust=True,
        min_quorum=dl.min_quorum if dl is not None else 0, health=health)
    runner = PopulationRunner(
        pop=pop, store=store, global_shared=trees.map_leaves(np.array, lora0),
        upload_pred=lambda p: True, channel=channel, budget=budget, ledger=ledger,
        tracker=tracker, trace=trace, strace=strace,
        sampler=ClientSampler(pop.sampler, N, K, seed=cfg.seed + 1000 * pop.seed),
        device=device, arrivals=tracker.arrivals, dl=dl, cs=cs, est_bits=est_bits,
        tracer=tracer, health=health)
    stacker = HostBatchStacker(device, rows=cs.rows)

    def _lm_batch(b):
        return {"tokens": b["tokens"][:, :-1], "labels": b["tokens"][:, 1:],
                "mask": b["mask"][:, 1:]}

    def draw(cid, rnd):
        return [_lm_batch(b) for b in data.round_batches(
            cid, rnd, cfg.shepherd_steps, cfg.rollout_batch)]

    # ---- cohort eval: per-client LM loss on a held-out topical draw
    n_eval = min(2 * cfg.rollout_batch, 64)
    test_sets = CohortTestSets(data, n_eval, ("tokens", "labels", "mask"), prep=_lm_batch)

    def eval_client(lora, tokens, labels, mask):
        return (shepherd_loss(lora, {"tokens": tokens, "labels": labels, "mask": mask}),)

    eval_cohort = build_cohort_eval(eval_client, mesh=mesh)

    def eval_ids(cohort_tr, ids):
        (losses,) = eval_cohort(cohort_tr, *test_sets(cs.local(ids), device))
        return [float(x) for x in losses.cpu().numpy()[:len(ids)]]

    tele.start({"mode": "population", "method": cfg.method, "population": N,
                "cohort_size": K, "rounds": cfg.rounds, "sampler": pop.sampler,
                "codec": cfg.uplink_codec})
    loss_per_round: List[float] = []
    health_per_round, cohorts = [], []
    for rnd in range(cfg.rounds):
        out = runner.run_round(rnd, round_step=round_step, stacker=stacker,
                               draw_batches=draw, payload_bits=payload_bits,
                               codec_noise=codec_noise)
        with tracer.span("eval"):
            loss_per_round.append(float(np.mean(eval_ids(out["cohort_tr"], out["ids"]))))
        health_per_round.append(out["health"])
        cohorts.append([int(i) for i in out["ids"]])
        if tele.enabled:
            if rnd == 0:
                tele.compile_event(rnd, tracer.totals().get("device-step", 0.0))
            tele.round_event(rnd, {
                "eval_loss": loss_per_round[-1], "cohort": cohorts[-1],
                "comm": _comm_record(ledger),
                "staleness": tracker.counters(), "health": out["health"],
            }, wall={"phases": tracer.pop_round()})
        if cfg.verbose:
            print(f"[pfit-pop:shepherd] round {rnd} cohort lm-loss {loss_per_round[-1]:.4f}")

    close_run(cfg.telemetry, tele, prof)
    return {
        "method": cfg.method,
        "eval_loss_per_round": loss_per_round,
        "final_eval_loss": loss_per_round[-1] if loss_per_round else 0.0,
        "mean_round_bytes": ledger.mean_round_bytes,
        "mean_round_delay_s": ledger.mean_round_delay,
        "total_bytes": ledger.total_bytes,
        "total_energy_j": ledger.total_energy_j,
        "total_sim_time_s": ledger.total_sim_time_s,
        "quorum_noops": ledger.quorum_noops,
        "uplink_codec": cfg.uplink_codec,
        "population": N,
        "cohort_size": K,
        "sampler": pop.sampler,
        "scenario": scen.to_dict(),
        "participation_frac": float(runner.seen.mean()),
        "host_overhead_frac": runner.host_overhead_frac,
        "store_bytes": store.nbytes(),
        "round_records": ledger.rounds,
        "cohorts": cohorts,
        "staleness": tracker.counters(),
        "health_per_round": health_per_round,
        "host_s": runner.host_s,
        "round_s": runner.round_s,
        "round_wall": list(runner.round_wall),
        "pretrain_s": pretrain_s,
    }
