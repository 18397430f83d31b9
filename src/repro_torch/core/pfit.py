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

Not ported yet, and refused by name (``cohort.LATER``): the legacy
per-client loop (``engine=False``).
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
from repro_torch.comms.codec import codec_uniforms, round_noises
from repro_torch.configs import get_config
from repro_torch.core.cohort import (HostBatchStacker, build_cohort_eval, build_ppo_round,
                                     build_supervised_round, not_ported)
from repro_torch.core.pftt import _comm_record
from repro_torch.core.robust import round_extra, round_reports, robust_runtime
from repro_torch.core.rewards import ClientPreference, DoubleReward
from repro_torch.data.partition import client_topic_preferences
from repro_torch.data.synthetic import N_TOPICS, InstructionCorpus
from repro_torch.models import peft as peft_mod
from repro_torch.models.transformer import Model
from repro_torch.obs import close_run, open_run
from repro_torch.optim import adamw, value_and_grad
from repro_torch.rlhf.ppo import PPOConfig
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
    not_ported("PFITConfig", legacy_loop=not cfg.engine)
    cs = cohort_sharding(mesh, cfg.n_clients, client_axes)   # this process's rows
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
    loras = []
    if cfg.method == "shepherd":
        loras = [bridge.lora_from_numpy(init["lora"][ci], mcfg, device=device)
                 if "lora" in init else peft_mod.init_lora(gen, params, peft_cfg)
                 for ci in range(cfg.n_clients)]

    def shepherd_local_step(lora, opt_state, batch):
        """Supervised LoRA step on the frozen global, the factors unmerged."""
        loss, g = value_and_grad(
            lambda lo: model.lm_loss(global_params, batch, lora=lo, lora_scale=lscale),
            lora)
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

    # ---- the straggler-tolerant runtime (core/robust.py, wireless/faults.py)
    dl, trace, tracker = robust_runtime(cfg, channel)
    robust = tracker is not None
    min_quorum = dl.min_quorum if dl is not None else 0

    # ---- observability: health rides shepherd's supervised round only
    tracer, tele, health, prof = open_run(cfg.telemetry, device, write=cs.lead)
    health = health and cfg.method == "shepherd"

    # ---- the cohort engine: per-client state stacked on a client axis
    if cfg.method == "shepherd":
        round_step = build_supervised_round(shepherd_local_step, codec=codec,
                                            factored_agg=cfg.factored_agg, robust=robust,
                                            min_quorum=min_quorum, health=health, cs=cs)
        cohort_tr = cs.take(trees.stack(loras))
        cohort_opt = cs.take(trees.stack([opt.init(lo) for lo in loras]))
        payloads = [tree_bytes(lo) for lo in loras]
        stacker = HostBatchStacker(device, rows=cs.rows)
    else:
        ppo_round_step = build_ppo_round(
            model, opt, cfg.ppo, cfg.prompt_len, cfg.gen_len, quality_fn,
            lambda_regs=[p.lambda_reg for p in prefs], codec=codec, robust=robust,
            min_quorum=min_quorum, cs=cs)
        cohort_tr = trees.stack([params] * cs.n_local)
        cohort_opt = trees.stack([opt.init(params)] * cs.n_local)
        st_masks = cs.take(trees.stack(client_masks))
        payloads = [tree_bytes(params, nonzero_mask=client_masks[ci])
                    for ci in range(cfg.n_clients)]
    # the pending-payload buffer (zeros never merge: their weight is 0) and
    # the deadline round's scheduling sizes (exact for uncompressed uploads;
    # a codec's worst case until a realized size replaces it)
    pending = trees.map_leaves(torch.zeros_like, cohort_tr) if robust else None
    est_bits = None
    if dl is not None:
        est_bits = np.asarray(
            [p * 8 for p in payloads] if codec is None else
            [payload_bits_upper_bound(codec, t) for t in
             (loras if cfg.method == "shepherd" else [params] * cfg.n_clients)],
            np.float64)
    codec_noise = init.get("codec_noise") or functools.partial(
        codec_uniforms, cfg.seed, device=device)

    def vec(v, fill=0.0):
        """A round vector on the device: this rank's rows, ghosts ``fill``."""
        return torch.from_numpy(cs.take_vec(v, fill)).to(device)

    reward_curve, train_reward, round_s, health_per_round = [], [], [], []
    rollouts0, eval0 = [], []
    tele.start({"mode": "cohort", "method": cfg.method, "n_clients": cfg.n_clients,
                "rounds": cfg.rounds, "engine": True, "codec": cfg.uplink_codec})
    for rnd in range(cfg.rounds):
        t0 = time.perf_counter()
        gains = channel.realize(cfg.n_clients)
        rplan = None
        if robust:
            rf = trace.round(rnd)
            gains = gains * rf.gain_scale       # injected SNR dips
            rplan = tracker.begin_round(rf, channel.outage_weights(gains),
                                        gains=gains, fresh_bits=est_bits)
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
        if cfg.method == "shepherd":
            def shepherd_batch(ci):
                s = corpus.sample(cfg.rollout_batch, topic_probs=topic_prefs[ci],
                                  helpful_p=0.9, unsafe_p=0.05, rng=rng)
                return {"tokens": s["tokens"][:, :-1], "labels": s["tokens"][:, 1:],
                        "mask": s["mask"][:, 1:]}
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
            record = rollouts0 if rnd == 0 else None
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
            train_reward.append(float(cs.gather(mean_rewards).mean()))
            bits_out = outs[-1] if codec is not None else None   # its last output
        # the engine's realized payload bits with a codec
        bits = ([payloads[ci] * 8 for ci in range(cfg.n_clients)] if codec is None
                else cs.gather(bits_out).tolist())
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

        record = eval0 if rnd == 0 else None
        with tracer.span("eval"):
            if cfg.method == "shepherd":   # serve unmerged: the base shared, the factors per client
                local = trees.unstack(cohort_tr)
                reward_curve.append(eval_reward([global_params] * len(local), local,
                                                record=record))
            else:
                reward_curve.append(eval_reward(trees.unstack(cohort_tr), record=record))
        health_per_round.append(None if not health else
                                {k: float(v) for k, v in outs[-1].items()})
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
    lscale = peft_mod.lora_scale(peft_cfg)
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

    def shepherd_local_step(lora, opt_state, batch):
        loss, g = value_and_grad(
            lambda lo: model.lm_loss(global_params, batch, lora=lo, lora_scale=lscale),
            lora)
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
        batch = {"tokens": tokens, "labels": labels, "mask": mask}
        return (model.lm_loss(global_params, batch, lora=lora, lora_scale=lscale),)

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
