"""Training launcher, on the GPU by default (``--device cpu`` runs the
kernels' plain versions).

``--fl-clients N`` runs PFTT's cohort engine on the reduced RoBERTa
classification workload (``core/pftt.py``; ``--steps``/``--seq`` do not
apply; ``--batch``/``--lr``/``--fl-rounds`` do):

    PYTHONPATH=src python -m repro_torch.launch.train --arch roberta-base \
        --fl-clients 4 --fl-rounds 3

``--fault-plan``, ``--staleness-a`` and ``--max-staleness`` switch it to the
straggler-tolerant robust round; ``--deadline-s``, ``--backoff-base-s``,
``--max-retries``, ``--min-quorum`` and ``--compute-time-s`` to its
continuous-time round; ``--ckpt-dir`` saves each round's state and
``--resume`` continues a killed run from it:

    PYTHONPATH=src python -m repro_torch.launch.train --arch roberta-base \
        --fl-clients 2 --fl-rounds 2 --fault-plan \
        "straggle_p=0.5,max_straggle=2,seed=2" --staleness-a 0.5 \
        --max-staleness 2 --device cpu

``--uplink-codec`` (``int8``, ``int4``: stochastic-rounding quantization;
``sketch``: top-k) compresses each client's upload inside the round and
``--factored-agg`` aggregates the LoRA factor pairs by the SVD
re-projection (``repro_torch.comms``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch roberta-base \
        --fl-clients 2 --fl-rounds 1 --uplink-codec int4 --factored-agg \
        --device cpu

``--population N`` runs PFTT's sampled-cohort population mode: the host
holds N clients' trainable and optimizer trees and every round samples a
``--cohort`` cohort (``--sampler``, ``--scenario``; ``fl/population.py``).
``--telemetry-dir D`` writes the run's JSONL round events (``D/events.jsonl``,
with the health scalars; ``repro_torch.obs``), ``--trace`` a Chrome trace of
the host spans (``D/trace.json``) and ``--torch-profile`` a
``torch.profiler`` trace under ``D/torch_profile``;
``python -m repro_torch.launch.report D --check`` validates the stream:

    PYTHONPATH=src python -m repro_torch.launch.train --arch roberta-base \
        --population 256 --cohort 8 --fl-rounds 2 --sampler availability \
        --scenario "avail=diurnal,avail_period=6,seed=1" \
        --telemetry-dir /tmp/telemetry --trace

``--steps N`` trains the chosen architecture at full width (``--reduced``
for the smoke variant; ``--depth R`` cuts every stage to R repeats) for N
AdamW steps of the JAX launcher's full fine-tuning (``launch/steps.py``'s
``make_train_step`` over every parameter, next-token labels):

    PYTHONPATH=src python -m repro_torch.launch.train --arch roberta-base \
        --steps 10 --batch 16 --seq 128

With ``--lora-rank R`` > 0 (default 0) it runs ``make_peft_step`` instead:
adapters plus rank-R LoRA on ``mixer/wq``/``mixer/wv`` trained on an MLM
loss over 15 % masked positions, the base frozen, so every encoder layer
runs the ``lora_fused`` and non-causal ``flash_attn`` kernels forward and
their autograd Functions backward.

Started by torchrun, ``--steps`` runs under the (data, model) mesh of
``launch/mesh.py::make_tp_mesh``: ``--data-axis D`` data coordinates by
world / D model coordinates (0: every rank on the data axis, as the JAX
launcher).  The initial parameters are drawn whole from torch seed 0 and
each rank keeps its blocks under ``param_specs(..., "fsdp")``; every rank
draws the same batches and runs its rows.  Four ranks on one card share it
over gloo, four cards take one each over NCCL:

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 3 --depth 2 --data-axis 2

Without torchrun ``--steps`` runs on one device with no mesh (a one-rank
torchrun's (1, 1) mesh gives the same bits).  ``--report PATH`` writes the losses, the seconds
a step and every rank's peak device memory (rank 0 writes).

``--fl-clients N`` with any other ``--arch`` runs the universal factored
round on that architecture's reduced config (``core/arch_round.py``,
``--fl-dmodel`` wide, ``--fl-seq`` tokens a sample): a ragged LoRA cohort,
one round step a round.  ``--assert-fused`` turns the run into the
arch-matrix check — it fails unless no dense merge ran inside the engine,
each round was one round step, and the losses match the dense-merge oracle
to ≤1e-5.  The default ``--fl-dmodel 64`` gives heads of 16 (MLA's q/k 32
with v 16), which the attention kernels run in their 32-wide tile; any
``--fl-dmodel`` runs on the card (72: heads of 18, read element by element;
1088: heads of 272, split over a cluster of three blocks, each a slice of
q/k dims and v columns; ``kernels/flash_attn/ops.py::plan``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --fl-clients 4 --fl-rounds 2 --assert-fused

Started by torchrun, the FL modes (the arch round, ``--fl-clients``
PFTT, ``--population``) shard the stacked client axis over every rank
(``launch/mesh.py``: one ``("data",)`` axis, NCCL on the card, gloo on the
CPU or where ranks share a card); only rank 0 prints, writes telemetry and
writes checkpoints:

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.train --arch roberta-base \
        --fl-clients 4 --fl-rounds 2 --device cpu

``--steps`` builds the model with rematerialization (``Model(remat=True)``,
as the JAX launcher) and ``--ckpt PATH`` saves the trained parameters
after the steps, whole (rank 0 writes under a mesh; with LoRA:
``{"params": base with the adapters, "lora": the factors}``), readable by
``checkpoint.load_checkpoint``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import numpy as np
import torch

from repro_torch import resolve_device, trees
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import Stage, get_config, list_configs
from repro_torch.data import SPECIAL
from repro_torch.launch.steps import make_peft_loss, make_peft_step, make_train_step
from repro_torch.models import peft as peft_mod
from repro_torch.models.transformer import Model
from repro_torch.sharding import MeshCtx
from repro_torch.wireless import DeadlineConfig, FaultPlan


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--depth", type=int, default=0,
                    help="--steps mode: cut every stage to this many repeats "
                         "(0 → the config's depth)")
    ap.add_argument("--data-axis", type=int, default=0,
                    help="--steps under torchrun: data axis of the (data, "
                         "model) mesh, world/D the model axis (0 → every rank)")
    ap.add_argument("--ckpt", default=None,
                    help="--steps mode: save the trained parameters here (npz)")
    ap.add_argument("--report", default=None,
                    help="--steps mode: write losses, s/step and each rank's "
                         "peak device memory here (JSON)")
    ap.add_argument("--lora-rank", type=int, default=0,
                    help="--steps mode: PEFT (adapters + LoRA of this rank on "
                         "wq/wv, MLM loss); 0 (default) → full fine-tuning")
    ap.add_argument("--fl-clients", type=int, default=0,
                    help="run a federated PFTT cohort of this size (0 → off)")
    ap.add_argument("--fl-rounds", type=int, default=3)
    ap.add_argument("--uplink-codec", default="none",
                    choices=["none", "int8", "int4", "sketch"],
                    help="compress FL uploads inside the round "
                         "(repro_torch.comms): stochastic-rounding int8/int4 "
                         "quantization or top-k sketching of the delta "
                         "against the last broadcast global")
    ap.add_argument("--factored-agg", action="store_true",
                    help="aggregate LoRA factor pairs via SVD re-projection "
                         "of the weighted-mean update (never densified)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--fault-plan", default=None,
                    help="inject wireless faults into the FL run: 'k=v,...' "
                         "(dropout_p/straggle_p/crash_p/snr_dip_p/corrupt_p/"
                         "seed/...) or a JSON file path "
                         "(wireless.faults.FaultPlan)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="continuous-time FL round: server closes the round "
                         "this many simulated seconds after dispatch; late "
                         "arrivals buffer as stale retransmissions "
                         "(wireless.arrivals.DeadlineConfig)")
    ap.add_argument("--backoff-base-s", type=float, default=0.0,
                    help="retransmission backoff base: the n-th failure of "
                         "a payload waits base*2^(n-1) simulated seconds")
    ap.add_argument("--max-retries", type=int, default=8,
                    help="abandon a pending payload after this many failed "
                         "retransmissions")
    ap.add_argument("--min-quorum", type=int, default=0,
                    help="void the round (no merge, deliveries NACKed back "
                         "to pending) when fewer payloads arrive in time")
    ap.add_argument("--compute-time-s", type=float, default=0.0,
                    help="mean per-round local compute time before a fresh "
                         "upload starts transmitting (stragglers scale it)")
    ap.add_argument("--staleness-a", type=float, default=0.0,
                    help="staleness discount exponent: late uploads merge "
                         "with weight α·(1+s)^(-a)")
    ap.add_argument("--max-staleness", type=int, default=0,
                    help="retransmit failed uploads for up to this many "
                         "rounds (0 = synchronous drop-on-failure)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="FL engine: save the stacked round state each round "
                         "here so a killed run can --resume")
    ap.add_argument("--resume", action="store_true",
                    help="FL engine: restart from --ckpt-dir's last round")
    ap.add_argument("--population", type=int, default=0,
                    help="population mode (roberta-base): the host holds "
                         "this many clients' adapter/opt trees and every "
                         "round samples a --cohort cohort into the round "
                         "(fl.population; 0 → off)")
    ap.add_argument("--cohort", type=int, default=8,
                    help="population mode: sampled cohort size per round")
    ap.add_argument("--sampler", default="uniform",
                    choices=["uniform", "availability"],
                    help="population mode: per-round client sampler "
                         "(availability weights by the scenario's "
                         "avail_p trace)")
    ap.add_argument("--scenario", default=None,
                    help="population scenario spec: 'k=v,...' "
                         "(alpha/avail/avail_period/mobility/seed/... — "
                         "wireless.scenarios.Scenario.from_spec) or a JSON "
                         "file path")
    ap.add_argument("--telemetry-dir", default=None,
                    help="FL runs: write the structured run telemetry "
                         "(events.jsonl — schema-versioned round metrics "
                         "joining eval, comm ledger, staleness and health "
                         "signals; repro_torch.obs) into this directory")
    ap.add_argument("--trace", action="store_true",
                    help="with --telemetry-dir: also write trace.json, a "
                         "Chrome trace-event file of the host round phases "
                         "(open in Perfetto / chrome://tracing)")
    ap.add_argument("--torch-profile", action="store_true",
                    help="with --telemetry-dir: bracket the run in a "
                         "torch.profiler trace under <dir>/torch_profile")
    ap.add_argument("--assert-fused", action="store_true",
                    help="FL engine: fail unless the run took the fused "
                         "factored path — zero dense merges, one round step "
                         "a round, and (non-roberta archs) ≤1e-5 parity vs "
                         "the dense-merge oracle")
    ap.add_argument("--fl-seq", type=int, default=16,
                    help="arch FL round: per-sample sequence length")
    ap.add_argument("--fl-dmodel", type=int, default=64,
                    help="arch FL round: reduced-config width")
    args = ap.parse_args(argv)
    if args.population and args.arch != "roberta-base":
        raise SystemExit("--population runs the PFTT workload: "
                         "use --arch roberta-base")
    return args


def arch_round_config(args):
    """The ``ArchRoundConfig`` of ``--fl-clients`` with a non-roberta arch,
    as the JAX launcher builds it."""
    from repro_torch.core.arch_round import ArchRoundConfig
    return ArchRoundConfig(arch=args.arch, n_clients=args.fl_clients,
                           rounds=args.fl_rounds, batch=min(args.batch, 4),
                           seq_len=args.fl_seq, d_model=args.fl_dmodel, lr=args.lr,
                           oracle=args.assert_fused, device=args.device)


def run_arch(args, mesh=None, say=print):
    """The universal factored round (and with ``--assert-fused`` its
    checks) → the result dict; ``mesh``: the client mesh, ``say`` prints
    (nothing on ranks but 0)."""
    from repro_torch.core.arch_round import run_arch_round
    say(f"universal factored round: --arch {args.arch}, {args.fl_clients} clients "
        f"on {where(args, mesh)}")
    res = run_arch_round(arch_round_config(args), mesh=mesh,
                         client_axes=None if mesh is None else ("data",))
    say(f"arch={res['arch']} targets={res['lora_targets']} ragged={res['ragged']} "
        f"ghosts={res['n_ghosts']} dispatches/round={res['dispatches_per_round']} "
        f"dense_merges={res['dense_merges_in_engine']} "
        f"loss/round={['%.4f' % lo for lo in res['loss_per_round']]} "
        f"round_s={[round(s, 4) for s in res['round_s']]}")
    if args.assert_fused:
        err = res["oracle_loss_max_err"]
        say(f"oracle parity max err {err:.2e}")
        assert res["dense_merges_in_engine"] == 0, \
            "dense-merge fallback taken inside the fused round"
        assert res["dispatches_per_round"] == 1.0, \
            "cohort fell back to per-client dispatch"
        assert err <= 1e-5, f"factored/oracle divergence {err:.2e}"
        say("fused path asserted: factored, one dispatch, oracle parity OK")
    return res


def where(args, mesh) -> str:
    """The devices a run takes, for its first line."""
    if mesh is None:
        return str(resolve_device(args.device))
    return f"{mesh.size} rank(s) of a client mesh, rank {mesh.rank} on {args.device}"


def deadline_config(args):
    """The continuous-time round's ``DeadlineConfig`` when a flag of it is
    set (None otherwise), as the JAX launcher builds it."""
    if (args.deadline_s is None and args.backoff_base_s <= 0
            and args.min_quorum <= 0 and args.compute_time_s <= 0):
        return None
    return DeadlineConfig(
        deadline_s=args.deadline_s if args.deadline_s is not None else math.inf,
        backoff_base_s=args.backoff_base_s, max_retries=args.max_retries,
        min_quorum=args.min_quorum, compute_mean_s=args.compute_time_s)


def pftt_config(args, **overrides):
    """The ``PFTTConfig`` the launcher runs (the JAX launcher's settings:
    5 local steps, 50 pretraining steps, 200 samples per client; population
    mode's cohort and telemetry from their flags)."""
    from repro_torch.core.pftt import PFTTConfig
    from repro_torch.fl.population import PopulationConfig
    from repro_torch.obs import TelemetryConfig
    from repro_torch.wireless.scenarios import Scenario
    population = None if not args.population else PopulationConfig(
        population=args.population, cohort_size=args.cohort, sampler=args.sampler,
        scenario=Scenario.from_spec(args.scenario))
    telemetry = None if not args.telemetry_dir else TelemetryConfig(
        out_dir=args.telemetry_dir, trace=args.trace, torch_profile=args.torch_profile)
    kw = dict(n_clients=args.fl_clients or args.cohort, rounds=args.fl_rounds,
              batch=args.batch, lr=args.lr, local_steps=5, pretrain_steps=50,
              samples_per_client=200, fault_plan=FaultPlan.from_spec(args.fault_plan),
              staleness_a=args.staleness_a, max_staleness=args.max_staleness,
              deadline=deadline_config(args), uplink_codec=args.uplink_codec,
              factored_agg=args.factored_agg, ckpt_dir=args.ckpt_dir,
              resume=args.resume, population=population, telemetry=telemetry,
              verbose=True, device=args.device)
    kw.update(overrides)
    return PFTTConfig(**kw)


def step_config(args):
    """The ``--steps`` model config: ``--reduced``, then ``--depth``."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.depth:
        cfg = dataclasses.replace(cfg, stages=tuple(
            Stage(st.pattern, min(st.repeats, args.depth), st.stream) for st in cfg.stages))
    return cfg


class Trainer:
    """``--steps`` mode: the model, its random init (torch seed 0) and the
    step.  ``batch(rng)`` draws one numpy batch, ``to_device`` moves it,
    ``step(batch)`` runs one AdamW step on it and returns the loss;
    ``loss(trainable, batch)`` is the step's loss alone (for timing the
    forward apart from the backward); ``params()`` the trained parameters,
    whole (``--ckpt``'s tree).  ``remat``: the model's rematerialization
    (the launcher's is on).  ``meshctx``: a (data, model) mesh; the state
    is then this rank's blocks (the whole batch is drawn, each rank runs
    its rows)."""

    def __init__(self, args, remat: bool = False, meshctx: MeshCtx = None):
        self.args = args
        self.device = resolve_device(args.device)
        cfg = step_config(args)
        self.cfg = cfg
        self.mc = meshctx
        self.model = Model(cfg, device=self.device, remat=remat, meshctx=meshctx)
        gen = torch.Generator().manual_seed(0)
        params = self.model.init(gen, max_seq=args.seq)
        self.peft_cfg = None
        if args.lora_rank:
            self.peft_cfg = peft_mod.PEFTConfig(
                lora_rank=args.lora_rank, lora_targets=("mixer/wq", "mixer/wv"))
            params = peft_mod.init_adapters(gen, params, cfg, self.peft_cfg)
            lora = peft_mod.init_lora(gen, params, self.peft_cfg)
            self.frozen = params if meshctx is None else self.model.shard(params)
            self.trainable = {
                "adapters": trees.select(self.frozen, peft_mod.is_adapter_path),
                "lora": lora}
            self._step, opt = make_peft_step(self.model, self.peft_cfg, lr=args.lr)
            self._loss = make_peft_loss(self.model, self.peft_cfg)
        else:
            self.frozen = None
            self.trainable = params if meshctx is None else self.model.shard(params)
            self._step, opt = make_train_step(self.model, lr=args.lr)
        self.opt_state = opt.init(self.trainable)

    def batch(self, rng):
        """One numpy batch; an encoder-decoder's ``frames`` and a VLM's
        ``patches`` are drawn after the tokens, as the JAX launcher draws
        them."""
        b, s, v, cfg = self.args.batch, self.args.seq, self.cfg.vocab_size, self.cfg
        if self.peft_cfg is None:   # the JAX launcher's next-token batch
            toks = rng.randint(6, v, size=(b, s + 1))
            out = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                   "mask": np.ones((b, s), np.float32)}
        else:
            toks = rng.randint(6, v, size=(b, s))
            mpos = rng.rand(b, s) < 0.15
            out = {"tokens": np.where(mpos, SPECIAL["mask"], toks), "labels": toks,
                   "mask": mpos.astype(np.float32)}
        if cfg.is_encoder_decoder:
            out["frames"] = rng.randn(b, cfg.encoder_seq, cfg.d_model).astype(np.float32)
        if cfg.n_prefix_tokens:
            out["patches"] = rng.randn(b, cfg.n_prefix_tokens,
                                       cfg.prefix_dim).astype(np.float32)
        return out

    def to_device(self, batch):
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    def loss(self, trainable, batch):
        if self.peft_cfg is None:
            return self.model.lm_loss(trainable, batch)
        return self._loss(trainable, self.frozen, batch)

    def step(self, batch):
        if self.peft_cfg is None:
            self.trainable, self.opt_state, loss = self._step(
                self.trainable, self.opt_state, batch)
        else:
            self.trainable, self.opt_state, loss = self._step(
                self.trainable, self.frozen, self.opt_state, batch)
        return loss

    def params(self):
        """The trained parameters, whole (under a mesh every rank joins):
        the model tree, or with LoRA {"params": the base with the trained
        adapters, "lora": the factors}."""
        whole = self.model.unshard if self.mc is not None else (lambda t: t)
        if self.peft_cfg is None:
            return whole(self.trainable)
        return {"params": whole(trees.merge(self.frozen, self.trainable["adapters"])),
                "lora": self.trainable["lora"]}


def main(argv=None):
    args = parse_args(argv)
    if not (args.fl_clients or args.population):
        return run_steps(args)
    from repro_torch.launch.mesh import in_torchrun, make_client_mesh, rank_device
    mesh = None
    if in_torchrun():
        args.device = str(rank_device(args.device))
        mesh = make_client_mesh(args.device)
    try:
        return run_fl(args, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def run_fl(args, mesh=None):
    """The FL modes (the arch round, PFTT, population), sharded over
    ``mesh`` when torchrun started the run."""
    lead = mesh is None or mesh.rank == 0

    def say(msg):
        if lead:
            print(msg, flush=True)

    if args.fl_clients and args.arch != "roberta-base":
        return run_arch(args, mesh, say)
    from repro_torch.core.pftt import run_pftt
    if args.population:
        say(f"population PFTT: {args.population} clients, cohort {args.cohort}/round "
            f"({args.sampler} sampling) on {where(args, mesh)}")
    else:
        say(f"federated PFTT cohort (reduced-roberta workload; --steps/--seq "
            f"ignored) on {where(args, mesh)}")
    res = run_pftt(pftt_config(args), mesh=mesh,
                   client_axes=None if mesh is None else ("data",))
    rounds = res["round_wall"] if args.population else res["round_s"]
    say(f"final acc {res['final_acc']:.3f} mean round bytes "
        f"{res['mean_round_bytes']:,.0f} (codec={args.uplink_codec}) mean round delay "
        f"{res['mean_round_delay_s']:.3f}s energy {res['total_energy_j']:.2f}J "
        f"pretrain {res['pretrain_s']:.2f}s rounds "
        f"{[round(s, 3) for s in rounds]}s")
    if args.population:
        say(f"population: sampled {res['participation_frac']:.1%} of "
            f"{res['population']} clients, host overhead "
            f"{res['host_overhead_frac']:.1%} of round wall-clock, "
            f"store {res['store_bytes'] / 1e6:.1f}MB")
    if deadline_config(args) is not None:
        say(f"continuous-time round: sim time {res['total_sim_time_s']:.1f}s "
            f"quorum no-ops {res['quorum_noops']}")
    if args.assert_fused:
        assert res["fused_engine"], "PFTT ran the legacy per-client loop"
        say("fused path asserted: engine round")
    return res


def run_steps(args):
    """``--steps``: N AdamW steps with rematerialization, under torchrun's
    (data, model) mesh or, outside torchrun, on one device with no mesh;
    then ``--ckpt`` and ``--report``."""
    from repro_torch.launch.mesh import in_torchrun, make_tp_mesh, rank_device
    if not in_torchrun():
        if args.data_axis > 1:
            raise SystemExit("--data-axis > 1 needs ranks: start the run under torchrun")
        return _steps(args, None)
    args.device = str(rank_device(args.device))
    mc = make_tp_mesh(args.data_axis, args.device)
    try:
        return _steps(args, mc)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def _steps(args, mc):
    lead = mc is None or mc.rank == 0

    def say(msg):
        if lead:
            print(msg, flush=True)

    tr = Trainer(args, remat=True, meshctx=mc)
    dev = tr.device
    shape = (1, 1) if mc is None else mc.shape
    say(f"--steps {args.arch}: mesh {shape} on {dev}, "
        f"{'LoRA rank %d' % args.lora_rank if args.lora_rank else 'full fine-tuning'}")
    rng = np.random.RandomState(0)
    losses, step_s = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        t1 = time.perf_counter()
        losses.append(float(tr.step(tr.to_device(tr.batch(rng)))))   # float() waits
        step_s.append(time.perf_counter() - t1)
        if i % 10 == 0:
            say(f"step {i:4d} loss {losses[-1]:.4f} "
                f"({(time.perf_counter() - t0) / (i + 1):.3f}s/step)")
    sec = (time.perf_counter() - t0) / max(args.steps, 1)
    params = tr.params() if args.ckpt else None       # every rank joins the unshard
    mem = torch.zeros(1 if mc is None else mc.size, dtype=torch.float64, device=dev)
    if dev.type == "cuda":
        mem[0 if mc is None else mc.rank] = torch.cuda.max_memory_allocated(dev)
    if mc is not None:
        mem = mc.reduce(mem, mc.axis_names)
    if lead and args.ckpt:
        save_checkpoint(args.ckpt, params)
        print("saved", args.ckpt)
    if lead and args.report:
        with open(args.report, "w") as f:
            json.dump({"arch": args.arch, "mesh": shape, "losses": losses,
                       "s_per_step": sec, "step_s": step_s,
                       "max_memory_allocated": mem.tolist(),
                       "device": str(dev)}, f)
    return losses


if __name__ == "__main__":
    main()
