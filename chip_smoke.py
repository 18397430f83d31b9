#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA
   versions; exits nonzero when CUDA is unavailable.
2. build   — compiles every CUDA source of ``src/repro_torch/csrc`` with nvcc
   (one process per source, all at once) and prints the ptxas register /
   shared-memory report; fails if any instance spills.
3. kernels — calls each kernel's wrapper on the card at the serving paths'
   shapes, in f32 and bf16, and holds it against its plain PyTorch version
   (tolerances of tests/test_kernels.py); times the kernel, the plain version
   and one PyTorch library call of the same function, each on a cold L2
   (median of 30 calls), with the kernel's TFLOP/s and its share of the
   bound; the library call of each kernel's serving-shape row (and of
   mamba2's out_proj decode row) is profiled once, so its PROFILE lines name
   the kernels it runs.  Each lora_fused row at M ≤ 16 (the decode branch)
   prints the strip width and K split its rule took on this card; each
   decode_attn row the cluster size (split) its rule took, and each f32
   decode_attn row also ``read_ms``: a ``torch.sum`` over the K and V
   positions the call reads (one per contiguous range), under the same timer.
   Each ssd_chunk row prints its plan (``fused``: C·Bᵀ's tiles in the chunk
   states' launch) and the groups C·Bᵀ is formed for, and its serving-shape
   row is profiled once, so its PROFILE lines name the scan's kernels.
   ``rank_cases``: lora_fused at ranks 64 and 128 at SERVE-LLAMA-R64's
   prefill and decode shapes and gpt2's decode; ssd_chunk at (P, N) outside
   its compiled pairs, (128, 128) and (64, 256), through the cover (each
   such row prints the compiled pair and its blocks).  ``any_width_cases``:
   the attention kernels at head widths past whole 16-byte chunks of 256
   (18: elements; 272, 512 and MLA's (288, 272), (528, 512): split over a
   cluster, and heads of 512 at S 1024, past launch latency), each row
   naming its plan.
4. serve   — the serving paths through the port's entry points
   (``launch/serve.py`` build/generate), each with random weights from seed
   0 and nonzero rank-8 LoRA factors from a numpy seed, f32:
   * SERVE: gpt2-small at full width (12 layers, d 768, vocab 50257),
     batch 8, prompt 128, 64 greedy decode steps;
   * SERVE-SPARSE: the same model with the paper's block-sparse attention
     (``impl="sparse"``, block 128, local 4, sink 1, stride 8), batch 8,
     prompt 896, 128 decode steps (1024 = max_position);
   * SERVE-MAMBA: mamba2-1.3b at full width and depth (48 layers, d 2048,
     64 heads of 64, state 128, vocab 50280), batch 4, prompt 512, 32
     decode steps, LoRA on in_proj and out_proj;
   * SERVE-LLAMA: llama3.2-1b at its published widths and depth (16
     layers, d 2048, 32 query heads on 8 KV heads of 64, d_ff 8192 SwiGLU,
     RoPE θ 5e5, tied vocab 128256), batch 8, prompt 512, 64 decode steps,
     LoRA on wq and wv: GQA through ``flash_attn`` and ``decode_attn``;
   * SERVE-LLAMA-R64: the same model and weights (``weights_of``) with
     rank-64 LoRA on wq and wv (numpy seed 1), batch 8, prompt 512, 32
     decode steps: ``lora_fused``'s x·A through its workspace in prefill
     (M 4096, N 2048 / 512) and in the decode branch's main loop (M 8);
   * SERVE-ZOO: gemma3-12b (sliding-window ring caches: window 64, both
     rings wrap), internvl2-26b (8 projected patch positions before the
     prompt), dbrx-132b (MoE) and jamba-v0.1-52b (attention + Mamba + MoE)
     at ``.reduced(d_model=256, repeats=2)`` (head width 64), batch 2,
     prompt 96, 40 decode steps, no PROFILE;
   * SERVE-WHISPER: whisper-base at its published widths and depth (6
     encoder + 6 decoder layers, d 512, 8 heads of 64, d_ff 2048, vocab
     51865, 1500 random post-conv frames), batch 8, prompt 64, 64 decode
     steps, LoRA on wq and wv: the encoder's non-causal ``flash_attn`` over
     1500 frames, the ``dec`` layers' causal and cross ``flash_attn`` in
     prefill, two ``decode_attn`` a layer a step (self, cross over 1500);
   * SERVE-GEMMA3 and SERVE-GEMMA3-SPARSE: gemma3-12b at its published
     widths (d 3840, 16 query heads on 8 KV heads of 240, GeGLU d_ff
     15360, tied vocab 262144, window 1024), cut to one repeat of its 5:1
     pattern (``gemma3_cut``: 5 ``local`` layers and 1 global, 2.33 B
     parameters), batch 2, prompt 1152 (past the window: the rings wrap in
     prefill), 32 decode steps, LoRA on wq and wv (the sparse path serves
     the dense path's weights): heads of 240 through
     ``flash_attn`` (windowed on the local layers) and ``decode_attn``
     (rings and the global cache), and under ``impl="sparse"`` the global
     layer through ``block_sparse_attn`` and the sparse decode mask;
   * SERVE-MLA: deepseek-v2-236b's MLA at its published widths (d 5120,
     128 heads, q_lora 1536, kv_lora 512, rope 64, nope 128, v 128, vocab
     102400, dense FF 12288, experts of 1536 with 2 shared and top-6), cut
     to the prologue layer and one MoE layer and to 16 routed experts
     (``mla_cut``, 1.96 B parameters), batch 4, prompt 256, 32 decode
     steps, LoRA on the four MLA targets: ``flash_attn`` at (q/k 192, v
     128), ``lora_fused`` at the MLA shapes, the absorbed decode in plain
     torch, timed apart (its share of the decode step's device time);
   * SERVE-WIDTHS: gpt2-small at ``.reduced(d_model=72, repeats=2)`` (4
     heads of 18: the attention kernels' element path) and
     ``.reduced(d_model=2048, repeats=2)`` (4 heads of 512: split over a
     cluster in prefill, sliced in decode), dense
     and block-sparse, batch 2, prompt 128, 16 decode steps, no PROFILE;
   * SERVE-SPARSE-KV: gpt2-small at full width cut to 4 of its 12 layers
     (``sparse_kv_cut``), ``impl="sparse"`` and
     ``opts={"sparse_kv_seq": 1024}``, batch 8, decoded from
     ``init_cache`` over 1024 teacher-forced tokens: ``decode_attn`` with
     its LSE over up to three slot ranges a layer a step, merged; launches
     against the ranges'; the first row re-run on the CPU at 26 checked
     steps; prefill of 896 tokens timed beside it.
   Each path's kernel launch counts are set to 0 just before it runs and
   checked against the path's just after; prefill is then run 7 more times
   and its median printed beside the run's one prefill; then prefill and
   the first 8 decode steps are re-run on the CPU through the plain versions
   (teacher-forced with the card's tokens, on a subset of the rows) and the
   logits are held to the path's tolerance.
5. profile — torch.profiler over one prefill and 16 decode steps of each
   serving path (SERVE-SPARSE-KV: 16 decode steps at positions 1008-1023).
6. grads   — each autograd Function (``lora_fused``'s at ranks 8 and 64,
   ``flash_attn``'s,
   non-causal and causal, and ``ssd_chunk``'s ``SSDScan``: the kernel
   forward, a plain-torch backward) at
   the training paths' shapes, ``flash_attn``'s at MLA's (q/k 80, v 64:
   the (96, 64) tile) and at heads of 16 (the launcher's default arch
   round, the 32 tile): every input gradient against autograd of the plain version on the
   card (GRAD lines, f32 tolerances of TOL), forward and backward device
   times of both.
7. TRAIN-PFTT — ``run_pftt`` (the launcher's ``--fl-clients 4
   --fl-rounds 3`` settings, seed 0, f32) for the four methods of Fig. 5:
   pretraining seconds, seconds per round, accuracy per round, mean round
   bytes and delay, each kernel's launches against the path's count; then
   the same runs on the CPU through the plain versions from the same init:
   bytes and delays equal, accuracies and local losses within tolerance.
8. TRAIN-ROBERTA — roberta-base at full width and depth (12 layers, d 768,
   vocab 50265) through ``launch/train.py``'s PEFT step (adapters + rank-8
   LoRA on wq/wv, MLM loss, batch 16, sequence 128), 10 AdamW steps: step
   times, losses, launches per step (checked), forward and backward device
   times and a PROFILE of one step; the first 2 steps re-run on the CPU from
   the same init and batches, losses and trainables held to tolerance.
9. TRAIN-PFIT — ``run_pfit`` for the four methods of Fig. 4 (pfit, sfl,
   pfl, shepherd) at ``benchmarks/fig4_pfit.py``'s quick profile cut to 2
   rounds, 60 pretraining and 60 reward-model steps (``PFIT_QUICK``; the
   profile has 4 and 120 + 120), 4 clients, rollout batch 16,
   prompt 16, gen 24, d 128, 4 layers, seed 0, f32): pretraining and
   reward-model seconds, seconds per round, reward per round, pair
   accuracies, mean round bytes and delay, each kernel's launches against
   ``pfit_expected``; then pfit's run (``PFIT_CPU_METHODS``) on the CPU
   through the plain versions from the same seeds and noise streams (bytes
   and delays equal,
   pair accuracies and rewards within tolerance, round 0's tokens equal but
   at f32 near-ties), and a PROFILE of a run (1 round, 10 pretraining and
   10 reward-model steps).
10. TRAIN-PPO — one client's PPO round at gpt2-small's full width and
   depth (rollout batch 8, prompt 128, 64 sampled decode steps, then
   ``PPOTrainer.round``: prep and 2 clipped epochs, masks last-2-layers ×
   40 % head sparsity; the terminal reward a fixed numpy draw, since the
   reward models exist only over the synthetic 512-token vocabulary):
   rollout, prep and step ms, forward and backward device ms, launches per
   phase (checked), a PROFILE of a step; then prep and the first epoch on
   the CPU from the same init and the card's tokens (logp, advantages,
   loss, trainables, masked-out parameters bit-equal).
11. TRAIN-ROBUST — the straggler-tolerant robust round: (a) ``run_pftt``
   (pftt) at TRAIN-PFTT's settings for 6 rounds under the launcher's fault
   plan, deadline, quorum and staleness flags (tests/test_deadline.py's MIX
   and DL): seconds and accuracy per round, the ledger's simulated time,
   quorum no-ops, deliveries and corruptions, the tracker's counters,
   launches against the trace's training client-rounds; a run killed after
   3 rounds and resumed from its checkpoint (ledger equal, accuracies
   within tolerance) and a CPU re-run (the same); (b) ``run_pfit`` (pfit)
   at TRAIN-PFIT's quick profile for 4 rounds under tests/test_faults.py's
   FAULTY: rewards and seconds per round, launches, a CPU re-run (ledger
   equal, rewards within tolerance); (c) ``build_ppo_round(robust=True)``
   at gpt2-small's full width (TRAIN-PPO's setup, 2 clients): the robust
   round's ms beside the synchronous round's on the same inputs, then
   hand-set rounds (a straggler, clients the broadcast skips, a rejoin, a
   deadline miss, a round voided under a quorum of 2) whose selections must
   hold bit for bit on the card and whose one-delivery globals must equal
   the plain ``masked_fedavg_stacked`` of that client alone.
12. TRAIN-ORACLES — the JAX package's two parity oracles, each held to an
   engine run above (not run again): (a) the legacy per-client loop
   (``run_pftt(engine=False)``, pftt) at TRAIN-PFTT's settings and (b)
   under TRAIN-ROBUST (a)'s flags, (c) ``run_pfit(engine=False)`` (pfit)
   at TRAIN-PFIT's quick profile, (d) the merged-LoRA path
   (``run_pftt(factored=False)``, fedlora): seconds a round beside the
   engine's, launches equal to the engine's count (none of ``lora_fused``
   in (d)), bytes and delays (every record in (b)) equal, accuracies,
   losses and rewards within TRAIN-PFTT's and TRAIN-PFIT's tolerances.
13. TRAIN-COMMS — the compressed uplink (``repro_torch.comms``): (a)
   ``run_pftt`` at TRAIN-PFTT's settings, fedlora under int8, int4, sketch
   (top-k) and countsketch and int4 with ``factored_agg``, and pftt with
   int4 under TRAIN-ROBUST (a)'s flags: seconds and accuracy per round,
   mean round bytes and delay, each client-round's realized bits beside
   ``payload_bits_upper_bound`` and the raw ``tree_bytes``·8, launches;
   for the sketches, int4 with ``factored_agg`` and the robust int4 run a
   CPU re-run from the same init and uniforms (bits and delays within
   1e-6, or 1e-3 under a quantizer, whose symbols may sit one step apart
   where the card's and the CPU's training differ; the deadline run's
   deliveries and no-ops equal; accuracies within 0.05); (b)
   ``build_ppo_round(codec=int4)`` at gpt2-small's full width (2 clients,
   TRAIN-ROBUST (c)'s masks) in turns with the codec-free round, one robust
   int4 round, then each codec's ``roundtrip`` on a client's post-round
   params: ms, bits beside the bound and the masked raw size, masked-out
   elements kept, the quantizers against a CPU roundtrip and a float64
   recount of their bits; (c) ``svd_reproject`` on roberta-base's
   full-width LoRA (4 clients, rank 8, wq and wv of 12 layers) against the
   dense oracle, both timed.
14. TRAIN-POP — population mode and telemetry (``repro_torch.fl``,
   ``repro_torch.obs``): (a) ``launch/train.py --population 256 --cohort 8
   --fl-rounds 2`` under docs/ci.md's availability and straggler flags with
   ``--telemetry-dir D --trace``: seconds and host ms a round, the store's
   MB, launches against the client-rounds that train; the event stream
   validates, ``report --check`` exits 0, ``trace.json``'s spans nest,
   every round event carries the seven health scalars; a CPU re-run
   (cohorts, bytes and delays equal, accuracies within 0.05, health within
   1e-3 relative); (b) the same for 4 rounds, killed after 2 and resumed:
   ledger, cohorts and tracker equal, canonical streams equal (byte for
   byte, or each float within 1e-5), no round event twice; (c) shepherd
   population (``run_pfit``, 64 clients, cohort 4, TRAIN-PFIT's quick
   profile, 2 rounds) with health, launches, a CPU re-run; (d) the robust
   body with health at roberta-base's full width through
   ``PopulationRunner`` (64 clients, cohort 4, 4 rounds): health against
   the float64 oracle, unsampled rows unchanged, state bitwise equal with
   health on and off, each timed in turns.
15. ARCH-ROUND — the universal factored round (``core/arch_round.py``)
   through ``launch/train.py --arch X --fl-clients 4 --fl-rounds 2
   --assert-fused`` at ``--fl-dmodel 256`` (heads of 64), at the
   launcher's default width, d 64 (heads of 16, MLA's (32, 16): the 32
   tile), and at d 72 (heads of 18, MLA's (34, 18): elements), for
   gpt2-small, llama3.2-1b, gemma3-12b, internvl2-26b,
   dbrx-132b, jamba-v0.1-52b, mamba2-1.3b, deepseek-v2-236b (MLA with
   gradient: (80, 64) in the (96, 64) tile at d 256) and whisper-base:
   seconds a round, losses, the launcher's on-card oracle check (≤ 1e-5),
   launches against ``arch_expected``; a CPU re-run (losses within
   1e-5); and at d 1088 (heads of 272, MLA's (288, 272): split) for
   gpt2-small, llama3.2-1b, deepseek-v2-236b and whisper-base.  The
   grads phase has a GRAD row for ``SSDScan`` (the SSD scan's Function) at
   the jamba/mamba2 round's shape, and the kernels phase CHECK rows at
   SERVE-LLAMA's and SERVE-ZOO's shapes, at SERVE-MLA's, SERVE-WHISPER's,
   SERVE-SPARSE-KV's and the MLA round's (``mla_whisper_cases``), and at
   SERVE-GEMMA3's heads of 240 and the default arch round's heads of 16
   (``width_cases``).
16. TRAIN-MESH — the client-sharded cohort over ``torch.distributed``
   (``repro_torch.sharding``, ``launch/mesh.py``): (a) ``run_pftt`` at
   TRAIN-PFTT's settings (pftt) under a one-rank NCCL group against the
   same card's unsharded run from the same state: round records (bytes,
   delays, outage selections), accuracies and launches equal, the
   checkpointed trainables and optimizer state bit for bit; s a round both
   ways and each ``all_reduce``'s device ms (CUDA events around the
   call); (b) two ranks on the one card over gloo (``chip_smoke.py
   --mesh-rank``, spawned), 3 clients, so rank 1 holds a ghost: against
   the unsharded card run of the same 3 clients, accuracies within 1e-6,
   records equal, launches summed over the ranks equal to the unsharded
   count plus the ghost's and the second rank's pretraining; (c)
   ``python -m torch.distributed.run --standalone --nproc-per-node 1 -m
   repro_torch.launch.train --arch roberta-base --fl-clients 4 --fl-rounds
   1`` must exit 0.
17. LAUNCH — ``launch/steps.py``'s ``make_prefill_step`` and
   ``make_serve_step`` at gpt2-small's full width (batch 8, prompt 128, 8
   decode steps, rank-8 LoRA): their logits equal to SERVE's path
   (``serve.generate``) on the same weights, launches checked; then
   ``launch/train.py --arch roberta-base --steps 3`` at full width (batch 16,
   seq 128) with and without rematerialization: losses within 1e-5, step
   ms and ``torch.cuda.max_memory_allocated`` each, launches a step (remat
   runs each forward kernel twice); the launcher's ``--ckpt`` read back
   through ``checkpoint.load_checkpoint``.

18. TP — the (data, model) tensor-parallel mesh, llama3.2-1b at full width
   cut to 2 layers: (a) ``launch.train --steps 2 --data-axis 1`` under a
   one-rank NCCL torchrun, losses and trained parameters bit-equal to the
   meshless card run; (b) the same as 4 gloo ranks on the card, (2, 2):
   losses and unsharded parameters within 1e-4 (elements whose √v̂ is
   small held to 2e-4), s a step, each rank's peak memory beside the
   meshless run's; (c) SERVE-TP on (1, 4) (``chip_smoke.py --tp-rank``,
   spawned): prefill 128 and 16 decode steps with LoRA on wq/wv, logits
   within SERVE's gate of the meshless run, per-rank launches (flash_attn
   on 8 of 32 heads, lora_fused on local slices, decode_attn on each
   rank's segment: rank 1's empty for 8 steps); (d) ``mamba_sp``
   (mamba2-1.3b, 2 layers) and ``moe_a2a`` (``mla_cut``) on (1, 4): one
   loss and its gradient within 1e-4 of the meshless run (per leaf and
   rank: the norm, and 2048 sampled elements), the balance loss weighted
   0 (at 4 tokens a rank, where a2a drops nothing); ``moe_a2a``'s layer
   alone (``mla_cut``'s MoE layer, 16 tokens a rank pulled towards rank
   0's experts so that both capacities drop choices) against
   ``a2a_loopback``, the same capacities on one process, output, balance
   loss and gradients within 1e-4; (e) a DRYRUN line of llama3.2-1b ``train_4k`` on the abstract
   (16, 16) mesh.

Before the last line it prints one JSON object with a row per kernel (its
launches summed over the serving, training, robust, comms, population,
arch-round, mesh, launch and tensor-parallel paths' main runs); the last
line is
``{"ok": true, "device": {...}}``.  Any failed check exits
nonzero before that line.
"""
import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12,      # CUDA cores, no TF32
              "bfloat16": 989e12}    # dense tensor cores
# (atol, rtol) of each kernel against its plain version
TOL = {("lora_fused", "float32"): (1e-4, 1e-4), ("lora_fused", "bfloat16"): (3e-2, 3e-2),
       ("flash_attn", "float32"): (2e-5, 2e-5), ("flash_attn", "bfloat16"): (2e-2, 2e-2),
       ("decode_attn", "float32"): (2e-5, 2e-5), ("decode_attn", "bfloat16"): (3e-2, 3e-2),
       ("block_sparse_attn", "float32"): (2e-5, 2e-5),
       ("block_sparse_attn", "bfloat16"): (2e-2, 2e-2),
       ("ssd_chunk", "float32"): (5e-4, 1e-3), ("ssd_chunk", "bfloat16"): (2e-2, 2e-2)}
KERNELS = ("lora_fused", "flash_attn", "decode_attn", "block_sparse_attn", "ssd_chunk")
REPLACES = {"lora_fused": "src/repro/kernels/lora_fused/kernel.py:69",
            "flash_attn": "src/repro/kernels/flash_attn/kernel.py:85",
            "decode_attn": "src/repro/kernels/decode_attn/kernel.py:92",
            "block_sparse_attn": "src/repro/kernels/block_sparse_attn/kernel.py:102",
            "ssd_chunk": "src/repro/kernels/ssd_chunk/kernel.py:76"}
GEMMA3_PROMPT = 1152     # SERVE-GEMMA3's prompt: 9 sparse blocks, past the window of 1024
# Serving paths.  ``rows``: batch rows re-run on the CPU; ``logit_tol``:
# the card's logits against the CPU's, absolute, times max(1, max |logit|).
# f32 on both sides: what differs is the order of the sums (tiles, split
# reductions), about 1e-6 relative per layer, so 1e-3 leaves two orders of
# margin over 12 and 48 layers.
SERVES = (
    dict(tag="SERVE", arch="gpt2-small", impl="auto", batch=8, prompt_len=128,
         gen=64, rank=8, rows=8, logit_tol=1e-3),
    dict(tag="SERVE-SPARSE", arch="gpt2-small", impl="sparse", batch=8,
         prompt_len=896, gen=128, rank=8, rows=2, logit_tol=1e-3),
    dict(tag="SERVE-MAMBA", arch="mamba2-1.3b", impl="auto", batch=4,
         prompt_len=512, gen=32, rank=8, rows=1, logit_tol=1e-3),
    # llama3.2-1b at its published widths and depth: GQA (32 query heads on
    # 8 KV heads of 64), RoPE θ 5e5, tied 128256-token head, 1.24 B params
    dict(tag="SERVE-LLAMA", arch="llama3.2-1b", impl="auto", batch=8,
         prompt_len=512, gen=64, rank=8, rows=1, logit_tol=1e-3),
    # the same weights (``weights_of``: one host draw of 1.24 B parameters)
    # with rank-64 LoRA on wq/wv: lora_fused's x·A through its workspace in
    # prefill (M 4096), in the decode branch's main loop (M 8)
    dict(tag="SERVE-LLAMA-R64", arch="llama3.2-1b", impl="auto", batch=8,
         prompt_len=512, gen=32, rank=64, rows=1, logit_tol=1e-3, weights_of="SERVE-LLAMA"),
) + tuple(
    # the rest of the zoo at .reduced(d_model=256, repeats=2): head width
    # 64, gemma3's window 64 so its rings wrap in prefill and decode;
    # internvl2's 8 patch positions
    dict(tag=f"SERVE-ZOO {arch}", arch=arch, impl="auto", batch=2, prompt_len=96, gen=40,
         rank=8, rows=2, logit_tol=1e-3, reduced=dict(d_model=256, repeats=2),
         profile=False)
    for arch in ("gemma3-12b", "internvl2-26b", "dbrx-132b", "jamba-v0.1-52b")) + (
    # whisper-base at its published widths and depth (6 encoder + 6 decoder
    # layers, d 512, 8 heads of 64, vocab 51865, 1500 random post-conv
    # frames): the encoder-decoder, cross-attention in prefill and decode
    dict(tag="SERVE-WHISPER", arch="whisper-base", impl="auto", batch=8, prompt_len=64,
         gen=64, rank=8, rows=1, logit_tol=1e-3),
    # deepseek-v2-236b's MLA at its published widths (mla_cut: two layers,
    # 16 routed experts): q/k 192, v 128 in prefill, absorbed decode
    dict(tag="SERVE-MLA", arch="deepseek-v2-236b", impl="auto", batch=4, prompt_len=256,
         gen=32, rank=8, rows=1, logit_tol=1e-3, cut="mla"),
    # gemma3-12b at its published widths, heads of 240 (gemma3_cut: one
    # repeat of its 5:1 pattern); the prompt passes the window of 1024.
    # The sparse path serves the dense path's weights (``weights_of``: one
    # host draw of 2.33 B parameters, not two)
    dict(tag="SERVE-GEMMA3", arch="gemma3-12b", impl="auto", batch=2,
         prompt_len=GEMMA3_PROMPT, gen=32, rank=8, rows=1, logit_tol=1e-3, cut="gemma3"),
    dict(tag="SERVE-GEMMA3-SPARSE", arch="gemma3-12b", impl="sparse", batch=2,
         prompt_len=GEMMA3_PROMPT, gen=32, rank=8, rows=1, logit_tol=1e-3, cut="gemma3",
         weights_of="SERVE-GEMMA3")) + tuple(
    # SERVE-WIDTHS: gpt2-small at .reduced(d_model=D, repeats=2), 4 heads
    # of 18 (not whole 16-byte chunks: the element path) and of 512 (past
    # 256: split over a cluster; decode sliced), dense and block-sparse
    # (block 16)
    dict(tag=f"SERVE-WIDTHS d{d}{' sparse' if impl == 'sparse' else ''}", arch="gpt2-small",
         impl=impl, batch=2, prompt_len=128, gen=16, rank=8, rows=2, logit_tol=1e-3,
         reduced=dict(d_model=d, repeats=2), profile=False)
    for d in (72, 2048) for impl in ("auto", "sparse"))
TEACHER_STEPS = 8
PREFILL_REPS = 7
# TRAIN-PFTT: card vs CPU (see train_pftt).  TRAIN-ROBERTA: card vs CPU over
# the first CPU_STEPS steps (f32 both sides, only the order of sums
# differs): losses relative to max(1, |loss|); each step's gradients (the
# card's at the card's state, the CPU's at the CPU's) absolute; the
# trainables after the last step absolute, except where AdamW cannot carry
# the measured gradient difference within that limit.  AdamW moves an
# element by lr·g/(|g| + eps), eps 1e-8, of slope lr·eps/(|g| + eps)².  Where
# the CPU's gradient is at least K·δ, δ the element's own card-vs-CPU
# gradient difference, both lie at |g| ≥ (K - 1)·δ, and the two moves differ
# by at most lr·δ·eps/((K - 1)·δ + eps)² ≤ lr/(4·(K - 1)) a step to first
# order: K = 1 + CPU_STEPS·lr/(4·tol) keeps CPU_STEPS steps within tol.  An
# element below that at some step (a near-cancelled sum whose rounding is a
# large share of it; two CPU runs that differ only in thread count put 6 of
# them 1e-4–3.4e-4 apart) is held to AdamW's most, 2·lr a step, and counted.
PFTT_ACC_TOL = 0.05
PFTT_LOSS_TOL = 1e-5
ROBERTA_STEPS = 10
CPU_STEPS = 2
ROBERTA_LOSS_TOL = 1e-4
ROBERTA_GRAD_TOL = 1e-5
ROBERTA_PARAM_TOL = 1e-4
SERVING_SPARSE = dict(block_size=128, local_blocks=4, sink_blocks=1, stride=8)


def ptxas_lines(log):
    """ptxas's register and spill lines from ``-Xptxas -v``'s report, each
    after the kernel instance it belongs to, as ``name<template args>`` (the
    mangled entry's length-prefixed name and its int/bool arguments)."""
    import re
    inst = ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            n = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
            if n:
                start = n.end() + int(n.group(1))
                args = mangled[start:mangled.find("Ev", start)]
                dtype = "bf16" if "bfloat16" in args else "f32"
                inst = (f"{mangled[n.end():start]}<{dtype},"
                        + ",".join(re.findall(r"L[ib](\d+)E", args)) + ">")
            else:
                inst = mangled[:60]
        elif "registers" in line or "spill" in line:
            yield f"{inst}: {line.strip()}"


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing
def device_ms(fn, flush, iters=30):
    """Median device time of ``fn`` in ms over ``iters`` calls.  Before each
    call the L2 is flushed and the stream is held by a spin kernel while the
    host enqueues the call, so the events bracket device work only, not
    launch overhead."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[iters // 2]


def skinny_plan(dtype, n, k):
    """(strip width, K split) that lora_fused's decode branch (M ≤ 16)
    takes for an N-column, K-deep call on this card: the C rule itself."""
    import ctypes

    from repro_torch.kernels import _build
    fn = _build.function("lora_fused", [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
                         symbol="lora_skinny_plan")
    strip, split = ctypes.c_int(0), ctypes.c_int(0)
    if fn({"float32": 0, "bfloat16": 1}[dtype], n, k, ctypes.byref(strip),
          ctypes.byref(split)):
        fail(f"lora_skinny_plan refused N {n} K {k}")
    return strip.value, split.value


def read_ranges(sc, cache_len, window=0, sparse=None):
    """The contiguous ranges [a, b) of cache positions a decode call reads."""
    import torch

    from repro_torch.models.attention import sparse_position_mask
    pos = torch.arange(sc)
    mask = pos < cache_len
    if window:
        mask &= pos >= cache_len - window
    if sparse is not None:
        mask &= sparse_position_mask(pos, cache_len, sparse)
    ranges, start = [], None
    for p, on in enumerate(mask.tolist() + [False]):
        if on and start is None:
            start = p
        elif not on and start is not None:
            ranges.append((start, p))
            start = None
    return ranges


def read_call(kv, ranges):
    """A plain read of the K and V positions a decode call reads: one
    ``torch.sum`` per range over ``kv`` (2, B, Sc, K, hd), K and V stacked."""
    return lambda: [kv[:, :, a:b].sum() for a, b in ranges]


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- kernels
def kernel_cases(torch):
    """(name, label, kernel call, plain call, library call, bytes, flops,
    dtype) at the serving paths' shapes plus ragged and GQA/window cases."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn.ops import decode_attention, split_plan
    from repro_torch.kernels.decode_attn.ref import decode_ref
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.flash_attn.ref import attention_ref
    from repro_torch.kernels.lora_fused.ops import lora_matmul
    from repro_torch.kernels.lora_fused.ref import lora_ref

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")

    def rn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    cases = []
    for dt in (torch.float32, torch.bfloat16):
        es = torch.finfo(dt).bits // 8
        dname = str(dt).split(".")[1]
        for m in (8, 1024, 77, 12):
            k = n = 768
            r = 8
            x, w = rn(m, k, dtype=dt), rn(k, n, std=0.05, dtype=dt)
            a, b = rn(k, r, std=0.05, dtype=dt), rn(r, n, std=0.05, dtype=dt)
            merged = (w.float() + 2.0 * (a.float() @ b.float())).to(dt)
            cases.append(dict(
                name="lora_fused", label=f"M={m} K={k} N={n} r={r}", dtype=dname,
                kernel=lambda x=x, w=w, a=a, b=b: lora_matmul(x, w, a, b, scale=2.0),
                plain=lambda x=x, w=w, a=a, b=b: lora_ref(x, w, a, b, scale=2.0),
                library=lambda x=x, mg=merged: torch.matmul(x, mg),
                nbytes=(m * k + k * n + k * r + r * n + m * n) * es,
                flops=2 * m * k * n + 2 * m * k * r + 2 * m * r * n,
                plan=(dname, n, k) if m <= 16 else None,
                main=(m == 8 and dt == torch.float32)))
        # then the reduced RoBERTa encoder's non-causal attention (PFTT),
        # roberta-base's at full width (TRAIN-ROBERTA), PFIT's policy (B 16,
        # S 39, hd 32: its PPO step and pretraining) and gpt2's PPO step at
        # full width (TRAIN-PPO: S 191, no tile multiple), causal
        for bsz, s, h, kh, d, window, causal in ((8, 128, 12, 12, 64, 0, True),
                                                 (8, 77, 12, 12, 64, 0, True),
                                                 (2, 200, 8, 2, 32, 96, True),
                                                 (8, 32, 4, 4, 32, 0, False),
                                                 (16, 128, 12, 12, 64, 0, False),
                                                 (16, 39, 4, 4, 32, 0, True),
                                                 (8, 191, 12, 12, 64, 0, True)):
            if dt == torch.bfloat16 and (bsz == 16 or s == 191):
                continue
            q, kk, vv = rn(bsz, s, h, d, dtype=dt), rn(bsz, s, kh, d, dtype=dt), rn(bsz, s, kh, d, dtype=dt)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kk, vv))
            allowed = (sum(min(i + 1, window) if window else i + 1 for i in range(s))
                       if causal else s * s)
            cases.append(dict(
                name="flash_attn", label=f"B={bsz} S={s} H={h} K={kh} hd={d} "
                f"{'causal' if causal else 'non-causal'} window={window}",
                dtype=dname,
                kernel=lambda q=q, k=kk, v=vv, w=window, c=causal: flash_attention(q, k, v, causal=c, window=w),
                plain=lambda q=q, k=kk, v=vv, w=window, c=causal: attention_ref(q, k, v, causal=c, window=w),
                library=(None if window or h != kh else lambda q=qt, k=kt, v=vt, c=causal:
                         F.scaled_dot_product_attention(q, k, v, is_causal=c)),
                nbytes=(2 * bsz * s * h * d + 2 * bsz * s * kh * d) * es,
                flops=4 * d * allowed * bsz * h,
                main=(s == 128 and bsz == 8 and causal and dt == torch.float32)))
        # SERVE's decode, ragged lengths, GQA with a window, and PFIT's
        # rollouts (hd 32, cache 40 = prompt 16 + 24 steps)
        for bsz, sc, h, kh, d, clen, window in ((8, 192, 12, 12, 64, 192, 0),
                                                (8, 192, 12, 12, 64, 101, 0),
                                                (8, 192, 12, 12, 64, 1, 0),
                                                (2, 256, 8, 4, 128, 201, 64),
                                                (16, 40, 4, 4, 32, 40, 0)):
            if dt == torch.bfloat16 and d == 32:
                continue
            q, kv = rn(bsz, 1, h, d, dtype=dt), rn(2, bsz, sc, kh, d, dtype=dt)
            kc, vc = kv
            lo = max(0, clen - window) if window else 0
            valid = min(clen, sc) - lo
            qt = q.transpose(1, 2).contiguous()
            kt, vt = (t[:, lo:min(clen, sc)].transpose(1, 2).contiguous() for t in (kc, vc))
            cases.append(dict(
                name="decode_attn", label=f"B={bsz} Sc={sc} H={h} K={kh} hd={d} cache_len={clen} window={window}",
                dtype=dname,
                kernel=lambda q=q, k=kc, v=vc, c=clen, w=window: decode_attention(q, k, v, c, window=w),
                plain=lambda q=q, k=kc, v=vc, c=clen, w=window: decode_ref(q, k, v, c, window=w),
                # over the positions read (the window is one contiguous range)
                library=lambda q=qt, k=kt, v=vt, g=h != kh:
                F.scaled_dot_product_attention(q, k, v, enable_gqa=g),
                nbytes=(2 * bsz * h * d + 2 * bsz * valid * kh * d) * es,
                flops=4 * d * valid * bsz * h,
                split=split_plan(bsz, sc, h, window=window),
                read=(read_call(kv, read_ranges(sc, clen, window))
                      if dt == torch.float32 else None),
                main=(clen == 192 and dt == torch.float32)))
        cases += sparse_cases(torch, dt, dname, es, rn)
        cases += ssd_cases(torch, dt, dname, es, rn)
    # SERVE-SPARSE's prefill projection (M = 8·896), and mamba2-1.3b's:
    # in_proj K 2048 → N 8512 (not a multiple of 64), out_proj K 4096 →
    # N 2048, at prefill (M 2048) and decode (M 4); the decode rows in bf16
    # too; then the training paths' wq/wv: TRAIN-ROBERTA (M 16·128, d 768)
    # and PFTT's at batch 16 (M 16·32, d 128)
    for m, k, n, path, dt in ((7168, 768, 768, "sparse", torch.float32),
                              (2048, 768, 768, "roberta train", torch.float32),
                              (512, 128, 128, "pftt train", torch.float32),
                              (2048, 2048, 8512, "mamba", torch.float32),
                              (4, 2048, 8512, "mamba", torch.float32),
                              (2048, 4096, 2048, "mamba", torch.float32),
                              (4, 4096, 2048, "mamba", torch.float32),
                              (4, 2048, 8512, "mamba", torch.bfloat16),
                              (4, 4096, 2048, "mamba", torch.bfloat16)):
        es = torch.finfo(dt).bits // 8
        x, w = rn(m, k, dtype=dt), rn(k, n, std=0.02, dtype=dt)
        a, b = rn(k, 8, std=0.02, dtype=dt), rn(8, n, std=0.05, dtype=dt)
        merged = (w.float() + 2.0 * (a.float() @ b.float())).to(dt)
        cases.append(dict(
            name="lora_fused", label=f"M={m} K={k} N={n} r=8 ({path})",
            dtype=str(dt).split(".")[1],
            kernel=lambda x=x, w=w, a=a, b=b: lora_matmul(x, w, a, b, scale=2.0),
            plain=lambda x=x, w=w, a=a, b=b: lora_ref(x, w, a, b, scale=2.0),
            library=lambda x=x, mg=merged: torch.matmul(x, mg),
            nbytes=(m * k + k * n + k * 8 + 8 * n + m * n) * es,
            flops=2 * m * k * n + 2 * m * k * 8 + 2 * m * 8 * n, main=False,
            plan=(str(dt).split(".")[1], n, k) if m <= 16 else None,
            profile=(m == 4 and n == 2048 and dt == torch.float32)))
    return (cases + rank_cases(torch, rn) + zoo_cases(torch, rn)
            + mla_whisper_cases(torch, rn) + width_cases(torch, rn)
            + any_width_cases(torch, rn))


def rank_cases(torch, rn):
    """lora_fused above rank 32, f32: SERVE-LLAMA-R64's wq and wv at prefill
    (M 4096, K 2048; x·A through the workspace) and decode (M 8; x·A in the
    decode branch's main loop up to rank 64), gpt2's decode (M 8, K = N
    768) and the rank-64 GRAD row's forward (M 2048, K = N 768), at ranks 64
    and 128 (the workspace in both branches)."""
    from repro_torch.kernels.lora_fused.ops import lora_matmul
    from repro_torch.kernels.lora_fused.ref import lora_ref

    cases = []
    for r in (64, 128):
        for m, k, n, what in ((4096, 2048, 2048, "llama prefill wq"),
                              (4096, 2048, 512, "llama prefill wv"),
                              (8, 2048, 2048, "llama decode wq"),
                              (8, 2048, 512, "llama decode wv"),
                              (8, 768, 768, "gpt2 decode"),
                              (2048, 768, 768, "GRAD's shape")):
            x, w = rn(m, k), rn(k, n, std=0.02)
            a, b = rn(k, r, std=0.02), rn(r, n, std=0.05)
            merged = w + 0.25 * (a @ b)
            cases.append(dict(
                name="lora_fused", label=f"M={m} K={k} N={n} r={r} ({what})", dtype="float32",
                kernel=lambda x=x, w=w, a=a, b=b: lora_matmul(x, w, a, b, scale=0.25),
                plain=lambda x=x, w=w, a=a, b=b: lora_ref(x, w, a, b, scale=0.25),
                library=lambda x=x, mg=merged: torch.matmul(x, mg),
                nbytes=(m * k + k * n + k * r + r * n + m * n) * 4,
                flops=2 * m * k * n + 2 * m * k * r + 2 * m * r * n, main=False,
                plan=("float32", n, k) if m <= 16 else None))
    return cases


def attn_case(torch, name, label, kernel, plain, q, k, v, allowed, mask=None, scale=None,
              causal=False, **extra):
    """A CHECK row of a prefill attention kernel at q (B, Sq, H, dk), k
    (B, Sk, K, dk), v (B, Sk, K, dv): bytes of q, k, v and o once, 2·(dk +
    dv) FLOP per allowed (query, key) pair and head; the library call is
    SDPA (which takes dv ≠ dk) with ``mask`` or ``causal``."""
    import torch.nn.functional as F
    b, sq, h, dk = q.shape
    sk, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return dict(
        name=name, dtype="float32", label=label, kernel=kernel, plain=plain,
        library=lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, scale=scale,
            enable_gqa=h != kh),
        nbytes=(b * sq * h * (dk + dv) + b * sk * kh * (dk + dv)) * 4,
        flops=2 * (dk + dv) * allowed * b * h, main=False, **extra)


def mla_whisper_cases(torch, rn):
    """f32 rows at the MLA, whisper and sparse-KV paths' shapes: ``flash_attn`` at
    SERVE-MLA's prefill (deepseek-v2's published (192, 128), B 4, S 256, H
    128, scale 192^-1/2) and at ARCH-ROUND's deepseek-v2 (q/k 80, v 64 in
    the (96, 64) tile; B 4, S 16, H 4), ``block_sparse_attn`` at (192, 128), S 512;
    whisper's three flash shapes at SERVE-WHISPER (the encoder non-causal
    over 1500 frames, the decoder's causal self-attention over the prompt,
    the cross-attention of the prompt on the 1500 frames); ``decode_attn``'s
    cross step (cache 1500) and the LSE output at SERVE-SPARSE-KV's last
    step, one row for each of its three slot ranges (the persistent
    prefix, the ring's two pieces)."""
    import torch.nn.functional as F

    from repro_torch.configs import SparseAttnConfig
    from repro_torch.kernels.block_sparse_attn.ops import block_sparse_attention
    from repro_torch.kernels.block_sparse_attn.ref import block_sparse_ref
    from repro_torch.kernels.decode_attn.ops import decode_attention, split_plan
    from repro_torch.kernels.decode_attn.ref import decode_ref
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.flash_attn.ref import attention_ref
    from repro_torch.models.attention import sparse_block_table, sparse_kv_layout, sparse_kv_ranges

    cases = []
    for b, sq, sk, h, dk, dv, causal, sc, path in (
            (4, 256, 256, 128, 192, 128, True, 192 ** -0.5, "SERVE-MLA prefill"),
            (4, 16, 16, 4, 80, 64, True, None, "ARCH-ROUND deepseek-v2 d 256, the (96, 64) tile"),
            (8, 1500, 1500, 8, 64, 64, False, None, "SERVE-WHISPER encoder"),
            (8, 64, 64, 8, 64, 64, True, None, "SERVE-WHISPER decoder self"),
            (8, 64, 1500, 8, 64, 64, False, None, "SERVE-WHISPER cross")):
        q, k, v = rn(b, sq, h, dk), rn(b, sk, h, dk), rn(b, sk, h, dv)
        allowed = sq * (sq + 1) // 2 if causal else sq * sk
        cases.append(attn_case(
            torch, "flash_attn",
            f"B={b} Sq={sq} Sk={sk} H={h} dk={dk} dv={dv} "
            f"{'causal' if causal else 'non-causal'} ({path})",
            lambda q=q, k=k, v=v, c=causal, s=sc: flash_attention(q, k, v, causal=c, scale=s),
            lambda q=q, k=k, v=v, c=causal, s=sc: attention_ref(q, k, v, causal=c, scale=s),
            q, k, v, allowed, scale=sc, causal=causal))
    serving = SparseAttnConfig(**SERVING_SPARSE)
    b, s_, h = 4, 512, 128
    q, k, v = rn(b, s_, h, 192), rn(b, s_, h, 192), rn(b, s_, h, 128)
    idx, valid = sparse_block_table(s_ // 128, s_ // 128, serving, 0)
    allowed = torch.zeros(s_, s_, dtype=torch.bool, device="cuda")
    for i in range(idx.shape[0]):
        for j in idx[i][valid[i]]:
            allowed[i * 128:(i + 1) * 128, j * 128:(j + 1) * 128] = True
    allowed &= torch.ones(s_, s_, dtype=torch.bool, device="cuda").tril()
    cases.append(attn_case(
        torch, "block_sparse_attn", f"B={b} S={s_} H={h} dk=192 dv=128 block=128 (MLA sparse)",
        lambda q=q, k=k, v=v: block_sparse_attention(q, k, v, serving, scale=192 ** -0.5),
        lambda q=q, k=k, v=v: block_sparse_ref(q, k, v, serving, scale=192 ** -0.5),
        q, k, v, int(allowed.sum()), mask=allowed, scale=192 ** -0.5))
    # decode_attn: whisper's cross step, then the sparse-KV ranges with LSE
    b, h, d = 8, 8, 64
    q, kv = rn(b, 1, h, d), rn(2, b, 1500, h, d)
    kc, vc = kv
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
    cases.append(dict(
        name="decode_attn", dtype="float32",
        label=f"B={b} Sc=1500 H={h} hd={d} cache_len=1500 (SERVE-WHISPER cross)",
        kernel=lambda q=q, kc=kc, vc=vc: decode_attention(q, kc, vc, 1500),
        plain=lambda q=q, kc=kc, vc=vc: decode_ref(q, kc, vc, 1500),
        library=lambda qt=qt, kt=kt, vt=vt: F.scaled_dot_product_attention(qt, kt, vt),
        nbytes=(2 * b * h * d + 2 * b * 1500 * h * d) * 4, flops=4 * d * 1500 * b * h,
        split=split_plan(b, 1500, h), read=read_call(kv, [(0, 1500)]), main=False))
    b, h, d, seq = 8, 12, 64, SPARSE_KV_SEQ
    _, _, ring, n_pers = sparse_kv_layout(seq, serving)
    q = rn(b, 1, h, d)
    regions = {"pers": rn(2, b, n_pers, h, d), "ring": rn(2, b, ring, h, d)}
    for reg, end, count in sparse_kv_ranges(seq - 1, serving, seq):
        kv = regions[reg]
        kc, vc = kv
        kt, vt = (t[:, end - count:end].transpose(1, 2).contiguous() for t in (kc, vc))
        cases.append(dict(
            name="decode_attn", dtype="float32",
            label=f"B={b} Sc={kc.shape[1]} H={h} hd={d} slots [{end - count}, {end}) of "
            f"{reg}, LSE (SERVE-SPARSE-KV position {seq - 1})",
            kernel=lambda q=q, k=kc, v=vc, e=end, c=count: decode_attention(
                q, k, v, e, window=c, return_lse=True),
            plain=lambda q=q, k=kc, v=vc, e=end, c=count: decode_ref(
                q, k, v, e, window=c, return_lse=True),
            library=lambda q=q, kt=kt, vt=vt: F.scaled_dot_product_attention(
                q.transpose(1, 2), kt, vt),
            nbytes=(2 * b * h * d + b * h + 2 * b * count * h * d) * 4,
            flops=4 * d * count * b * h, split=split_plan(b, kc.shape[1], h, window=count),
            read=read_call(kv, [(end - count, end)]), main=False))
    return cases


def width_cases(torch, rn):
    """f32 rows at row widths below their compiled tile: SERVE-GEMMA3's
    heads of 240 (the 256 tile; B 2, 16 query heads on 8 KV heads, prompt
    GEMMA3_PROMPT): ``flash_attn`` causal with the local layers' window
    1024 and without (the global layer), ``block_sparse_attn`` at the
    global layer's pattern (block 128, local 4, sink 1, stride 8),
    ``decode_attn`` on a full 1024-slot ring and on the global cache after
    32 steps, plain and under the sparse mask, and its ``lora_fused``
    projections (wq, wv at
    prefill, wq at decode); the default arch round's heads of 16 and MLA's
    (32, 16) (the 32 tile; B 4, S 16, H 4).  Bytes and operations count the
    row widths, not the tile's; the library call is SDPA (``enable_gqa``;
    the window and the sparse pattern as a boolean mask), or ``torch.matmul``
    of the merged weight."""
    import torch.nn.functional as F

    from repro_torch.configs import SparseAttnConfig
    from repro_torch.kernels.block_sparse_attn.ops import block_sparse_attention
    from repro_torch.kernels.block_sparse_attn.ref import block_sparse_ref
    from repro_torch.kernels.decode_attn.ops import decode_attention, split_plan
    from repro_torch.kernels.decode_attn.ref import decode_ref
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.flash_attn.ref import attention_ref
    from repro_torch.models.attention import (make_mask, sparse_block_table,
                                              sparse_position_mask)

    cases = []
    b, s_, h, kh, d = 2, GEMMA3_PROMPT, 16, 8, 240
    cl = GEMMA3_PROMPT + 32               # the global cache after 32 steps
    q, k, v = rn(b, s_, h, d), rn(b, s_, kh, d), rn(b, s_, kh, d)
    for window, layer in ((1024, "local"), (0, "global")):
        mask = make_mask(s_, s_, causal=True, window=window, device=q.device)
        cases.append(attn_case(
            torch, "flash_attn",
            f"B={b} S={s_} H={h} K={kh} hd={d} causal window={window} (SERVE-GEMMA3 {layer})",
            lambda q=q, k=k, v=v, w=window: flash_attention(q, k, v, causal=True, window=w),
            lambda q=q, k=k, v=v, w=window: attention_ref(q, k, v, causal=True, window=w),
            q, k, v, int(mask.sum()), mask=mask if window else None, causal=True))
    serving = SparseAttnConfig(**SERVING_SPARSE)
    idx, valid = sparse_block_table(s_ // 128, s_ // 128, serving, 0)
    allowed = torch.zeros(s_, s_, dtype=torch.bool, device="cuda")
    for i in range(idx.shape[0]):
        for j in idx[i][valid[i]]:
            allowed[i * 128:(i + 1) * 128, j * 128:(j + 1) * 128] = True
    allowed &= torch.ones(s_, s_, dtype=torch.bool, device="cuda").tril()
    cases.append(attn_case(
        torch, "block_sparse_attn",
        f"B={b} S={s_} H={h} K={kh} hd={d} block=128 (SERVE-GEMMA3-SPARSE global)",
        lambda q=q, k=k, v=v: block_sparse_attention(q, k, v, serving),
        lambda q=q, k=k, v=v: block_sparse_ref(q, k, v, serving),
        q, k, v, int(allowed.sum()), mask=allowed))
    q1 = rn(b, 1, h, d)
    for sc, clen, sp, what in ((1024, 1024, None, "local ring"), (cl, cl, None, "global"),
                               (cl, cl, serving, "global, sparse")):
        kv = rn(2, b, sc, kh, d)
        kc, vc = kv
        pos = torch.arange(sc, device="cuda")
        mask = pos < clen
        if sp is not None:
            mask &= sparse_position_mask(pos, clen, sp)
        n_read = int(mask.sum())
        kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
        cases.append(dict(
            name="decode_attn", dtype="float32",
            label=f"B={b} Sc={sc} H={h} K={kh} hd={d} cache_len={clen}"
                  + (" sparse" if sp is not None else "") + f" (SERVE-GEMMA3 {what})",
            kernel=lambda kc=kc, vc=vc, c=clen, p=sp: decode_attention(q1, kc, vc, c, sparse=p),
            plain=lambda kc=kc, vc=vc, c=clen, p=sp: decode_ref(q1, kc, vc, c, sparse=p),
            library=lambda kt=kt, vt=vt, m=mask[None]: F.scaled_dot_product_attention(
                q1.transpose(1, 2), kt, vt, attn_mask=m, enable_gqa=True),
            nbytes=(2 * b * h * d + 2 * b * n_read * kh * d) * 4,
            flops=4 * d * n_read * b * h, split=split_plan(b, sc, h, sparse=sp, head_dim=d),
            read=read_call(kv, read_ranges(sc, clen, sparse=sp)), main=False))
    # SERVE-GEMMA3's LoRA projections: wq (K 3840 → N 3840) and wv (→ N
    # 1920) at prefill (M 2·GEMMA3_PROMPT) and decode (M 2)
    from repro_torch.kernels.lora_fused.ops import lora_matmul
    from repro_torch.kernels.lora_fused.ref import lora_ref
    for m, n, path in ((2 * s_, 3840, "prefill wq"), (2 * s_, 1920, "prefill wv"),
                       (2, 3840, "decode wq")):
        x, w = rn(m, 3840), rn(3840, n, std=0.02)
        a, bb = rn(3840, 8, std=0.02), rn(8, n, std=0.05)
        merged = w + 2.0 * (a @ bb)
        cases.append(dict(
            name="lora_fused", label=f"M={m} K=3840 N={n} r=8 (SERVE-GEMMA3 {path})",
            dtype="float32",
            kernel=lambda x=x, w=w, a=a, b=bb: lora_matmul(x, w, a, b, scale=2.0),
            plain=lambda x=x, w=w, a=a, b=bb: lora_ref(x, w, a, b, scale=2.0),
            library=lambda x=x, mg=merged: torch.matmul(x, mg),
            nbytes=(m * 3840 + 3840 * n + 3840 * 8 + 8 * n + m * n) * 4,
            flops=2 * m * 3840 * n + 2 * m * 3840 * 8 + 2 * m * 8 * n, main=False,
            plan=("float32", n, 3840) if m <= 16 else None))
    for dk, dv in ((16, 16), (32, 16)):
        q, k, v = rn(4, 16, 4, dk), rn(4, 16, 4, dk), rn(4, 16, 4, dv)
        cases.append(attn_case(
            torch, "flash_attn", f"B=4 S=16 H=4 dk={dk} dv={dv} causal (ARCH-ROUND d 64)",
            lambda q=q, k=k, v=v: flash_attention(q, k, v, causal=True),
            lambda q=q, k=k, v=v: attention_ref(q, k, v, causal=True),
            q, k, v, 16 * 17 // 2, causal=True))
    return cases


def any_width_cases(torch, rn):
    """f32 rows at head widths of every plan past whole chunks of 256:
    ``flash_attn`` causal at SERVE-WIDTHS' prefill (B 2, S 128, H 4) with
    heads of 18 (elements), 272 and 512 (split) and MLA's (288, 272) and
    (528, 512) (split, scale dk^-1/2), and heads of 512 at S 1024 (past
    launch latency); ``block_sparse_attn`` (block 16,
    local 2, sink 1, stride 4: the reduced config's pattern) and
    ``decode_attn`` (cache 144 of 144, SERVE-WIDTHS' last step) at heads of
    18 and 512.  Bytes and operations count the rows' widths; the library
    call is SDPA (the pattern as a boolean mask)."""
    import torch.nn.functional as F

    from repro_torch.configs import SparseAttnConfig
    from repro_torch.kernels.block_sparse_attn.ops import block_sparse_attention
    from repro_torch.kernels.block_sparse_attn.ref import block_sparse_ref
    from repro_torch.kernels.decode_attn.ops import decode_attention, split_plan
    from repro_torch.kernels.decode_attn.ref import decode_ref
    from repro_torch.kernels.flash_attn.ops import flash_attention, plan
    from repro_torch.kernels.flash_attn.ref import attention_ref
    from repro_torch.models.attention import sparse_block_table

    def how(dk, dv, decode=False):
        p = plan(dk, dv)
        if decode and p.sliced:
            return f"sliced {p.dk_slices}x{p.dv_slices} in {p.tile}"
        if p.cluster is not None:
            c = p.cluster
            return f"split over {c.ranks} ranks of {c.tile}, " + (
                "chunks" if p.aligned else "elements")
        return f"elements in {p.tile}"

    cases = []
    b, s_, h = 2, 128, 4
    for dk, dv, sq in ((18, 18, s_), (272, 272, s_), (512, 512, s_), (288, 272, s_),
                       (528, 512, s_), (512, 512, 1024)):
        q, k, v = rn(b, sq, h, dk), rn(b, sq, h, dk), rn(b, sq, h, dv)
        cases.append(attn_case(
            torch, "flash_attn",
            f"B={b} S={sq} H={h} dk={dk} dv={dv} causal ({how(dk, dv)}; "
            + ("SERVE-WIDTHS)" if sq == s_ else "past launch latency)"),
            lambda q=q, k=k, v=v: flash_attention(q, k, v, causal=True),
            lambda q=q, k=k, v=v: attention_ref(q, k, v, causal=True),
            q, k, v, sq * (sq + 1) // 2, causal=True))
    pattern = SparseAttnConfig(block_size=16, local_blocks=2, sink_blocks=1, stride=4)
    idx, valid = sparse_block_table(s_ // 16, s_ // 16, pattern, 0)
    allowed = torch.zeros(s_, s_, dtype=torch.bool, device="cuda")
    for i in range(idx.shape[0]):
        for j in idx[i][valid[i]]:
            allowed[i * 16:(i + 1) * 16, j * 16:(j + 1) * 16] = True
    allowed &= torch.ones(s_, s_, dtype=torch.bool, device="cuda").tril()
    sc = 144
    for d in (18, 512):
        q, k, v = rn(b, s_, h, d), rn(b, s_, h, d), rn(b, s_, h, d)
        cases.append(attn_case(
            torch, "block_sparse_attn",
            f"B={b} S={s_} H={h} hd={d} block=16 ({how(d, d)}; SERVE-WIDTHS sparse)",
            lambda q=q, k=k, v=v: block_sparse_attention(q, k, v, pattern),
            lambda q=q, k=k, v=v: block_sparse_ref(q, k, v, pattern),
            q, k, v, int(allowed.sum()), mask=allowed))
        q1, kv = rn(b, 1, h, d), rn(2, b, sc, h, d)
        kc, vc = kv
        kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
        cases.append(dict(
            name="decode_attn", dtype="float32",
            label=f"B={b} Sc={sc} H={h} hd={d} cache_len={sc} ({how(d, d, True)}; SERVE-WIDTHS)",
            kernel=lambda q=q1, kc=kc, vc=vc: decode_attention(q, kc, vc, sc),
            plain=lambda q=q1, kc=kc, vc=vc: decode_ref(q, kc, vc, sc),
            library=lambda q=q1, kt=kt, vt=vt: F.scaled_dot_product_attention(
                q.transpose(1, 2), kt, vt),
            nbytes=(2 * b * h * d + 2 * b * sc * h * d) * 4, flops=4 * d * sc * b * h,
            split=split_plan(b, sc, h, head_dim=d), read=read_call(kv, [(0, sc)]),
            main=False))
    return cases


def zoo_cases(torch, rn):
    """f32 rows at the arch zoo's shapes: SERVE-LLAMA's LoRA projections
    (prefill M 8·512, K 2048, wq N 2048 and wv N 512; decode M 8), its GQA
    prefill attention (H 32 on K 8, G 4) and last decode step (cache 576),
    SERVE-ZOO's windowed prefill (gemma3's ``local`` layers, window 64),
    and ``ssd_chunk`` at jamba's reduced shapes.  The library calls are
    SDPA with ``enable_gqa`` (the window as a boolean mask) and
    ``torch.matmul`` of the merged weight; none computes the scan."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn.ops import decode_attention, split_plan
    from repro_torch.kernels.decode_attn.ref import decode_ref
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.flash_attn.ref import attention_ref
    from repro_torch.kernels.lora_fused.ops import lora_matmul
    from repro_torch.kernels.lora_fused.ref import lora_ref
    from repro_torch.models.attention import make_mask

    cases = []
    for m, k, n, path in ((4096, 2048, 2048, "llama prefill wq"),
                          (4096, 2048, 512, "llama prefill wv"),
                          (8, 2048, 2048, "llama decode wq")):
        x, w = rn(m, k), rn(k, n, std=0.02)
        a, b = rn(k, 8, std=0.02), rn(8, n, std=0.05)
        merged = w + 2.0 * (a @ b)
        cases.append(dict(
            name="lora_fused", label=f"M={m} K={k} N={n} r=8 ({path})", dtype="float32",
            kernel=lambda x=x, w=w, a=a, b=b: lora_matmul(x, w, a, b, scale=2.0),
            plain=lambda x=x, w=w, a=a, b=b: lora_ref(x, w, a, b, scale=2.0),
            library=lambda x=x, mg=merged: torch.matmul(x, mg),
            nbytes=(m * k + k * n + k * 8 + 8 * n + m * n) * 4,
            flops=2 * m * k * n + 2 * m * k * 8 + 2 * m * 8 * n, main=False,
            plan=("float32", n, k) if m <= 16 else None))
    for bsz, sq, h, kh, d, window, path in ((8, 512, 32, 8, 64, 0, "SERVE-LLAMA"),
                                            (2, 96, 4, 4, 64, 64, "SERVE-ZOO gemma3")):
        q, kk, vv = rn(bsz, sq, h, d), rn(bsz, sq, kh, d), rn(bsz, sq, kh, d)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kk, vv))
        mask = make_mask(sq, sq, causal=True, window=window, device=q.device)
        allowed = int(mask.sum())
        cases.append(dict(
            name="flash_attn", dtype="float32",
            label=f"B={bsz} S={sq} H={h} K={kh} hd={d} causal window={window} ({path})",
            kernel=lambda q=q, k=kk, v=vv, w=window: flash_attention(q, k, v, causal=True,
                                                                   window=w),
            plain=lambda q=q, k=kk, v=vv, w=window: attention_ref(q, k, v, causal=True,
                                                                window=w),
            library=lambda q=qt, k=kt, v=vt, m=mask, g=h != kh:
            F.scaled_dot_product_attention(q, k, v, attn_mask=m, enable_gqa=g),
            nbytes=(2 * bsz * sq * h * d + 2 * bsz * sq * kh * d) * 4,
            flops=4 * d * allowed * bsz * h, main=False))
    bsz, sc, h, kh, d = 8, 576, 32, 8, 64
    q, kv = rn(bsz, 1, h, d), rn(2, bsz, sc, kh, d)
    kc, vc = kv
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
    cases.append(dict(
        name="decode_attn", dtype="float32",
        label=f"B={bsz} Sc={sc} H={h} K={kh} hd={d} cache_len={sc} window=0 (SERVE-LLAMA)",
        kernel=lambda: decode_attention(q, kc, vc, sc),
        plain=lambda: decode_ref(q, kc, vc, sc),
        library=lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True),
        nbytes=(2 * bsz * h * d + 2 * bsz * sc * kh * d) * 4,
        flops=4 * d * sc * bsz * h, split=split_plan(bsz, sc, h),
        read=read_call(kv, read_ranges(sc, sc)), main=False))
    # ssd_chunk at jamba's shapes (d 256: 32 heads of 16, state 16, chunk
    # 32): ARCH-ROUND's step (B 4, S 16) and SERVE-ZOO's prefill (B 2, S 96)
    from repro_torch.kernels.ssd_chunk.ops import ssd_plan, ssd_scan
    from repro_torch.kernels.ssd_chunk.ref import ssd_ref
    for bsz, s, path in ((4, 16, "ARCH-ROUND"), (2, 96, "SERVE-ZOO jamba")):
        h, p, n, chunk = 32, 16, 16, 32
        x, dts = rn(bsz, s, h, p), torch.nn.functional.softplus(rn(bsz, s, h))
        bm, cm = (rn(bsz, s, 1, n, std=0.5).expand(bsz, s, h, n) for _ in range(2))
        a = -torch.exp(rn(h, std=0.3))
        per_head = scores = 0
        for c0 in range(0, s, chunk):
            lc = min(chunk, s - c0)
            per_head += lc * (lc + 1) // 2 * 2 * p + 2 * lc * n * p + (2 * lc * n * p if c0 else 0)
            scores += lc * (lc + 1) // 2 * 2 * n
        cases.append(dict(
            name="ssd_chunk", dtype="float32",
            label=f"B={bsz} S={s} H={h} P={p} N={n} chunk={chunk} ({path})",
            kernel=lambda x=x, d=dts, a=a, b=bm, c=cm: ssd_scan(x, d, a, b, c, chunk=32),
            plain=lambda x=x, d=dts, a=a, b=bm, c=cm: ssd_ref(x, d, a, b, c, chunk=32),
            library=None,
            nbytes=(2 * bsz * s * h * p + 2 * bsz * s * n + bsz * s * h + h
                    + bsz * h * p * n) * 4,
            flops=per_head * bsz * h + scores * bsz,
            ssd=f"fused={int(ssd_plan(bsz, s, h, p, n, chunk=chunk))} cb_groups=1 ",
            main=False))
    return cases


def sparse_cases(torch, dt, dname, es, rn):
    """block_sparse_attn at SERVE-SPARSE's prefill (plus GQA and q_offset
    cases) and decode_attn with the sparse mask at its decode shapes.  The
    library call is SDPA with the pattern as a boolean mask."""
    import torch.nn.functional as F

    from repro_torch.configs import SparseAttnConfig
    from repro_torch.kernels.block_sparse_attn.ops import block_sparse_attention
    from repro_torch.kernels.block_sparse_attn.ref import block_sparse_ref
    from repro_torch.kernels.decode_attn.ops import decode_attention, split_plan
    from repro_torch.kernels.decode_attn.ref import decode_ref
    from repro_torch.models.attention import sparse_block_table, sparse_position_mask

    cases = []
    serving = SparseAttnConfig(**SERVING_SPARSE)
    for bsz, sq, sk, h, kh, d, cfg, off in (
            (8, 896, 896, 12, 12, 64, serving, 0),
            (2, 512, 512, 8, 2, 64, SparseAttnConfig(block_size=64, local_blocks=2,
                                                     sink_blocks=1, stride=4), 0),
            (2, 256, 896, 12, 12, 64, serving, 640)):
        q, kk, vv = rn(bsz, sq, h, d, dtype=dt), rn(bsz, sk, kh, d, dtype=dt), rn(bsz, sk, kh, d, dtype=dt)
        bs = cfg.block_size
        idx, valid = sparse_block_table(sq // bs, sk // bs, cfg, off // bs)
        allowed = torch.zeros(sq, sk, dtype=torch.bool, device="cuda")
        for i in range(idx.shape[0]):
            for j in idx[i][valid[i]]:
                allowed[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = True
        qpos = off + torch.arange(sq, device="cuda")[:, None]
        allowed &= torch.arange(sk, device="cuda")[None] <= qpos
        pairs = int(allowed.sum())
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kk, vv))
        cases.append(dict(
            name="block_sparse_attn", dtype=dname,
            label=f"B={bsz} Sq={sq} Sk={sk} H={h} K={kh} hd={d} block={bs} q_offset={off}",
            kernel=lambda q=q, k=kk, v=vv, c=cfg, o=off: block_sparse_attention(q, k, v, c, q_offset=o),
            plain=lambda q=q, k=kk, v=vv, c=cfg, o=off: block_sparse_ref(q, k, v, c, q_offset=o),
            library=(None if h != kh else lambda q=qt, k=kt, v=vt, m=allowed:
                     F.scaled_dot_product_attention(q, k, v, attn_mask=m)),
            nbytes=(2 * bsz * sq * h * d + 2 * bsz * sk * kh * d) * es,
            flops=4 * d * pairs * bsz * h,
            main=(sq == 896 and dt == torch.float32)))
    for clen in (897, 960, 1024):
        bsz, sc, h, d = 8, 1024, 12, 64
        q, kv = rn(bsz, 1, h, d, dtype=dt), rn(2, bsz, sc, h, d, dtype=dt)
        kc, vc = kv
        pos = torch.arange(sc, device="cuda")
        mask = (pos < clen) & sparse_position_mask(pos, clen, serving)
        valid_n = int(mask.sum())
        qt, kt, vt = q.transpose(1, 2).contiguous(), kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
        cases.append(dict(
            name="decode_attn", dtype=dname,
            label=f"B={bsz} Sc={sc} H={h} hd={d} cache_len={clen} sparse",
            kernel=lambda q=q, k=kc, v=vc, c=clen: decode_attention(q, k, v, c, sparse=serving),
            plain=lambda q=q, k=kc, v=vc, c=clen: decode_ref(q, k, v, c, sparse=serving),
            library=lambda q=qt, k=kt, v=vt, m=mask[None]:
            F.scaled_dot_product_attention(q, k, v, attn_mask=m),
            nbytes=(2 * bsz * h * d + 2 * bsz * valid_n * h * d) * es,
            flops=4 * d * valid_n * bsz * h, main=False,
            split=split_plan(bsz, sc, h, sparse=serving),
            read=(read_call(kv, read_ranges(sc, clen, sparse=serving))
                  if dt == torch.float32 else None)))
    # a segment of a sequence-split cache (the tensor-parallel decode): slot
    # i holds position offset + i, the window and the sparse mask read
    # positions; a segment with the query's block and one before it
    for clen, off, sp in ((400, 256, None), (1024, 512, serving), (700, 512, serving)):
        bsz, sc, h, d = 8, 256, 12, 64
        q, kv = rn(bsz, 1, h, d, dtype=dt), rn(2, bsz, sc, h, d, dtype=dt)
        kc, vc = kv
        pos = off + torch.arange(sc, device="cuda")
        mask = pos < clen
        if sp is not None:
            mask &= sparse_position_mask(pos, clen, sp)
        valid_n = int(mask.sum())
        qt, kt, vt = q.transpose(1, 2).contiguous(), kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
        cases.append(dict(
            name="decode_attn", dtype=dname,
            label=f"B={bsz} Sc={sc} H={h} hd={d} cache_len={clen} offset={off}"
                  + (" sparse" if sp is not None else ""),
            kernel=lambda q=q, k=kc, v=vc, c=clen, o=off, p=sp: decode_attention(
                q, k, v, c, offset=o, sparse=p),
            plain=lambda q=q, k=kc, v=vc, c=clen, o=off, p=sp: decode_ref(
                q, k, v, c, offset=o, sparse=p),
            library=lambda q=qt, k=kt, v=vt, m=mask[None]:
            F.scaled_dot_product_attention(q, k, v, attn_mask=m),
            nbytes=(2 * bsz * h * d + 2 * bsz * valid_n * h * d) * es,
            flops=4 * d * valid_n * bsz * h, main=False,
            split=split_plan(bsz, sc, h, sparse=sp), read=None))
    return cases


def ssd_cases(torch, dt, dname, es, rn):
    """ssd_chunk at SERVE-MAMBA's prefill, with x, B and C strided views of
    one conv-output row as the mixer passes them (B/C a stride-0 broadcast
    of one group over the heads), plus a tail (S 300), an initial-state case
    and (f32) a prompt of 8 chunks.  The operations count the causal half of
    C·Bᵀ once per (batch, chunk) when B and C are shared over the heads, as
    the kernel forms it, else once per head, and the inter-chunk term only
    for chunks with a starting state (not chunk 0 without h0).  No single PyTorch call
    computes the scan."""
    from repro_torch.kernels.ssd_chunk.ops import SHAPES, cover, shared_cb, ssd_plan, ssd_scan
    from repro_torch.kernels.ssd_chunk.ref import ssd_ref

    cases = []
    # then (P, N) outside the compiled pairs, through the cover: head dims of
    # 128 (two (64, 128) launches) and a state of 256 (two, y summed)
    for bsz, s, h, p, n, chunk, with_h0 in ((4, 512, 64, 64, 128, 256, False),
                                            (4, 300, 64, 64, 128, 256, False),
                                            (4, 512, 64, 64, 128, 256, True),
                                            (1, 2048, 64, 64, 128, 256, False),
                                            (4, 512, 64, 128, 128, 256, False),
                                            (4, 512, 32, 64, 256, 256, False)):
        if dt == torch.bfloat16 and (s != 512 or with_h0 or (p, n) not in SHAPES):
            continue
        row = rn(bsz, s, h * p + 2 * n, dtype=dt)
        row[..., h * p:] *= 0.5
        x = row[..., :h * p].reshape(bsz, s, h, p)
        bm = row[..., h * p:h * p + n].reshape(bsz, s, 1, n).expand(bsz, s, h, n)
        cm = row[..., h * p + n:].reshape(bsz, s, 1, n).expand(bsz, s, h, n)
        dts = torch.nn.functional.softplus(rn(bsz, s, h))
        a = -torch.exp(rn(h, std=0.3))
        h0 = rn(bsz, h, p, n, std=0.5) if with_h0 else None
        per_head = scores = 0
        for c0 in range(0, s, chunk):   # causal S·x, the chunk state, C·h_startᵀ
            lc = min(chunk, s - c0)
            per_head += lc * (lc + 1) // 2 * 2 * p + 2 * lc * n * p
            if c0 > 0 or with_h0:   # chunk 0 without h0 starts from zero
                per_head += 2 * lc * n * p
            scores += lc * (lc + 1) // 2 * 2 * n
        groups = 1 if shared_cb(bm, cm) else h
        pi, ni, n_p, n_n = cover(p, n, chunk=chunk, heads=h, groups=groups)
        state = bsz * h * p * n * 4
        cases.append(dict(
            name="ssd_chunk", dtype=dname,
            label=f"B={bsz} S={s} H={h} P={p} N={n} chunk={chunk}" + (" h0" if with_h0 else ""),
            kernel=lambda x=x, d=dts, a=a, b=bm, c=cm, h0=h0, L=chunk:
            ssd_scan(x, d, a, b, c, chunk=L, h0=h0),
            plain=lambda x=x, d=dts, a=a, b=bm, c=cm, h0=h0, L=chunk:
            ssd_ref(x, d, a, b, c, chunk=L, h0=h0),
            library=None,
            nbytes=(2 * bsz * s * h * p + 2 * bsz * s * n) * es + bsz * s * h * 4 + h * 4
            + state * (2 if with_h0 else 1),
            flops=per_head * bsz * h + scores * bsz * groups,
            ssd=(f"fused={int(ssd_plan(bsz, s, h, p, n, chunk=chunk, groups=groups))} "
                 f"cb_groups={groups} "
                 + ("" if (p, n) in SHAPES else f"cover={pi}x{ni} blocks={n_p}x{n_n} ")),
            main=(s == 512 and not with_h0 and dt == torch.float32)))
    return cases


def check_kernels(torch):
    rows = {}
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")  # 128 MB > L2
    for c in kernel_cases(torch):
        outs, refs = c["kernel"](), c["plain"]()
        torch.cuda.synchronize()
        if torch.is_tensor(outs):
            outs, refs = (outs,), (refs,)
        atol, rtol = TOL[(c["name"], c["dtype"])]
        err = max((o.float() - r.float()).abs().max().item() for o, r in zip(outs, refs))
        ok = all(torch.allclose(o.float(), r.float(), atol=atol, rtol=rtol)
                 for o, r in zip(outs, refs))
        ms = device_ms(c["kernel"], flush)
        plain_ms = device_ms(c["plain"], flush)
        lib_ms = device_ms(c["library"], flush) if c["library"] else None
        b_ms, b_by = bound(c["nbytes"], c["flops"], c["dtype"])
        lib_txt = f"{lib_ms:.4f}" if lib_ms is not None else "none"
        if c.get("plan"):
            plan = "strip={} split={} ".format(*skinny_plan(*c["plan"]))
        elif c.get("split"):
            plan = f"split={c['split']} "
        elif c.get("ssd"):
            plan = c["ssd"]
        else:
            plan = ""
        read_ms = device_ms(c["read"], flush) if c.get("read") else None
        read_txt = f"read_ms={read_ms:.4f} " if read_ms is not None else ""
        print(f"CHECK {c['name']:<11} {c['dtype']:<8} {c['label']:<48} {plan}"
              f"max_abs_err={err:.3e} tol={atol:g}/{rtol:g} {'ok' if ok else 'MISMATCH'} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_txt} {read_txt}"
              f"bound_ms={b_ms:.4f} ({b_by}) tflops={c['flops'] / ms / 1e9:.2f} "
              f"bound_share={b_ms / ms:.3f}", flush=True)
        if not ok:
            fail(f"{c['name']} {c['dtype']} {c['label']}: max_abs_err {err:.3e} "
                 f"outside atol {atol:g} rtol {rtol:g}")
        if (c["main"] or c.get("profile")) and c["library"]:
            # the library call's own kernels, by name (what the yardstick runs)
            profile(torch, f"{c['name']} library ({c['label']})", c["library"], 3)
        if c["main"] and c.get("ssd"):
            # the scan's four launches, by name
            profile(torch, f"{c['name']} kernel ({c['label']})", c["kernel"], 3)
        if c["main"]:
            rows[c["name"]] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                   bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                                   shape=c["label"], dtype=c["dtype"])
            if read_ms is not None:
                rows[c["name"]]["read_ms"] = read_ms
    return rows


# ---------------------------------------------------------------- gradients
def grad_cases(torch):
    """(name, label, kernel call, plain call, inputs) of each autograd
    Function at the training paths' shapes; the call takes the inputs."""
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.flash_attn.ref import attention_ref
    from repro_torch.kernels.lora_fused.ops import lora_matmul
    from repro_torch.kernels.lora_fused.ref import lora_ref
    from repro_torch.kernels.ssd_chunk.ops import ssd_scan
    from repro_torch.kernels.ssd_chunk.ref import ssd_ref

    g = torch.Generator(device="cuda").manual_seed(2)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    cases = []
    for m, k, r in ((2048, 768, 8), (512, 128, 8), (2048, 768, 64)):
        cases.append(dict(
            name="lora_fused", label=f"M={m} K={k} N={k} r={r}",
            kernel=lambda *t: lora_matmul(*t, scale=2.0),
            plain=lambda *t: lora_ref(*t, scale=2.0),
            inputs=(rn(m, k), rn(k, k, std=0.05), rn(k, r, std=0.05), rn(r, k, std=0.05)),
            frozen=(1,), names=("x", "w", "a", "b")))
    for b, s, h, d, causal in ((16, 128, 12, 64, False), (8, 32, 4, 32, False),
                               (16, 39, 4, 32, True), (8, 191, 12, 64, True)):
        cases.append(dict(
            name="flash_attn",
            label=f"B={b} S={s} H={h} hd={d} {'causal' if causal else 'non-causal'}",
            kernel=lambda *t, c=causal: flash_attention(*t, causal=c),
            plain=lambda *t, c=causal: attention_ref(*t, causal=c),
            inputs=tuple(rn(b, s, h, d) for _ in range(3)), frozen=(),
            names=("q", "k", "v")))
    # SSDScan at ARCH-ROUND's jamba/mamba2 shape (--fl-dmodel 256: batch 4,
    # S 16, 32 heads of 16, state 16, chunk 32); B and C one group broadcast
    # over the heads as the mixer passes them; y and h_final in one output
    b, s, h, p, n = 4, 16, 32, 16, 16

    def scan(fn):
        def call(x, dt, a, bm, cm):
            y, hf = fn(x, torch.nn.functional.softplus(dt), a, bm.expand(b, s, h, n),
                       cm.expand(b, s, h, n), chunk=32)
            return torch.cat([y.reshape(-1), hf.reshape(-1)])
        return call

    cases.append(dict(
        name="ssd_chunk", label=f"SSDScan B={b} S={s} H={h} P={p} N={n}",
        kernel=scan(ssd_scan), plain=scan(ssd_ref),
        inputs=(rn(b, s, h, p), rn(b, s, h), -torch.exp(rn(h, std=0.3)),
                rn(b, s, 1, n, std=0.5), rn(b, s, 1, n, std=0.5)),
        frozen=(), names=("x", "dt", "a", "B", "C")))
    # FlashAttention at ARCH-ROUND's deepseek-v2 at d 256 (q/k 80, v 64:
    # the (96, 64) tile, zero-filled in the kernel) and at the launcher's
    # default d 64 (heads of 16, MLA's (32, 16): the 32 tile)
    for dk, dv, what in ((80, 64, "MLA d 256"), (16, 16, "d 64"), (32, 16, "MLA d 64")):
        cases.append(dict(
            name="flash_attn", label=f"B=4 S=16 H=4 dk={dk} dv={dv} causal ({what})",
            kernel=lambda *t: flash_attention(*t, causal=True),
            plain=lambda *t: attention_ref(*t, causal=True),
            inputs=(rn(4, 16, 4, dk), rn(4, 16, 4, dk), rn(4, 16, 4, dv)), frozen=(),
            names=("q", "k", "v")))
    return cases


def check_grads(torch):
    """Each Function on the card against autograd of its plain version on
    the card: the max abs error of every input gradient at the kernel's f32
    tolerance, and the forward and backward device times of both (the
    backward with the inputs that training differentiates: W frozen)."""
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    rows = []
    for c in grad_cases(torch):
        atol, rtol = TOL[(c["name"], "float32")]
        cot = None
        res = {}
        for which in ("kernel", "plain"):
            ins = [t.clone().requires_grad_() for t in c["inputs"]]
            out = c[which](*ins)
            if cot is None:
                cot = torch.randn(out.shape, generator=torch.Generator(device="cuda")
                                  .manual_seed(3), device="cuda")
            res[which] = (out.detach(), torch.autograd.grad(out, ins, cot))
        errs = {n: (gk - gp).abs().max().item()
                for n, gk, gp in zip(c["names"], res["kernel"][1], res["plain"][1])}
        ok = all(torch.allclose(gk, gp, atol=atol, rtol=rtol)
                 for gk, gp in zip(res["kernel"][1], res["plain"][1]))
        times = {}
        for which in ("kernel", "plain"):
            ins = [t.clone().requires_grad_(i not in c["frozen"])
                   for i, t in enumerate(c["inputs"])]
            train_ins = [t for t in ins if t.requires_grad]
            times[f"{which}_fwd_ms"] = device_ms(lambda w=which: c[w](*ins), flush)
            out = c[which](*ins)
            times[f"{which}_bwd_ms"] = device_ms(
                lambda o=out: torch.autograd.grad(o, train_ins, cot, retain_graph=True),
                flush)
        print(f"GRAD {c['name']:<10} {c['label']:<30} "
              + " ".join(f"d{n}_err={e:.3e}" for n, e in errs.items())
              + f" tol={atol:g}/{rtol:g} {'ok' if ok else 'MISMATCH'} "
              + " ".join(f"{k}={v:.4f}" for k, v in times.items()), flush=True)
        if not ok:
            fail(f"GRAD {c['name']} {c['label']}: gradient errors {errs} outside "
                 f"atol {atol:g} rtol {rtol:g}")
        rows.append(dict(name=c["name"], shape=c["label"], grad_err=errs, **times))
    return rows


# ---------------------------------------------------------------- serving
def wrappers():
    from repro_torch.kernels.block_sparse_attn.ops import block_sparse_attention
    from repro_torch.kernels.decode_attn.ops import decode_attention
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.lora_fused.ops import lora_matmul
    from repro_torch.kernels.ssd_chunk.ops import ssd_scan
    return dict(zip(KERNELS, (lora_matmul, flash_attention, decode_attention,
                              block_sparse_attention, ssd_scan)))


def mla_cut():
    """SERVE-MLA's model: deepseek-v2-236b at its published widths (d 5120,
    128 heads, q_lora 1536, kv_lora 512, rope 64, nope 128, v 128, vocab
    102400, dense FF 12288, experts of 1536, 2 shared, top-6), cut in depth
    to the prologue layer and one MoE layer and to 16 routed experts of 160
    (1.96 B parameters)."""
    from repro_torch.configs import LK, Stage, get_config
    cfg = get_config("deepseek-v2-236b")
    return dataclasses.replace(
        cfg, stages=(Stage((LK("mla", "mlp"),), 1), Stage((LK("mla", "moe"),), 1)),
        moe=dataclasses.replace(cfg.moe, n_experts=16))


def gemma3_cut():
    """SERVE-GEMMA3's model: gemma3-12b at its published widths (d 3840,
    16 query heads on 8 KV heads of 240, GeGLU d_ff 15360, tied vocab
    262144, window 1024, the global layer's block-sparse pattern), cut in
    depth to one repeat of its pattern, 5 ``local`` layers and 1 global
    (2.33 B parameters, 1.01 B of them the embedding)."""
    from repro_torch.configs import Stage, get_config
    cfg = get_config("gemma3-12b")
    return dataclasses.replace(
        cfg, stages=tuple(Stage(st.pattern, 1, st.stream) for st in cfg.stages))


CUTS = {"mla": mla_cut, "gemma3": gemma3_cut}


def mixer_counts(cfg):
    """Layers of each mixer kind, over the repeats."""
    out = {}
    for st in cfg.stages:
        for k in st.pattern:
            out[k.mixer] = out.get(k.mixer, 0) + st.repeats
    return out


def expected_launches(model, lora, impl, gen):
    """Each kernel's launches on one prefill plus ``gen`` decode steps.
    Prefill: ``flash_attn`` once an ``attn``, ``local``, ``enc`` or ``mla``
    layer and twice a ``dec`` layer (self and cross), where under the
    sparse impl ``attn``, ``dec`` self and ``mla`` run ``block_sparse_attn``
    (a ``local`` layer keeps its window); ``ssd_chunk`` once a mamba layer;
    ``lora_fused`` once a factor leaf a repeat, but not on an MoE layer's
    experts (merged into the slabs).  Each decode step: ``decode_attn`` once
    an ``attn`` or ``local`` layer and twice a ``dec`` layer; ``lora_fused``
    for the decoder stream's factor leaves, but not for MLA's ``wkv_b``
    (merged into the latent weight, ``peft.effective_weight``); MLA's
    absorbed attention and MoE launch none of the five."""
    from repro_torch import trees
    cfg = model.cfg
    n = mixer_counts(cfg)
    sparse = impl == "sparse" and cfg.sparse_attn is not None
    pre_lora = step_lora = 0
    for p, v in trees.flatten(lora).items():
        if p.endswith("/a"):
            si, pi = (int(t) for t in p.split("/")[1:4:2])
            stage = cfg.stages[si]
            if "/ff/" in p and stage.pattern[pi].ff == "moe":
                continue
            pre_lora += v.shape[0]
            if stage.stream == "decoder" and not p.endswith("/wkv_b/a"):
                step_lora += v.shape[0]
    dense = [n.get(m, 0) for m in ("attn", "dec", "mla")]
    return {"lora_fused": pre_lora + step_lora * gen,
            "flash_attn": (n.get("local", 0) + n.get("enc", 0) + n.get("dec", 0)
                           + (0 if sparse else sum(dense))),
            "decode_attn": (n.get("attn", 0) + n.get("local", 0) + 2 * n.get("dec", 0)) * gen,
            "block_sparse_attn": sum(dense) if sparse else 0,
            "ssd_chunk": n.get("mamba", 0)}


SERVED = {}   # a path's build, kept for the later paths that serve its weights
ENGINE_RUNS = {}   # the training phases' engine results TRAIN-ORACLES holds its oracles to


def seeded_lora(torch, np, params, rank):
    """Rank-``rank`` factors on the default targets (``init_lora``'s shapes
    and masks) with A and B drawn from numpy seed 1, std 0.05: init_lora
    zeros B, and the rank-r path should do real work; → (lora, scale)."""
    from repro_torch import trees
    from repro_torch.models import peft
    pc = peft.PEFTConfig(lora_rank=rank)
    rng = np.random.RandomState(1)
    lora = trees.map_with_path(
        lambda p, v: v if p.endswith("/mask") else torch.from_numpy(
            (rng.randn(*v.shape) * 0.05).astype(np.float32)).to(v.device),
        peft.init_lora(torch.Generator().manual_seed(0), params, pc))
    return lora, peft.lora_scale(pc)


def serve_path(torch, np, spec):
    """One serving path through ``serve.build``/``generate`` (at full width,
    or at ``spec["reduced"]``'s reduced config): launch counts against the
    path's, then a teacher-forced CPU re-run of ``spec["rows"]`` rows
    through the plain versions."""
    from repro_torch import trees
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model

    tag, t_start = spec["tag"], time.perf_counter()
    args = serve.parse_args(["--arch", spec["arch"], "--batch", str(spec["batch"]),
                             "--prompt-len", str(spec["prompt_len"]),
                             "--gen", str(spec["gen"]),
                             "--lora-rank", str(spec["rank"])])
    cfg = (get_config(spec["arch"]).reduced(**spec["reduced"]) if spec.get("reduced")
           else CUTS[spec["cut"]]() if spec.get("cut") else None)
    src = spec.get("weights_of")
    if src:
        model, params, prompts, patches, frames = SERVED[src]
        if not any(s.get("weights_of") == src for s in SERVES[SERVES.index(spec) + 1:]):
            del SERVED[src]   # its last consumer
        model = Model(model.cfg, device=model.device, impl=spec["impl"])
    else:
        model, params, _, _, prompts, patches, frames = serve.build(
            args, impl=spec["impl"], cfg=cfg)
    lora, lscale = seeded_lora(torch, np, params, spec["rank"])
    if any(s.get("weights_of") == tag for s in SERVES):
        SERVED[tag] = (model, params, prompts, patches, frames)
    n_cache = serve.cache_len(model, prompts, args.gen)
    t_built = time.perf_counter()

    serve.generate(model, params, prompts, 2, lora=lora, lora_scale=lscale,
                   patches=patches, frames=frames)  # warm-up
    kernels = wrappers()
    for f in kernels.values():
        f.launches = 0
    res = serve.generate(model, params, prompts, args.gen, lora=lora, lora_scale=lscale,
                         patches=patches, frames=frames)
    launches = {n: f.launches for n, f in kernels.items()}
    expected = expected_launches(model, lora, spec["impl"], args.gen)
    tok_s = args.batch * args.gen / res["decode_s"]
    # prefill again, PREFILL_REPS times: its median moves less with the host
    # than the single prefill of the run
    reps = []
    for _ in range(PREFILL_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = model.prefill(params, prompts, n_cache, patches=patches, frames=frames,
                                 lora=lora, lora_scale=lscale)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) * 1e3)
    res["prefill_median_ms"] = sorted(reps)[PREFILL_REPS // 2]
    if spec.get("cut") == "mla":
        res["absorbed_ms"] = mla_absorbed_ms(torch, model, params, lora, lscale, cache,
                                             n_cache)
        print(f"{tag} absorbed MLA decode (plain torch: effective_weight + "
              f"absorbed_attention, {mixer_counts(model.cfg)['mla']} layers, cache_len "
              f"{n_cache}) device_ms={res['absorbed_ms']:.4f}", flush=True)
    del cache
    width = (f"reduced d_model {model.cfg.d_model}" if spec.get("reduced")
             else f"published widths, cut ({spec['cut']}_cut)" if spec.get("cut")
             else "full width")
    print(f"{tag} {spec['arch']} {width} ({model.cfg.n_layers} layers, d_model "
          f"{model.cfg.d_model}, heads {model.cfg.n_heads} on {model.cfg.n_kv_heads} of "
          f"{model.cfg.hd}, impl "
          f"{spec['impl']}): batch {args.batch} prompt {args.prompt_len} "
          f"gen {args.gen} rank {args.lora_rank} f32  prefill_ms={res['prefill_s'] * 1e3:.3f} "
          f"prefill_median_ms={res['prefill_median_ms']:.3f} "
          f"decode_s={res['decode_s']:.4f} decode_tok_s={tok_s:.1f} "
          f"ms_per_decode_step={res['decode_s'] / args.gen * 1e3:.3f}", flush=True)
    print(f"{tag} launches {launches} expected {expected}", flush=True)
    if launches != expected:
        fail(f"{tag}: kernel launches {launches} != expected {expected}")
    toks = res["tokens"]
    if toks.shape != (args.batch, args.gen) or not bool(
            ((toks >= 0) & (toks < model.cfg.vocab_size)).all()):
        fail(f"{tag}: bad tokens {tuple(toks.shape)}")
    if not all(bool(torch.isfinite(lg).all()) for lg in res["logits"]):
        fail(f"{tag}: non-finite logits")
    t_card = time.perf_counter()

    # teacher-forced CPU re-run of the first rows through the plain versions
    rows = spec["rows"]
    cpu = Model(model.cfg, device="cpu", impl=spec["impl"])
    p_cpu = trees.map_with_path(lambda _, v: v.cpu(), params)
    l_cpu = trees.map_with_path(lambda _, v: v.cpu(), lora)
    card_logits = [lg[:rows].cpu() for lg in res["logits"][:TEACHER_STEPS + 1]]
    lg, cache = cpu.prefill(p_cpu, prompts[:rows].cpu(), n_cache,
                            patches=None if patches is None else patches[:rows].cpu(),
                            frames=None if frames is None else frames[:rows].cpu(),
                            lora=l_cpu, lora_scale=lscale)
    errs = [(lg - card_logits[0]).abs().max().item()]
    for t in range(TEACHER_STEPS):
        lg, cache = cpu.decode_step(p_cpu, cache, toks[:rows, t:t + 1].cpu(),
                                    lora=l_cpu, lora_scale=lscale)
        errs.append((lg - card_logits[t + 1]).abs().max().item())
    scale = max(1.0, max(lg.abs().max().item() for lg in card_logits))
    tol = spec["logit_tol"] * scale
    t_end = time.perf_counter()
    print(f"{tag} teacher-forced CPU logits ({rows} of {args.batch} rows) max_abs_err per step "
          f"{[f'{e:.2e}' for e in errs]} (tol {tol:.3g} = {spec['logit_tol']:g} x "
          f"max(1, max|logit| {scale:.3g}))", flush=True)
    print(f"{tag} seconds: build {t_built - t_start:.1f} card {t_card - t_built:.1f} "
          f"cpu {t_end - t_card:.1f}", flush=True)
    if max(errs) > tol:
        fail(f"{tag}: card vs CPU logits differ by {max(errs):.3e} > {tol:.3g}")
    return launches, res, tok_s, (model, params, lora, lscale, prompts, patches, frames)


SPARSE_KV_SEQ = 1024
SPARSE_KV_LAYERS = 4     # SERVE-SPARSE-KV's depth, cut from 12 for the script's time
SPARSE_KV_CHECK = tuple(range(0, SPARSE_KV_SEQ, 64)) + tuple(range(640, 649)) + (
    SPARSE_KV_SEQ - 1,)   # steps whose logits the CPU re-run checks


def sparse_kv_cut():
    """SERVE-SPARSE-KV's model: gpt2-small at full width (d 768, 12 heads of
    64, vocab 50257), cut in depth to SPARSE_KV_LAYERS of its 12 layers
    (every layer is the same ``attn`` layer)."""
    from repro_torch.configs import Stage, get_config
    cfg = get_config("gpt2-small")
    return dataclasses.replace(cfg, stages=tuple(
        Stage(st.pattern, SPARSE_KV_LAYERS, st.stream) for st in cfg.stages))


def serve_sparse_kv(torch, np):
    """SERVE-SPARSE-KV: gpt2-small at full width (``sparse_kv_cut``: 4 of
    its 12 layers, for the script's time) with ``impl="sparse"`` and
    ``opts={"sparse_kv_seq": 1024}`` (its ``attn`` layers hold the sparse-KV
    layout: a persistent region of the sink and strided blocks, 128 slots,
    and a ring of 5 blocks, 640 slots), batch 8, rank-8 LoRA (numpy seed 1),
    decoded from ``init_cache`` over 1024 teacher-forced random tokens —
    the JAX package decodes a sparse-KV cache only that way.  Each step
    reads up to three slot ranges a layer through ``decode_attn`` with its
    LSE (``sparse_kv_ranges``), merged exactly; the persistent region is in
    use from position 640.  Launch counts against the ranges', decode tok/s,
    then the first row re-run on the CPU (the plain ``sparse_kv_decode``),
    logits held at SPARSE_KV_CHECK's steps; prefill of the first 896 tokens
    (plain caches, as the JAX package's prefill) timed beside it."""
    from repro_torch import trees
    from repro_torch.launch import serve
    from repro_torch.models.attention import sparse_kv_ranges
    from repro_torch.models.transformer import Model

    tag, t_start, seq = "SERVE-SPARSE-KV", time.perf_counter(), SPARSE_KV_SEQ
    args = serve.parse_args(["--arch", "gpt2-small", "--batch", "8", "--prompt-len", str(seq),
                             "--gen", "0", "--lora-rank", "8"])
    opts = {"sparse_kv_seq": seq}
    model, params, _, _, toks, _, _ = serve.build(args, impl="sparse", opts=opts,
                                                  cfg=sparse_kv_cut())
    lora, lscale = seeded_lora(torch, np, params, 8)
    cfg, b = model.cfg, args.batch

    def run(steps, keep=()):
        cache, kept = model.init_cache(b, seq), {}
        for t in range(steps):
            lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], lora=lora,
                                          lora_scale=lscale)
            if t in keep:
                kept[t] = lg[:1].clone()
        return cache, kept

    run(4)                                                         # warm-up
    kernels = wrappers()
    for f in kernels.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, kept = run(seq, SPARSE_KV_CHECK)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = {n: f.launches for n, f in kernels.items()}
    n_attn, ranges = mixer_counts(cfg)["attn"], [len(sparse_kv_ranges(t, cfg.sparse_attn, seq))
                                                 for t in range(seq)]
    expected = {"lora_fused": 2 * n_attn * seq, "flash_attn": 0,
                "decode_attn": n_attn * sum(ranges),
                "block_sparse_attn": 0, "ssd_chunk": 0}
    reps = []
    for _ in range(1 + PREFILL_REPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.prefill(params, toks[:, :896], seq, lora=lora, lora_scale=lscale)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t1) * 1e3)
    tok_s = b * seq / decode_s
    res = {"prefill_s": reps[0] / 1e3, "prefill_median_ms": sorted(reps[1:])[PREFILL_REPS // 2],
           "decode_s": decode_s}
    print(f"{tag} gpt2-small full width ({cfg.n_layers} of 12 layers, impl sparse, "
          f"sparse_kv_seq {seq}: "
          f"{cache['stages'][0][0]['k_pers'].shape[2]} persistent + "
          f"{cache['stages'][0][0]['k_ring'].shape[2]} ring slots a layer): batch {b}, "
          f"{seq} teacher-forced steps from init_cache, rank 8 f32  "
          f"prefill_ms={reps[0]:.3f} (896 tokens, plain cache) "
          f"prefill_median_ms={res['prefill_median_ms']:.3f} decode_s={decode_s:.4f} "
          f"decode_tok_s={tok_s:.1f} ms_per_decode_step={decode_s / seq * 1e3:.3f} "
          f"ranges a layer: {ranges.count(1)} steps 1, {ranges.count(2)} steps 2, "
          f"{ranges.count(3)} steps 3", flush=True)
    print(f"{tag} launches {launches} expected {expected}", flush=True)
    if launches != expected:
        fail(f"{tag}: kernel launches {launches} != expected {expected}")
    if not all(bool(torch.isfinite(lg).all()) for lg in kept.values()):
        fail(f"{tag}: non-finite logits")
    t_card = time.perf_counter()
    cpu = Model(cfg, device="cpu", impl="sparse", opts=opts)
    p_cpu = trees.map_with_path(lambda _, v: v.cpu(), params)
    l_cpu = trees.map_with_path(lambda _, v: v.cpu(), lora)
    c_cpu, errs = cpu.init_cache(1, seq), []
    scale = max(1.0, max(lg.abs().max().item() for lg in kept.values()))
    for t in range(seq):
        lg, c_cpu = cpu.decode_step(p_cpu, c_cpu, toks[:1, t:t + 1].cpu(), lora=l_cpu,
                                    lora_scale=lscale)
        if t in kept:
            errs.append((lg - kept[t].cpu()).abs().max().item())
    tol = 1e-3 * scale
    print(f"{tag} teacher-forced CPU logits (1 of {b} rows, {len(errs)} checked steps) "
          f"max_abs_err {max(errs):.2e} (tol {tol:.3g}); seconds build "
          f"{t_card - t_start - decode_s:.1f} card {decode_s:.1f} cpu "
          f"{time.perf_counter() - t_card:.1f}", flush=True)
    if max(errs) > tol:
        fail(f"{tag}: card vs CPU logits differ by {max(errs):.3e} > {tol:.3g}")

    def steps16():                       # 16 late steps (all three ranges), profiled
        c = cache
        c["pos"] = seq - 16
        for t in range(seq - 16, seq):
            model.decode_step(params, c, toks[:, t:t + 1], lora=lora, lora_scale=lscale)

    prof = profile(torch, f"{tag} decode (16 steps at positions 1008-1023)", steps16, 1)
    return launches, res, tok_s, prof


def mla_absorbed_ms(torch, model, params, lora, lscale, cache, cache_len):
    """Device ms (cold L2, median of 30) of the absorbed MLA decode's plain
    torch — ``effective_weight`` of ``wkv_b`` and ``absorbed_attention`` —
    summed over the model's MLA layers, at ``cache_len`` slots of ``cache``
    and random q of the step's shape."""
    from repro_torch.models import mla, peft
    cfg, m = model.cfg, model.cfg.mla
    b, h = cache["stages"][0][0]["ckv"].shape[1], cfg.n_heads
    g = torch.Generator(device="cuda").manual_seed(4)
    calls = []
    for si, stage in enumerate(cfg.stages):
        for pi, kind in enumerate(stage.pattern):
            for r in range(stage.repeats):
                w = params["stages"][si]["layers"][pi]["mixer"]["wkv_b"][r]
                lf = lora["stages"][si]["layers"][pi]["mixer"].get("wkv_b")
                lf = None if lf is None else {k: t[r] for k, t in lf.items()}
                ent = cache["stages"][si][pi]
                qn = torch.randn(b, h, m.nope_head_dim, generator=g, device="cuda")
                qp = torch.randn(b, h, m.rope_head_dim, generator=g, device="cuda")
                calls.append(lambda w=w, lf=lf, c=ent["ckv"][r], k=ent["kpe"][r], qn=qn, qp=qp:
                             mla.absorbed_attention(
                                 qn, qp, peft.effective_weight(w, lf, lscale).reshape(
                                     m.kv_lora_rank, h, m.nope_head_dim + m.v_head_dim).float(),
                                 c, k, cache_len, m))
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    return device_ms(lambda: [c() for c in calls], flush)


# ---------------------------------------------------------------- training
def pftt_expected(cfg, method, trained=None):
    """Each kernel's launches in one ``run_pftt``: every forward of the
    reduced encoder (2 layers) runs ``flash_attn`` once a layer and, with
    LoRA, ``lora_fused`` on wq and wv — MLM pretraining steps, local steps
    and one evaluation forward per client and round.  ``trained``: the
    client-rounds that train (the robust round runs only the fault trace's
    ``train`` clients; default every client every round)."""
    layers = 2
    evals = cfg.rounds * cfg.n_clients
    local = (evals if trained is None else trained) * cfg.local_steps
    lora = method in ("pftt", "vanilla_fl", "fedlora")
    return {"lora_fused": 2 * layers * (local + evals) if lora else 0,
            "flash_attn": layers * (cfg.pretrain_steps + local + evals),
            "decode_attn": 0, "block_sparse_attn": 0, "ssd_chunk": 0}


def train_pftt(torch):
    """TRAIN-PFTT: ``run_pftt`` for the four methods of Fig. 5 at the
    launcher's settings (``--fl-clients 4 --fl-rounds 3``: 50 pretraining
    steps, 5 local steps, batch 8, 200 samples per client, seed 0, f32) on
    the card, launch counts checked, then the same runs on the CPU through
    the plain versions, from the same init (drawn on the CPU).  Per-round
    bytes and delays must be equal.  Mean local losses within PFTT_LOSS_TOL
    × max(1, |loss|) (4.8e-7 at most on an H100 80GB HBM3: the card and
    the CPU sum in other orders).  Accuracies within PFTT_ACC_TOL: they are
    counts, and AdamW turns a rounding-level gradient into a move of up to
    lr (see TRAIN-ROBERTA's note), so a prediction near its margin may flip; one
    flip moves a round's mean accuracy by 1/(4·n) ≤ 0.025 for a client with
    n ≥ 10 test samples, and the bound lets two through (0 on an H100 80GB
    HBM3)."""
    from repro_torch.core.pftt import run_pftt
    from repro_torch.launch import train

    args = train.parse_args(["--arch", "roberta-base", "--fl-clients", "4",
                             "--fl-rounds", "3"])
    kernels = wrappers()
    total = {n: 0 for n in KERNELS}
    out = {}
    for method in ("pftt", "vanilla_fl", "fedbert", "fedlora"):
        cfg = train.pftt_config(args, method=method, verbose=False)
        for f in kernels.values():
            f.launches = 0
        card = run_pftt(cfg)
        launches = {n: f.launches for n, f in kernels.items()}
        ENGINE_RUNS["pftt", method] = dict(card, launches=launches)
        expected = pftt_expected(cfg, method)
        t0 = time.perf_counter()
        cpu = run_pftt(dataclasses.replace(cfg, device="cpu"))
        cpu_s = time.perf_counter() - t0
        print(f"TRAIN-PFTT {method:<10} pretrain_s={card['pretrain_s']:.3f} "
              f"s_per_round={sum(card['round_s']) / len(card['round_s']):.4f} "
              f"round_s={[round(x, 4) for x in card['round_s']]} "
              f"acc_per_round={[round(a, 4) for a in card['acc_per_round']]} "
              f"mean_round_bytes={card['mean_round_bytes']:.1f} "
              f"mean_round_delay_s={card['mean_round_delay_s']:.6f} "
              f"loss_per_round={[round(x, 5) for x in card['loss_per_round']]}", flush=True)
        print(f"TRAIN-PFTT {method:<10} launches {launches} expected {expected}", flush=True)
        if launches != expected:
            fail(f"TRAIN-PFTT {method}: kernel launches {launches} != expected {expected}")
        acc_err = max(abs(a - b) for a, b in zip(card["acc_per_round"], cpu["acc_per_round"]))
        loss_err = max(abs(a - b) / max(1.0, abs(b))
                       for a, b in zip(card["loss_per_round"], cpu["loss_per_round"]))
        same_ledger = ([(r["bytes"], r["delay_s"]) for r in card["round_records"]]
                       == [(r["bytes"], r["delay_s"]) for r in cpu["round_records"]])
        print(f"TRAIN-PFTT {method:<10} CPU (plain versions, {cpu_s:.1f} s): "
              f"acc_per_round={[round(a, 4) for a in cpu['acc_per_round']]} "
              f"acc_max_abs_err={acc_err:.4f} (tol {PFTT_ACC_TOL}) "
              f"loss_max_rel_err={loss_err:.2e} (tol {PFTT_LOSS_TOL:g}) "
              f"bytes_and_delays_equal={same_ledger}", flush=True)
        if not same_ledger or acc_err > PFTT_ACC_TOL or loss_err > PFTT_LOSS_TOL:
            fail(f"TRAIN-PFTT {method}: card and CPU differ (ledger equal {same_ledger}, "
                 f"acc {acc_err:.4f}, loss {loss_err:.2e})")
        for n in KERNELS:
            total[n] += launches[n]
        out[method] = {k: card[k] for k in ("acc_per_round", "mean_round_bytes",
                                            "mean_round_delay_s", "pretrain_s",
                                            "round_s", "loss_per_round")}
        out[method]["launches"] = launches
    # the device's busy share over one whole run (pretraining and a round:
    # cut from 3 rounds for the script's time; parsing the trace took 10.6 s)
    profile(torch, "TRAIN-PFTT pftt run_pftt (1 round)",
            lambda: run_pftt(dataclasses.replace(train.pftt_config(args, verbose=False),
                                                  rounds=1)), 1)
    return total, out


def train_roberta(torch, np):
    """TRAIN-ROBERTA: roberta-base at full width and depth through
    ``launch/train.py``'s ``Trainer`` (``make_peft_step``: adapters + rank-8
    LoRA on wq/wv, MLM loss over 15 % masked positions, batch 16, sequence
    128, AdamW at the launcher's lr), 10 steps on the card; the first 2
    re-run on the CPU through the plain versions from the same init and
    batches, with each step's gradients."""
    from repro_torch import trees
    from repro_torch.launch import train
    from repro_torch.optim import value_and_grad

    argv = ["--arch", "roberta-base", "--steps", str(ROBERTA_STEPS), "--batch", "16",
            "--seq", "128", "--lora-rank", "8"]
    t0 = time.perf_counter()
    tr = train.Trainer(train.parse_args(argv))
    rng = np.random.RandomState(0)
    batches = [tr.batch(rng) for _ in range(ROBERTA_STEPS)]
    t_built = time.perf_counter()
    kernels = wrappers()
    card_g, losses, step_ms, per_step, after = [], [], [], [], None
    for i, b in enumerate(batches):
        bt = tr.to_device(b)
        if i < CPU_STEPS:   # this step's gradients, for the CPU comparison
            card_g.append({p: g.cpu() for p, g in trees.flatten(value_and_grad(
                lambda t: tr.loss(t, bt), tr.trainable)[1]).items()})
        before = {n: f.launches for n, f in kernels.items()}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = tr.step(bt)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss))
        per_step.append({n: f.launches - before[n] for n, f in kernels.items()})
        if i == CPU_STEPS - 1:
            after = {p: v.detach().cpu() for p, v in trees.flatten(tr.trainable).items()}
    launches = {n: sum(p[n] for p in per_step) for n in KERNELS}
    layers = tr.cfg.n_layers
    expected_step = {"lora_fused": 2 * layers, "flash_attn": layers, "decode_attn": 0,
                     "block_sparse_attn": 0, "ssd_chunk": 0}
    print(f"TRAIN-ROBERTA roberta-base full width ({layers} layers, d {tr.cfg.d_model}, "
          f"vocab {tr.cfg.vocab_size}) batch 16 seq 128 rank 8 f32: "
          f"median_step_ms={sorted(step_ms)[len(step_ms) // 2]:.3f} "
          f"step_ms={[round(x, 2) for x in step_ms]} "
          f"loss={[round(x, 5) for x in losses]}", flush=True)
    print(f"TRAIN-ROBERTA launches per step {per_step[0]} expected {expected_step} "
          f"(all {len(per_step)} steps equal: {all(p == expected_step for p in per_step)})",
          flush=True)
    if any(p != expected_step for p in per_step):
        fail(f"TRAIN-ROBERTA: launches per step {per_step} != {expected_step}")
    if not all(np.isfinite(losses)):
        fail(f"TRAIN-ROBERTA: non-finite loss {losses}")

    # one more step's forward and backward apart, on device events
    b = tr.to_device(batches[-1])
    split = {"forward": [], "backward": []}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        leaves = {p: v.detach().requires_grad_() for p, v in trees.flatten(tr.trainable).items()}
        t = trees.map_with_path(lambda p, _: leaves[p], tr.trainable)
        ev[0].record()
        loss = tr.loss(t, b)
        ev[1].record()
        torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        ev[2].record()
        ev[2].synchronize()
        split["forward"].append(ev[0].elapsed_time(ev[1]))
        split["backward"].append(ev[1].elapsed_time(ev[2]))
    print("TRAIN-ROBERTA device ms, forward / backward (median of 3): "
          f"{sorted(split['forward'])[1]:.3f} / {sorted(split['backward'])[1]:.3f}", flush=True)
    profile(torch, "TRAIN-ROBERTA step", lambda: tr.step(b), 1)
    t_card = time.perf_counter()

    # the first CPU_STEPS steps on the CPU through the plain versions, with
    # each step's gradients
    cpu = train.Trainer(train.parse_args(argv + ["--device", "cpu"]))
    cpu_losses, cpu_g = [], []
    for b in batches[:CPU_STEPS]:
        bt = cpu.to_device(b)
        cpu_g.append(trees.flatten(value_and_grad(lambda t, bt=bt: cpu.loss(t, bt),
                                                  cpu.trainable)[1]))
        cpu_losses.append(float(cpu.step(bt)))
    loss_err = max(abs(a - c) / max(1.0, abs(c)) for a, c in zip(losses, cpu_losses))
    grad_errs = [max((cg[p] - g).abs().max().item() for p, g in pg.items())
                 for cg, pg in zip(card_g, cpu_g)]
    grad_err = max(grad_errs)
    # the elements whose gradient AdamW cannot carry within the limit (see
    # the note at ROBERTA_PARAM_TOL)
    lr = tr.args.lr
    gain = 1 + CPU_STEPS * lr / (4 * ROBERTA_PARAM_TOL)
    settled_err, open_err, n_open, n_all = 0.0, 0.0, 0, 0
    for p, v in trees.flatten(cpu.trainable).items():
        d = (after[p] - v).abs()
        unsure = torch.zeros_like(d, dtype=torch.bool)
        for cg, pg in zip(card_g, cpu_g):
            if pg.get(p) is not None:
                unsure |= pg[p].abs() < gain * (cg[p] - pg[p]).abs()
        settled_err = max(settled_err, float((d * ~unsure).max()))
        open_err = max(open_err, float((d * unsure).max()))
        n_open += int(unsure.sum())
        n_all += d.numel()
    t_end = time.perf_counter()
    print(f"TRAIN-ROBERTA CPU (plain versions) losses {[round(x, 5) for x in cpu_losses]} "
          f"loss_max_rel_err={loss_err:.2e} (tol {ROBERTA_LOSS_TOL:g}) "
          f"grad_max_abs_err per step={[f'{e:.2e}' for e in grad_errs]} "
          f"(tol {ROBERTA_GRAD_TOL:g}) trainable_max_abs_err after step {CPU_STEPS}="
          f"{settled_err:.2e} (tol {ROBERTA_PARAM_TOL:g}; a step's |g| below "
          f"{gain:g}x its card-vs-CPU difference: {n_open} of {n_all} elements, "
          f"max {open_err:.2e}, tol {CPU_STEPS}*2*lr={CPU_STEPS * 2 * lr:g})", flush=True)
    print(f"TRAIN-ROBERTA seconds: build {t_built - t0:.1f} card {t_card - t_built:.1f} "
          f"cpu {t_end - t_card:.1f}", flush=True)
    if (loss_err > ROBERTA_LOSS_TOL or grad_err > ROBERTA_GRAD_TOL
            or settled_err > ROBERTA_PARAM_TOL or open_err > CPU_STEPS * 2 * lr):
        fail(f"TRAIN-ROBERTA: card vs CPU loss {loss_err:.2e}, gradients {grad_errs}, "
             f"trainables {settled_err:.2e} (AdamW-bound elements: {open_err:.2e})")
    return launches, dict(median_step_ms=sorted(step_ms)[len(step_ms) // 2], losses=losses,
                          forward_ms=sorted(split["forward"])[1],
                          backward_ms=sorted(split["backward"])[1], per_step=per_step[0])


# TRAIN-PFIT: card vs CPU (see train_pfit).  TRAIN-PPO: card vs CPU on prep
# and the first epoch (see train_ppo).
# fig4_pfit.py's quick profile (4 rounds, 120 + 120 steps), cut to keep the
# script inside its time: 2 rounds, 60 pretraining and 60 reward-model steps
PFIT_QUICK = dict(rounds=2, pretrain_steps=60, rm_steps=60)
PFIT_PROFILE = dict(rounds=1, pretrain_steps=10, rm_steps=10)   # the profiled run
PFIT_PAIR_ACC_TOL = 0.02
PFIT_REWARD_TOL = 0.05
PFIT_TIE = 1e-3
# TRAIN-PFIT's methods re-run on the CPU, cut (PR 30, for the script's
# time) from all four: sfl and pfl run pfit's PPO round with another
# aggregation, and shepherd's supervised round is re-run on the CPU in
# TRAIN-POP (c); their card runs and launch checks stay
PFIT_CPU_METHODS = ("pfit",)
PPO_BATCH, PPO_PROMPT, PPO_GEN = 8, 128, 64
PPO_TOL = 1e-4


def pfit_expected(cfg, method, trained=None):
    """Each kernel's launches in one ``run_pfit``: the policy (``n_layers``
    layers) runs ``flash_attn`` once a layer per forward, ``decode_attn``
    once a layer per decode step, and for shepherd ``lora_fused`` on wq and
    wv; each reward model (2 layers) runs ``flash_attn`` once a layer per
    score.  Pretraining: a forward a step.  Reward models: a winner's and a
    loser's score a step, two scores for the pair accuracy, both models.
    A round, per client: the evaluation (a rollout, a prefill and
    ``gen_len`` decode steps, scored by both models) and the training —
    shepherd's local steps, or a PPO rollout scored by both models, prep's
    two forwards (policy and reference) and one forward an epoch.
    ``trained``: the client-rounds that train (default every client every
    round; the robust round runs only the trace's ``train`` clients, and
    evaluates every client)."""
    L, rm_layers, gen = cfg.n_layers, 2, cfg.gen_len
    shepherd = method == "shepherd"
    score = 2 * rm_layers                          # both reward models
    flash = L * cfg.pretrain_steps + 2 * rm_layers * 2 * (cfg.rm_steps + 1)
    n = cfg.rounds * cfg.n_clients
    t = n if trained is None else trained
    flash += n * (L + score)                       # evaluation
    decode = n * L * gen
    lora = n * 2 * L * (1 + gen) if shepherd else 0
    if shepherd:
        flash += t * L * cfg.shepherd_steps
        lora += t * 2 * L * cfg.shepherd_steps
    else:
        flash += t * (L + score + 2 * L + cfg.ppo.ppo_epochs * L)
        decode += t * L * gen
    return {"lora_fused": lora, "flash_attn": flash, "decode_attn": decode,
            "block_sparse_attn": 0, "ssd_chunk": 0}


def first_differences(card, cpu):
    """Per row whose tokens differ: (client, row, step, card's and CPU's
    top-two score gaps at the first differing step)."""
    out = []
    for ci, (a, b) in enumerate(zip(card, cpu)):
        p = a["tokens"].shape[1] - a["margin"].shape[1]
        for row in range(a["tokens"].shape[0]):
            diff = (a["tokens"][row, p:] != b["tokens"][row, p:]).nonzero()[0]
            if len(diff):
                t = int(diff[0])
                out.append((ci, row, t, float(a["margin"][row, t]), float(b["margin"][row, t])))
    return out


def train_pfit(torch):
    """TRAIN-PFIT: ``run_pfit`` for the four methods of Fig. 4 at
    ``PFIT_QUICK`` (``benchmarks/fig4_pfit.py``'s quick profile cut to 2
    rounds, 60 pretraining and 60 reward-model steps; ``PFITConfig``
    defaults otherwise: 4 clients,
    rollout batch 16, prompt 16, gen 24, d 128, 4 layers, last-K 2, seed 0,
    f32) on the card, launch counts checked, then the runs of
    ``PFIT_CPU_METHODS`` on the CPU through the plain versions from the
    same seeds and noise streams.
    Per-round bytes and delays must be equal; the reward models' pair
    accuracies within PFIT_PAIR_ACC_TOL (counts over 256 pairs: one flip is
    0.004); the reward per round within PFIT_REWARD_TOL.  Round 0's sampled
    tokens (each PPO client's rollout, and each client's evaluation when its
    rollout matched) must be equal, except at an f32 near-tie: where a row
    first differs, the gap between its two highest scores (g + logits / T)
    on the card or the CPU must be under PFIT_TIE."""
    from repro_torch.core.pfit import METHODS, PFITConfig, run_pfit

    kernels = wrappers()
    total = {n: 0 for n in KERNELS}
    out = {}
    for method in METHODS:
        cfg = PFITConfig(method=method, **PFIT_QUICK)
        for f in kernels.values():
            f.launches = 0
        t0 = time.perf_counter()
        card = run_pfit(cfg)
        card_s = time.perf_counter() - t0
        launches = {n: f.launches for n, f in kernels.items()}
        ENGINE_RUNS["pfit", method] = dict(card, launches=launches)
        expected = pfit_expected(cfg, method)
        print(f"TRAIN-PFIT {method:<8} run_s={card_s:.2f} pretrain_s={card['pretrain_s']:.3f} "
              f"rm_s={card['rm_s']:.3f} "
              f"s_per_round={sum(card['round_s']) / len(card['round_s']):.4f} "
              f"round_s={[round(x, 4) for x in card['round_s']]} "
              f"reward_per_round={[round(r, 5) for r in card['reward_per_round']]} "
              f"rm_pair_acc={card['rm_pair_acc']} "
              f"mean_round_bytes={card['mean_round_bytes']:.1f} "
              f"mean_round_delay_s={card['mean_round_delay_s']:.6f}", flush=True)
        print(f"TRAIN-PFIT {method:<8} launches {launches} expected {expected}", flush=True)
        if launches != expected:
            fail(f"TRAIN-PFIT {method}: kernel launches {launches} != expected {expected}")
        if method not in PFIT_CPU_METHODS:
            print(f"TRAIN-PFIT {method:<8} CPU re-run cut (PFIT_CPU_METHODS)", flush=True)
        else:
            t0 = time.perf_counter()
            cpu = run_pfit(dataclasses.replace(cfg, device="cpu"))
            cpu_s = time.perf_counter() - t0
            same_ledger = ([(r["bytes"], r["delay_s"]) for r in card["round_records"]]
                           == [(r["bytes"], r["delay_s"]) for r in cpu["round_records"]])
            acc_err = max(abs(card["rm_pair_acc"][k] - cpu["rm_pair_acc"][k])
                          for k in ("help", "safe"))
            reward_err = max(abs(a - b) for a, b in zip(card["reward_per_round"],
                                                        cpu["reward_per_round"]))
            rollout_diffs = first_differences(card["rollouts_round0"], cpu["rollouts_round0"])
            moved = {d[0] for d in rollout_diffs}
            eval_diffs = [d for d in first_differences(card["eval_round0"], cpu["eval_round0"])
                          if d[0] not in moved]
            ties_ok = all(min(d[3], d[4]) < PFIT_TIE for d in rollout_diffs + eval_diffs)
            print(f"TRAIN-PFIT {method:<8} CPU (plain versions, {cpu_s:.1f} s): "
                  f"reward_per_round={[round(r, 5) for r in cpu['reward_per_round']]} "
                  f"reward_max_abs_err={reward_err:.2e} (tol {PFIT_REWARD_TOL}) "
                  f"rm_pair_acc={cpu['rm_pair_acc']} max_abs_err={acc_err:.4f} "
                  f"(tol {PFIT_PAIR_ACC_TOL}) bytes_and_delays_equal={same_ledger} "
                  f"round-0 rows differing (client, row, step, card gap, cpu gap): "
                  f"rollouts {rollout_diffs} eval {eval_diffs} (near-tie below {PFIT_TIE:g}: "
                  f"{ties_ok})", flush=True)
            if (not same_ledger or acc_err > PFIT_PAIR_ACC_TOL or reward_err > PFIT_REWARD_TOL
                    or not ties_ok):
                fail(f"TRAIN-PFIT {method}: card and CPU differ (ledger equal {same_ledger}, "
                     f"pair acc {acc_err:.4f}, reward {reward_err:.2e}, near-ties {ties_ok})")
        for n in KERNELS:
            total[n] += launches[n]
        out[method] = {k: card[k] for k in ("reward_per_round", "mean_round_bytes",
                                            "mean_round_delay_s", "pretrain_s", "rm_s",
                                            "round_s", "rm_pair_acc")}
        out[method]["launches"] = launches
    # the device's busy share over a whole run (pretraining, reward models,
    # a round), cut to PFIT_PROFILE's steps for the script's time (at
    # PFIT_QUICK's, parsing the trace took 30.3 s)
    profile(torch, "TRAIN-PFIT pfit run_pfit (1 round, 10 + 10 steps)",
            lambda: run_pfit(PFITConfig(**PFIT_PROFILE)), 1)
    return total, out


def train_ppo(torch, np):
    """TRAIN-PPO: one client's PPO round at gpt2-small's full width and
    depth (12 layers, d 768, 12 heads of 64, vocab 50257; random weights
    from torch seed 0, value head 0), masks last-2-layers × 40 % head
    sparsity (seed 0), AdamW at ``PFITConfig``'s lr.  A rollout (batch 8,
    prompt 128 from numpy seed 0, 64 sampled decode steps from noise stream
    (0, 0): a cache of 192, SERVE's shapes), then ``PPOTrainer.round``
    (prep and 2 clipped epochs) against the reference = the same weights.
    The reward models exist only over the synthetic corpus's 512-token
    vocabulary, so the terminal reward is a fixed numpy draw (seed 1).
    Then prep and the first epoch apart (host ms ending in a synchronize,
    forward and backward on device events, a PROFILE of a step), and the
    same prep and first epoch on the CPU from the same init and the card's
    tokens: logp, advantages and loss within PPO_TOL relative to max(1,
    max |x|); the trainables within PPO_TOL except where AdamW's first step
    cannot carry the gradient's own card-vs-CPU difference (TRAIN-ROBERTA's
    rule, K = 1 + lr/(4·PPO_TOL); gradients read off AdamW's first moment,
    0.1·g): there 2·lr; every masked-out parameter bit-equal to its init."""
    from repro_torch import trees
    from repro_torch.configs import get_config
    from repro_torch.core.pfit import PFITConfig
    from repro_torch.models import peft
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw
    from repro_torch.rlhf import ppo, rollout

    cfg = get_config("gpt2-small")
    lr = PFITConfig.lr
    L = cfg.n_layers
    kernels = wrappers()

    def setup(device):
        model = Model(cfg, device=device)
        params = model.init(torch.Generator().manual_seed(0))
        params["value_head"] = torch.zeros(cfg.d_model, 1, device=model.device)
        mask = trees.map_leaves(lambda a, b: a * b, peft.last_k_layers_mask(params, cfg, 2),
                                peft.head_sparsity_mask(params, cfg, 0.4, seed=0))
        trainer = ppo.PPOTrainer(model, adamw(lr), ppo.PPOConfig(), PPO_PROMPT)
        return model, params, mask, trainer

    def counts():
        return {n: f.launches for n, f in kernels.items()}

    def since(before):
        return {n: f.launches - before[n] for n, f in kernels.items()}

    t_start = time.perf_counter()
    model, params, mask, trainer = setup("cuda")
    prompts = torch.from_numpy(np.random.RandomState(0).randint(
        6, cfg.vocab_size, size=(PPO_BATCH, PPO_PROMPT))).cuda()
    reward = torch.from_numpy(np.random.RandomState(1).randn(PPO_BATCH).astype(np.float32)).cuda()
    noise = rollout.gumbel_stream(0, 0, PPO_GEN, PPO_BATCH, cfg.vocab_size, "cuda")
    rollout.generate(model, params, prompts[:, :8], 2, noise)            # warm-up
    phases, times = {}, {}
    torch.cuda.synchronize()
    before, t0 = counts(), time.perf_counter()
    toks = rollout.generate(model, params, prompts, PPO_GEN, noise)
    torch.cuda.synchronize()
    times["rollout_ms"] = (time.perf_counter() - t0) * 1e3
    phases["rollout"] = since(before)
    before, t0 = counts(), time.perf_counter()
    _, _, stats = trainer.round(params, params, trainer.opt.init(params), toks, reward,
                                grad_mask=mask)
    torch.cuda.synchronize()
    times["round_ms"] = (time.perf_counter() - t0) * 1e3
    phases["round"] = since(before)
    before, t0 = counts(), time.perf_counter()
    prepped = trainer._prep(params, params, toks, reward)
    torch.cuda.synchronize()
    times["prep_ms"] = (time.perf_counter() - t0) * 1e3
    phases["prep"] = since(before)
    step_ms, state = [], (params, trainer.opt.init(params))
    for i in range(2):
        before, t0 = counts(), time.perf_counter()
        new_p, new_st, loss, _ = trainer._step(*state, toks, *prepped[:4], mask)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        phases["step"] = since(before)
        if i == 0:
            first = (new_p, new_st, float(loss))
        state = (new_p, new_st)
    times["step_ms"] = step_ms
    expected = {"rollout": dict(flash_attn=L, decode_attn=L * PPO_GEN),
                "round": dict(flash_attn=2 * L + 2 * L), "prep": dict(flash_attn=2 * L),
                "step": dict(flash_attn=L)}
    expected = {ph: {n: e.get(n, 0) for n in KERNELS} for ph, e in expected.items()}
    tok_ok = toks.shape == (PPO_BATCH, PPO_PROMPT + PPO_GEN) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all())
    print(f"TRAIN-PPO gpt2-small full width ({L} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size}) batch {PPO_BATCH} prompt {PPO_PROMPT} gen {PPO_GEN} f32, "
          f"last-2 layers x 40% head sparsity, terminal reward a fixed numpy draw: "
          f"rollout_ms={times['rollout_ms']:.2f} round_ms={times['round_ms']:.2f} "
          f"prep_ms={times['prep_ms']:.2f} step_ms={[round(x, 2) for x in step_ms]} "
          f"round_stats={ {k: round(v, 5) for k, v in stats.items()} }", flush=True)
    print(f"TRAIN-PPO launches per phase {phases} expected {expected}", flush=True)
    if phases != expected or not tok_ok or not np.isfinite(first[2]):
        fail(f"TRAIN-PPO: launches {phases} != {expected}, tokens ok {tok_ok}, "
             f"loss {first[2]}")

    # one more step's forward and backward apart, on device events
    split = {"forward": [], "backward": []}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        leaves = {p: v.detach().requires_grad_() for p, v in trees.flatten(params).items()}
        t = trees.map_with_path(lambda p, _: leaves[p], params)
        ev[0].record()
        loss, _ = ppo.clipped_loss(model, trainer.cfg, t, toks, *prepped[:4])
        ev[1].record()
        torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        ev[2].record()
        ev[2].synchronize()
        split["forward"].append(ev[0].elapsed_time(ev[1]))
        split["backward"].append(ev[1].elapsed_time(ev[2]))
    print("TRAIN-PPO device ms, forward / backward (median of 3): "
          f"{sorted(split['forward'])[1]:.3f} / {sorted(split['backward'])[1]:.3f}", flush=True)
    profile(torch, "TRAIN-PPO step", lambda: trainer._step(params, trainer.opt.init(params),
                                                            toks, *prepped[:4], mask), 1)
    t_card = time.perf_counter()

    # prep and the first epoch on the CPU through the plain versions
    _, c_params, c_mask, c_trainer = setup("cpu")
    c_toks, c_reward = toks.cpu(), reward.cpu()
    c_prepped = c_trainer._prep(c_params, c_params, c_toks, c_reward)
    c_new, c_st, c_loss, _ = c_trainer._step(c_params, c_trainer.opt.init(c_params), c_toks,
                                             *c_prepped[:4], c_mask)

    def rel(a, b):
        return float((a.cpu() - b).abs().max()) / max(1.0, float(b.abs().max()))

    logp_err, adv_err = rel(prepped[0], c_prepped[0]), rel(prepped[1], c_prepped[1])
    loss_err = abs(first[2] - float(c_loss)) / max(1.0, abs(float(c_loss)))
    gain = 1 + lr / (4 * PPO_TOL)
    c_flat, c_mu = trees.flatten(c_new), trees.flatten(c_st["mu"])
    card_flat, card_mu = trees.flatten(first[0]), trees.flatten(first[1]["mu"])
    init, m = trees.flatten(c_params), trees.flatten(c_mask)
    settled_err = open_err = 0.0
    n_open = n_all = n_frozen = 0
    frozen_ok = True
    for p, v in c_flat.items():
        got = card_flat[p].cpu()
        d = (got - v).abs()
        unsure = c_mu[p].abs() < gain * (card_mu[p].cpu() - c_mu[p]).abs()   # mu = 0.1·g
        settled_err = max(settled_err, float((d * ~unsure).max()))
        open_err = max(open_err, float((d * unsure).max()))
        n_open += int(unsure.sum())
        n_all += d.numel()
        off = torch.broadcast_to(m[p], v.shape) == 0
        n_frozen += int(off.sum())
        frozen_ok &= bool(torch.equal(got[off], init[p][off])) and bool(
            torch.equal(v[off], init[p][off]))
    t_end = time.perf_counter()
    print(f"TRAIN-PPO CPU (plain versions, prep and epoch 1 on the card's tokens): "
          f"logp_rel_err={logp_err:.2e} adv_rel_err={adv_err:.2e} loss_rel_err={loss_err:.2e} "
          f"(tol {PPO_TOL:g}) trainable_max_abs_err={settled_err:.2e} (tol {PPO_TOL:g}; a "
          f"gradient below {gain:g}x its card-vs-CPU difference: {n_open} of {n_all} "
          f"elements, max {open_err:.2e}, tol 2*lr={2 * lr:g}) masked-out "
          f"{n_frozen} elements bit-equal to init: {frozen_ok}", flush=True)
    print(f"TRAIN-PPO seconds: card {t_card - t_start:.1f} cpu {t_end - t_card:.1f}", flush=True)
    if (max(logp_err, adv_err, loss_err, settled_err) > PPO_TOL or open_err > 2 * lr
            or not frozen_ok):
        fail(f"TRAIN-PPO: card vs CPU logp {logp_err:.2e}, adv {adv_err:.2e}, loss "
             f"{loss_err:.2e}, trainables {settled_err:.2e} (AdamW-bound {open_err:.2e}), "
             f"masked-out equal {frozen_ok}")
    launches = {n: phases["rollout"][n] + phases["round"][n] for n in KERNELS}
    return launches, dict(times, **{k: sorted(v)[1] for k, v in
                                    (("forward_ms", split["forward"]),
                                     ("backward_ms", split["backward"]))},
                          launches=phases, logp_rel_err=logp_err, adv_rel_err=adv_err,
                          loss_rel_err=loss_err, trainable_err=settled_err)


# TRAIN-ROBUST: the robust round (fault plans, staleness, deadlines, quorum,
# checkpoint and resume) on the card, against the CPU and against itself.
# MIX and DL are tests/test_deadline.py's, FAULTY tests/test_faults.py's.
ROBUST_MIX = dict(dropout_p=0.25, straggle_p=0.3, max_straggle=2, crash_p=0.1, max_crash=1,
                  snr_dip_p=0.2, corrupt_p=0.25, seed=5)
ROBUST_DL = dict(deadline_s=0.05, backoff_base_s=0.01, max_retries=3, min_quorum=2,
                 compute_mean_s=0.005, seed=11)
ROBUST_FAULTY = dict(dropout_p=0.3, straggle_p=0.3, max_straggle=2, crash_p=0.15,
                     max_crash=2, snr_dip_p=0.25, seed=3)
ROBUST_ROUNDS, ROBUST_CUT = 6, 3
ROBUST_PFIT_ROUNDS = 4
AGG_TOL = 1e-6


def same_records(a, b):
    """Two ledgers' round records equal, NaN delays included."""
    import numpy as np
    try:
        np.testing.assert_equal(a, b)
    except AssertionError:
        return False
    return True


def robust_summary(res):
    recs = res["round_records"]
    return (f"sim_time_s={res['total_sim_time_s']:.4f} quorum_noops={res['quorum_noops']} "
            f"delivered={[r.get('n_delivered') for r in recs]} "
            f"corrupt={[r.get('corrupt') for r in recs]} bytes={[r['bytes'] for r in recs]} "
            f"staleness={res['staleness']}")


def robust_pftt_config(*flags):
    """TRAIN-ROBUST (a)'s ``PFTTConfig``: the launcher's robust flags (MIX,
    DL, staleness) and ``flags``, DL's seed set on the config (no flag)."""
    from repro_torch.launch import train

    spec = ",".join(f"{k}={v}" for k, v in ROBUST_MIX.items())
    args = train.parse_args([
        "--arch", "roberta-base", "--fl-clients", "4", "--fl-rounds", str(ROBUST_ROUNDS),
        "--fault-plan", spec, "--staleness-a", "0.5", "--max-staleness", "3",
        "--deadline-s", str(ROBUST_DL["deadline_s"]),
        "--backoff-base-s", str(ROBUST_DL["backoff_base_s"]),
        "--max-retries", str(ROBUST_DL["max_retries"]),
        "--min-quorum", str(ROBUST_DL["min_quorum"]),
        "--compute-time-s", str(ROBUST_DL["compute_mean_s"]), *flags])
    cfg = train.pftt_config(args, verbose=False)
    return dataclasses.replace(cfg, deadline=dataclasses.replace(cfg.deadline,
                                                                 seed=ROBUST_DL["seed"]))


def train_robust_pftt(torch):
    """TRAIN-ROBUST (a): ``run_pftt`` (method pftt) at TRAIN-PFTT's launcher
    settings (``--fl-clients 4``, seed 0, f32) for 6 rounds under the
    launcher's robust flags: ``MIX`` (corruption on), ``DL`` (deadline
    0.05 s, backoff 0.01 s, 3 retries, quorum 2, compute 0.005 s; its seed
    11 set on the config, which has no flag), ``--staleness-a 0.5
    --max-staleness 3``.  Launches against ``pftt_expected`` over the
    trace's training client-rounds.  Then 3 rounds with a checkpoint
    directory and a resumed run to 6: every round record equal to the
    uninterrupted run's, accuracies within PFTT_ACC_TOL (the resumed
    process pretrains the frozen base again).  Then the same run on the CPU
    from the same init: records equal, accuracies within PFTT_ACC_TOL."""
    import tempfile

    from repro_torch.core.pftt import run_pftt

    cfg = robust_pftt_config()
    trained = int(cfg.fault_plan.realize(cfg.n_clients, cfg.rounds).train.sum())
    kernels = wrappers()
    for f in kernels.values():
        f.launches = 0
    card = run_pftt(cfg)
    launches = {n: f.launches for n, f in kernels.items()}
    ENGINE_RUNS["robust_pftt"] = dict(card, launches=launches)
    expected = pftt_expected(cfg, "pftt", trained)
    print(f"TRAIN-ROBUST pftt MIX+DL {cfg.rounds} rounds x {cfg.n_clients} clients "
          f"({trained} client-rounds train): pretrain_s={card['pretrain_s']:.3f} "
          f"s_per_round={sum(card['round_s']) / len(card['round_s']):.4f} "
          f"round_s={[round(x, 4) for x in card['round_s']]} "
          f"acc_per_round={[round(a, 4) for a in card['acc_per_round']]} "
          f"{robust_summary(card)}", flush=True)
    print(f"TRAIN-ROBUST pftt launches {launches} expected {expected}", flush=True)
    if launches != expected:
        fail(f"TRAIN-ROBUST pftt: kernel launches {launches} != expected {expected}")

    with tempfile.TemporaryDirectory() as ck:
        run_pftt(dataclasses.replace(cfg, rounds=ROBUST_CUT, ckpt_dir=ck))   # "killed"
        resumed = run_pftt(dataclasses.replace(cfg, ckpt_dir=ck, resume=True))
    res_ok = same_records(resumed["round_records"], card["round_records"])
    res_err = max(abs(a - b) for a, b in zip(resumed["acc_per_round"], card["acc_per_round"]))
    print(f"TRAIN-ROBUST pftt kill after {ROBUST_CUT} rounds and resume to {cfg.rounds}: "
          f"resumed rounds {len(resumed['round_s'])} "
          f"acc_per_round={[round(a, 4) for a in resumed['acc_per_round']]} "
          f"acc_max_abs_err={res_err:.4f} (tol {PFTT_ACC_TOL}) ledger_equal={res_ok} "
          f"staleness={resumed['staleness']}", flush=True)
    t0 = time.perf_counter()
    cpu = run_pftt(dataclasses.replace(cfg, device="cpu"))
    cpu_s = time.perf_counter() - t0
    cpu_ok = same_records(cpu["round_records"], card["round_records"])
    cpu_err = max(abs(a - b) for a, b in zip(cpu["acc_per_round"], card["acc_per_round"]))
    print(f"TRAIN-ROBUST pftt CPU (plain versions, {cpu_s:.1f} s): "
          f"acc_per_round={[round(a, 4) for a in cpu['acc_per_round']]} "
          f"acc_max_abs_err={cpu_err:.4f} (tol {PFTT_ACC_TOL}) ledger_equal={cpu_ok} "
          f"staleness={cpu['staleness']}", flush=True)
    if not (res_ok and cpu_ok) or max(res_err, cpu_err) > PFTT_ACC_TOL:
        fail(f"TRAIN-ROBUST pftt: resume ledger {res_ok} acc {res_err:.4f}, CPU ledger "
             f"{cpu_ok} acc {cpu_err:.4f}")
    row = {k: card[k] for k in ("acc_per_round", "round_s", "pretrain_s", "total_sim_time_s",
                                "quorum_noops", "staleness")}
    return launches, dict(row, launches=launches, resume_acc_err=res_err, cpu_acc_err=cpu_err)


def train_robust_pfit(torch):
    """TRAIN-ROBUST (b): ``run_pfit`` (method pfit) at TRAIN-PFIT's quick
    profile for 4 rounds under ``FAULTY``, ``staleness_a`` 0.5,
    ``max_staleness`` 2: launches against ``pfit_expected`` over the trace's
    training client-rounds, rewards and seconds per round; the same run on
    the CPU: every round record equal, rewards within PFIT_REWARD_TOL."""
    from repro_torch.core.pfit import PFITConfig, run_pfit
    from repro_torch.wireless import FaultPlan

    cfg = PFITConfig(method="pfit", **dict(PFIT_QUICK, rounds=ROBUST_PFIT_ROUNDS),
                     fault_plan=FaultPlan(**ROBUST_FAULTY), staleness_a=0.5, max_staleness=2)
    trained = int(cfg.fault_plan.realize(cfg.n_clients, cfg.rounds).train.sum())
    kernels = wrappers()
    for f in kernels.values():
        f.launches = 0
    card = run_pfit(cfg)
    launches = {n: f.launches for n, f in kernels.items()}
    expected = pfit_expected(cfg, "pfit", trained)
    print(f"TRAIN-ROBUST pfit FAULTY {cfg.rounds} rounds x {cfg.n_clients} clients "
          f"({trained} client-rounds train): "
          f"s_per_round={sum(card['round_s']) / len(card['round_s']):.4f} "
          f"round_s={[round(x, 4) for x in card['round_s']]} "
          f"reward_per_round={[round(r, 5) for r in card['reward_per_round']]} "
          f"train_reward_per_round={[round(r, 5) for r in card['train_reward_per_round']]} "
          f"{robust_summary(card)}", flush=True)
    print(f"TRAIN-ROBUST pfit launches {launches} expected {expected}", flush=True)
    if launches != expected:
        fail(f"TRAIN-ROBUST pfit: kernel launches {launches} != expected {expected}")
    t0 = time.perf_counter()
    cpu = run_pfit(dataclasses.replace(cfg, device="cpu"))
    cpu_s = time.perf_counter() - t0
    ok = same_records(cpu["round_records"], card["round_records"])
    err = max(abs(a - b) for a, b in zip(cpu["reward_per_round"], card["reward_per_round"]))
    print(f"TRAIN-ROBUST pfit CPU (plain versions, {cpu_s:.1f} s): "
          f"reward_per_round={[round(r, 5) for r in cpu['reward_per_round']]} "
          f"reward_max_abs_err={err:.2e} (tol {PFIT_REWARD_TOL}) ledger_equal={ok}", flush=True)
    if not ok or err > PFIT_REWARD_TOL:
        fail(f"TRAIN-ROBUST pfit: card and CPU differ (ledger equal {ok}, reward {err:.2e})")
    row = {k: card[k] for k in ("reward_per_round", "round_s", "staleness")}
    return launches, dict(row, launches=launches, cpu_reward_err=err)


# (train, agg_w, recv, rejoin, ontime) of TRAIN-ROBUST (c)'s rounds, 2 clients
ROBUST_PPO_ROUNDS = (
    # R1: client 1 straggles (retransmits its pending payload at a
    # discount); neither takes the broadcast
    ("straggle", 0, ([1, 0], [1.0, 0.5], [0, 0], [0, 0], [1, 1])),
    # R2: client 1 rejoins (optimizer zeroed); one delivery (client 0)
    ("rejoin", 0, ([1, 0], [1.0, 0.0], [1, 1], [0, 1], [1, 1])),
    # R3: client 1's fresh upload misses the deadline; one delivery
    ("deadline", 0, ([1, 1], [1.0, 1.0], [1, 1], [0, 0], [1, 0])),
    # R4: both retransmit, client 0 late: one delivery (client 1's payload,
    # which R3 left unmerged) under a quorum of 2
    ("void", 2, ([0, 0], [0.5, 0.5], [1, 1], [0, 0], [0, 1])),
)


def train_robust_ppo(torch, np):
    """TRAIN-ROBUST (c): ``build_ppo_round(robust=True)`` at gpt2-small's
    full width and depth with TRAIN-PPO's model, masks (client ci: last-2
    layers x 40 % head sparsity, seed ci) and fixed terminal reward, 2
    clients, rollout batch 8, prompt 128, 64 decode steps.  First the
    synchronous round and the robust round with all-ones masks on the same
    inputs (after an untimed warm-up): their ms.  Then the hand-set rounds
    of ROBUST_PPO_ROUNDS, counted: bitwise on the card, a client that does
    not train keeps its parameters and optimizer state (and, when the
    broadcast skips it, its parameters), a rejoining client's optimizer
    state is all zeros (step included), ``pending`` holds the upload (the
    trained client the broadcast skipped) or the old payload, and the
    voided round keeps the global and every client; the global after a
    round with one delivery equals the plain ``masked_fedavg_stacked`` of
    that client alone within AGG_TOL."""
    from repro_torch import trees
    from repro_torch.configs import get_config
    from repro_torch.core import cohort
    from repro_torch.core.aggregation import masked_fedavg_stacked
    from repro_torch.core.pfit import PFITConfig
    from repro_torch.models import peft
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw
    from repro_torch.rlhf import ppo, rollout

    cfg = get_config("gpt2-small")
    L, n = cfg.n_layers, 2
    kernels = wrappers()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator().manual_seed(0))
    params["value_head"] = torch.zeros(cfg.d_model, 1, device="cuda")
    masks = trees.stack([trees.map_leaves(
        lambda a, b: a * b, peft.last_k_layers_mask(params, cfg, 2),
        peft.head_sparsity_mask(params, cfg, 0.4, seed=ci)) for ci in range(n)])
    opt = adamw(PFITConfig.lr)
    prompts = torch.from_numpy(np.random.RandomState(0).randint(
        6, cfg.vocab_size, size=(n, PPO_BATCH, PPO_PROMPT))).cuda()
    reward = torch.from_numpy(np.random.RandomState(1).randn(PPO_BATCH).astype(np.float32)).cuda()

    def quality(toks, resp, ah, asafe):
        return reward

    def build(**kw):
        return cohort.build_ppo_round(model, opt, ppo.PPOConfig(), PPO_PROMPT, PPO_GEN,
                                      quality, **kw)

    def noises(rnd):
        return [rollout.gumbel_stream(0, rnd * 17 + ci, PPO_GEN, PPO_BATCH, cfg.vocab_size,
                                      "cuda") for ci in range(n)]

    def fresh():
        return (trees.stack([params] * n), trees.stack([opt.init(params)] * n),
                trees.map_leaves(torch.clone, params))

    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device="cuda")

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    alphas = ([0.5] * n, [0.5] * n)
    sync, robust_q0 = build(), build(robust=True)
    one = vec([1.0] * n)

    def run_sync():
        return timed(sync, *fresh(), masks, prompts, noises(0), *alphas, one)

    def run_robust():
        st, so, glob = fresh()
        return timed(robust_q0, st, so, glob, trees.map_leaves(torch.zeros_like, st), masks,
                     prompts, noises(0), *alphas, one, one, one, vec([0.0] * n), one)

    run_sync()                                               # warm-up
    sync_ms, robust_ms = [], []
    sync_out, ms = run_sync()
    sync_ms.append(ms)
    for _ in range(2):                                       # sync, robust, robust, sync
        out, ms = run_robust()
        robust_ms.append(ms)
    sync_ms.append(run_sync()[1])
    st, so, glob, pending = out[:4]
    diff = max(float((a - b).abs().max()) for a, b in zip(
        trees.flatten(sync_out[0]).values(), trees.flatten(st).values()))
    print(f"TRAIN-ROBUST ppo gpt2-small full width, {n} clients, batch {PPO_BATCH}, prompt "
          f"{PPO_PROMPT}, gen {PPO_GEN}: sync_round_ms={[round(x, 1) for x in sync_ms]} "
          f"robust_round_ms={[round(x, 1) for x in robust_ms]} (all-ones masks, same inputs, "
          f"in turns sync, robust, robust, sync; clients' max abs difference {diff:.2e})",
          flush=True)
    del sync_out

    steps = {0: robust_q0, 2: build(robust=True, min_quorum=2)}
    checks = {}
    for f in kernels.values():
        f.launches = 0
    trained = 0
    for rnd, (tag, quorum, m) in enumerate(ROBUST_PPO_ROUNDS, start=1):
        train_m, agg_w, recv, rejoin, ontime = m
        g_prev = trees.map_leaves(torch.clone, glob)
        old = {k: v.clone() for k, v in trees.flatten(
            {"t": st, "o": so, "p": pending}).items()}
        out, ms = timed(steps[quorum], st, so, glob, pending, masks, prompts, noises(rnd),
                        *alphas, vec(agg_w), vec(train_m), vec(recv), vec(rejoin), vec(ontime))
        st, so, glob, pending = out[:4]
        trained += sum(train_m)
        new = trees.flatten({"t": st, "o": so, "p": pending})
        ok = True
        for k, v in new.items():
            for ci in range(n):
                if k.startswith("o/") and rejoin[ci]:
                    ok &= not bool(v[ci].any())
                elif not train_m[ci] and (k[0] in "op" or not recv[ci] or tag == "void"):
                    ok &= torch.equal(v[ci], old[k][ci])
                elif k.startswith("p/") and not recv[ci]:     # the upload, unbroadcast
                    ok &= torch.equal(v[ci], new["t/" + k[2:]][ci])
        w = np.asarray(agg_w) * np.asarray(ontime)
        if tag == "void":
            prev = trees.flatten(g_prev)
            ok &= all(torch.equal(v, prev[k]) for k, v in trees.flatten(glob).items())
            agg_err = None
        else:
            sel = [ci for ci in range(n) if w[ci] > 0]
            ref = masked_fedavg_stacked(g_prev, trees.map_leaves(lambda v: v[sel], pending),
                                        trees.map_leaves(lambda v: v[sel], masks),
                                        vec(w[sel].tolist()))
            agg_err = max(float((a - trees.flatten(glob)[k]).abs().max())
                          for k, a in trees.flatten(ref).items())
            ok &= agg_err <= AGG_TOL
        checks[tag] = dict(ok=bool(ok), round_ms=ms, deliveries=int((w > 0).sum()),
                           global_vs_plain=agg_err,
                           mean_rewards=[round(float(r), 5) for r in out[4]])
        print(f"TRAIN-ROBUST ppo round {rnd} {tag} (train {train_m} agg_w {agg_w} recv {recv} "
              f"rejoin {rejoin} ontime {ontime} quorum {quorum}): round_ms={ms:.1f} "
              f"selection_bitwise_and_aggregate_ok={bool(ok)} global_vs_plain_masked_fedavg="
              f"{agg_err if agg_err is None else f'{agg_err:.2e}'} (tol {AGG_TOL:g}) "
              f"mean_rewards={checks[tag]['mean_rewards']}", flush=True)
    launches = {k: f.launches for k, f in kernels.items()}
    expected = {k: 0 for k in KERNELS}
    expected.update(flash_attn=int(trained) * 5 * L, decode_attn=int(trained) * L * PPO_GEN)
    print(f"TRAIN-ROBUST ppo launches {launches} expected {expected}", flush=True)
    bad = [t for t, c in checks.items() if not c["ok"]]
    if bad or launches != expected:
        fail(f"TRAIN-ROBUST ppo: rounds {bad} failed their checks; launches {launches} != "
             f"{expected}")
    return launches, dict(sync_round_ms=sync_ms, robust_round_ms=robust_ms, rounds=checks,
                          launches=launches)


# TRAIN-COMMS: the compressed uplink (codecs, factored aggregation) on the
# card, against the CPU.
def s_per_round(res):
    return sum(res["round_s"]) / len(res["round_s"])


def train_oracles(torch):
    """TRAIN-ORACLES: the JAX package's two parity oracles on the card,
    each held to the engine run of an earlier phase (not run again): (a)
    ``run_pftt(engine=False)``, method pftt, at TRAIN-PFTT's launcher
    settings, against TRAIN-PFTT's pftt run; (b) the same under TRAIN-ROBUST
    (a)'s flags (MIX, DL, staleness) against that phase's run; (c)
    ``run_pfit(engine=False)``, method pfit, at ``PFIT_QUICK`` against
    TRAIN-PFIT's pfit run (the path through ``decode_attn``); (d)
    ``run_pftt(factored=False)``, method fedlora, against TRAIN-PFTT's
    fedlora run.  Gates: the loops' per-round bytes and delays equal (every
    round record in (b), quorum no-ops and deliveries with it),
    accuracies within PFTT_ACC_TOL, mean local losses within PFTT_LOSS_TOL
    × max(1, |loss|), rewards within PFIT_REWARD_TOL, launches equal to
    ``pftt_expected``/``pfit_expected`` (the engine's count: the same
    per-client work through the same wrappers); (d): accuracies within
    PFTT_ACC_TOL, bytes equal, no ``lora_fused`` launch and the factored
    run's ``flash_attn`` count.  Each prints its seconds a round beside the
    engine's."""
    from repro_torch.core.pfit import PFITConfig, run_pfit
    from repro_torch.core.pftt import run_pftt
    from repro_torch.launch import train

    args = train.parse_args(["--arch", "roberta-base", "--fl-clients", "4",
                             "--fl-rounds", "3"])
    total = {n: 0 for n in KERNELS}
    out = {}

    def ledger(res):
        return [(r["bytes"], r["delay_s"]) for r in res["round_records"]]

    def max_err(a, b, rel=False):
        return max(abs(x - y) / (max(1.0, abs(y)) if rel else 1.0) for x, y in zip(a, b))

    def report(tag, res, eng, launches, expected, gates, metric):
        print(f"TRAIN-ORACLES {tag}: s_per_round={s_per_round(res):.4f} against the engine's "
              f"{s_per_round(eng):.4f} (ratio {s_per_round(res) / s_per_round(eng):.3f}) "
              f"round_s={[round(x, 4) for x in res['round_s']]} "
              f"{metric}={[round(x, 5) for x in res[metric]]} engine "
              f"{[round(x, 5) for x in eng[metric]]} "
              f"launches {launches} expected {expected}; "
              + " ".join(f"{k}={v}" for k, v in gates.items()), flush=True)
        bad = [k for k, v in gates.items() if v is False]
        if bad or launches != expected:
            fail(f"TRAIN-ORACLES {tag}: {bad} or launches {launches} != {expected}")
        for n in KERNELS:
            total[n] += launches[n]
        out[tag] = {"s_per_round": s_per_round(res), "engine_s_per_round": s_per_round(eng),
                    metric: res[metric], "launches": launches}

    # (a) the loop, synchronous
    cfg = train.pftt_config(args, method="pftt", verbose=False)
    eng = ENGINE_RUNS["pftt", "pftt"]
    res, launches = run_counted(lambda: run_pftt(dataclasses.replace(cfg, engine=False)))
    acc, loss = max_err(res["acc_per_round"], eng["acc_per_round"]), max_err(
        res["loss_per_round"], eng["loss_per_round"], rel=True)
    report("(a) pftt loop", res, eng, launches, pftt_expected(cfg, "pftt"), {
        "fused_engine_false": res["fused_engine"] is False,
        "bytes_and_delays_equal": ledger(res) == ledger(eng),
        f"acc_max_abs_err={acc:.4f}_within_{PFTT_ACC_TOL}": acc <= PFTT_ACC_TOL,
        f"loss_max_rel_err={loss:.2e}_within_{PFTT_LOSS_TOL:g}": loss <= PFTT_LOSS_TOL},
        "acc_per_round")

    # (b) the loop, robust (MIX, DL, staleness)
    cfg = robust_pftt_config()
    trained = int(cfg.fault_plan.realize(cfg.n_clients, cfg.rounds).train.sum())
    eng = ENGINE_RUNS["robust_pftt"]
    res, launches = run_counted(lambda: run_pftt(dataclasses.replace(cfg, engine=False)))
    acc, loss = max_err(res["acc_per_round"], eng["acc_per_round"]), max_err(
        res["loss_per_round"], eng["loss_per_round"], rel=True)
    report("(b) pftt loop MIX+DL", res, eng, launches, pftt_expected(cfg, "pftt", trained), {
        "records_equal": same_records(res["round_records"], eng["round_records"]),
        f"quorum_noops={res['quorum_noops']}_equal": res["quorum_noops"] == eng["quorum_noops"],
        f"delivered={[r.get('n_delivered') for r in res['round_records']]}_equal":
            [r.get("n_delivered") for r in res["round_records"]]
            == [r.get("n_delivered") for r in eng["round_records"]],
        "staleness_equal": res["staleness"] == eng["staleness"],
        f"acc_max_abs_err={acc:.4f}_within_{PFTT_ACC_TOL}": acc <= PFTT_ACC_TOL,
        f"loss_max_rel_err={loss:.2e}_within_{PFTT_LOSS_TOL:g}": loss <= PFTT_LOSS_TOL},
        "acc_per_round")

    # (c) PFIT's loop: the rollouts through decode_attn, client by client
    cfg = PFITConfig(method="pfit", **PFIT_QUICK)
    eng = ENGINE_RUNS["pfit", "pfit"]
    res, launches = run_counted(lambda: run_pfit(dataclasses.replace(cfg, engine=False)))
    rew = max_err(res["reward_per_round"], eng["reward_per_round"])
    report("(c) pfit loop", res, eng, launches, pfit_expected(cfg, "pfit"), {
        "fused_engine_false": res["fused_engine"] is False,
        "bytes_and_delays_equal": ledger(res) == ledger(eng),
        f"reward_max_abs_err={rew:.2e}_within_{PFIT_REWARD_TOL}": rew <= PFIT_REWARD_TOL},
        "reward_per_round")

    # (d) the merged path: W + s·A·B in every loss and eval, no lora_fused
    cfg = train.pftt_config(args, method="fedlora", verbose=False)
    eng = ENGINE_RUNS["pftt", "fedlora"]
    res, launches = run_counted(lambda: run_pftt(dataclasses.replace(cfg, factored=False)))
    acc = max_err(res["acc_per_round"], eng["acc_per_round"])
    expected = dict(pftt_expected(cfg, "fedlora"), lora_fused=0)
    report("(d) fedlora merged", res, eng, launches, expected, {
        "bytes_equal": [r["bytes"] for r in res["round_records"]]
                       == [r["bytes"] for r in eng["round_records"]],
        f"flash_attn_as_factored={eng['launches']['flash_attn']}":
            launches["flash_attn"] == eng["launches"]["flash_attn"],
        f"acc_max_abs_err={acc:.4f}_within_{PFTT_ACC_TOL}": acc <= PFTT_ACC_TOL},
        "acc_per_round")
    return total, out


COMMS_CODECS = ("int8", "int4", "sketch", "countsketch")
# TRAIN-COMMS (a)'s runs re-run on the CPU, cut (for the script's time:
# TRAIN-ORACLES) from all six: not the plain int8 and int4 runs.
# Their quantizer is held to the CPU at full width in (b) (symbols and
# scales), int4's run again under factored aggregation and robust under
# MIX+DL here; their card runs, launches and bounds stay
COMMS_CPU_TAGS = ("fedlora sketch", "fedlora countsketch", "fedlora int4+factored",
                  "pftt int4 MIX+DL")
COMMS_BITS_RTOL = 1e-6
# A quantizer's symbol is floor(x/scale + u): where x/scale + u lies within
# the card's and the CPU's f32 training difference of an integer, the two
# runs' symbols are one step apart, and each such flip moves a client's
# entropy charge by at most log2(n) + 2 bits.  Later client-rounds of a run
# under a quantizer are held to 1e-3 (tests/test_torch_comms_runs.py's
# FLIP_RTOL); the sketches and every first round that trains from the same
# state to COMMS_BITS_RTOL.
COMMS_FLIP_RTOL = 1e-3
COMMS_SVD_TOL = 1e-4
COMMS_SVD_CLIENTS, COMMS_SVD_RANK = 4, 8


def comms_pftt_configs():
    """TRAIN-COMMS (a)'s runs: fedlora under each codec and int4 with
    ``factored_agg`` at TRAIN-PFTT's launcher settings, and pftt with int4
    under TRAIN-ROBUST (a)'s flags."""
    from repro_torch.launch import train

    args = train.parse_args(["--arch", "roberta-base", "--fl-clients", "4",
                             "--fl-rounds", "3"])
    runs = [(f"fedlora {c}", train.pftt_config(args, method="fedlora", verbose=False,
                                               uplink_codec=c)) for c in COMMS_CODECS]
    runs.append(("fedlora int4+factored", train.pftt_config(
        args, method="fedlora", verbose=False, uplink_codec="int4", factored_agg=True)))
    runs.append(("pftt int4 MIX+DL", robust_pftt_config("--uplink-codec", "int4")))
    return runs


def rel_diffs(a, b):
    """Elementwise |a - b| / max(|b|, 1) of two nested lists of floats (NaN
    against NaN counts 0)."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    return np.where(np.isnan(a) & np.isnan(b), 0.0, d)


def train_comms_pftt(torch):
    """TRAIN-COMMS (a): ``run_pftt`` for each of ``comms_pftt_configs`` on
    the card, launches against ``pftt_expected`` (the trace's training
    client-rounds under the fault plan), then for ``COMMS_CPU_TAGS`` the
    same run on the CPU from the same init and the same uniforms (the default stream is
    counter-based, the same on both): each client-round's realized bits
    and each round's delay within COMMS_BITS_RTOL, or COMMS_FLIP_RTOL under
    a quantizer; the deadline run's deliveries and quorum no-ops equal;
    accuracies within PFTT_ACC_TOL; every realized size at most its
    ``payload_bits_upper_bound``.  Under ``factored_agg`` the card's and
    the CPU's runs part after the first aggregation: ``svd_reproject``
    returns the same product A'·B' from cuSOLVER and from LAPACK, but the
    signs of the singular vectors, and so the factors, are each library's
    own, and the clients' AdamW moments (kept across the broadcast) then
    train the two factorizations differently.  There only round 0 (bits
    and the accuracy of the first aggregate, which depends on the product
    alone) is held to the CPU; the later rounds are printed."""
    import numpy as np

    from repro_torch.core.pftt import run_pftt

    kernels = wrappers()
    total = {n: 0 for n in KERNELS}
    out = {}
    for tag, cfg in comms_pftt_configs():
        trained = (None if cfg.fault_plan is None else
                   int(cfg.fault_plan.realize(cfg.n_clients, cfg.rounds).train.sum()))
        for f in kernels.values():
            f.launches = 0
        card = run_pftt(cfg)
        launches = {n: f.launches for n, f in kernels.items()}
        expected = pftt_expected(cfg, cfg.method, trained)
        ub = card["uplink_bits"]
        bits = np.asarray(ub["realized"])
        under = bool((bits <= np.asarray(ub["upper_bound"])[None] * (1 + 1e-6)).all())
        s_round = sum(card["round_s"]) / len(card["round_s"])
        print(f"TRAIN-COMMS {tag:<22} s_per_round={s_round:.4f} "
              f"round_s={[round(x, 4) for x in card['round_s']]} "
              f"acc_per_round={[round(a, 4) for a in card['acc_per_round']]} "
              f"mean_round_bytes={card['mean_round_bytes']:.1f} "
              f"mean_round_delay_s={card['mean_round_delay_s']:.6f} "
              f"quorum_noops={card['quorum_noops']}", flush=True)
        print(f"TRAIN-COMMS {tag:<22} bits per client-round "
              f"{[[round(b, 1) for b in r] for r in ub['realized']]} upper_bound "
              f"{[round(b, 1) for b in ub['upper_bound']]} raw_tree_bytes_x8 "
              f"{[round(b, 1) for b in ub['raw']]} all_within_bound={under}", flush=True)
        print(f"TRAIN-COMMS {tag:<22} launches {launches} expected {expected}", flush=True)
        if launches != expected:
            fail(f"TRAIN-COMMS {tag}: kernel launches {launches} != expected {expected}")
        if not under:
            fail(f"TRAIN-COMMS {tag}: bits over the bound")
        bits_err, acc_err = None, None
        if tag not in COMMS_CPU_TAGS:
            print(f"TRAIN-COMMS {tag:<22} CPU re-run cut (COMMS_CPU_TAGS)", flush=True)
        else:
            t0 = time.perf_counter()
            cpu = run_pftt(dataclasses.replace(cfg, device="cpu"))
            cpu_s = time.perf_counter() - t0
            ub_cpu = cpu["uplink_bits"]
            held = 1 if cfg.factored_agg else cfg.rounds      # rounds held to the CPU
            bits_err = rel_diffs(ub["realized"][:held], ub_cpu["realized"][:held])
            delays = [[r["delay_s"] for r in res["round_records"][:held]] for res in (card, cpu)]
            delay_err = rel_diffs(*delays)
            tol = COMMS_FLIP_RTOL if cfg.uplink_codec.startswith("int") else COMMS_BITS_RTOL
            flags = [[(r.get("n_delivered"), r.get("quorum_noop")) for r in res["round_records"]]
                     for res in (card, cpu)]
            acc_err = max(abs(a - b) for a, b in zip(card["acc_per_round"][:held],
                                                     cpu["acc_per_round"][:held]))
            print(f"TRAIN-COMMS {tag:<22} CPU (plain versions, {cpu_s:.1f} s): "
                  f"acc_per_round={[round(a, 4) for a in cpu['acc_per_round']]} "
                  f"bits per client-round "
                  f"{[[round(b, 1) for b in r] for r in ub_cpu['realized']]} "
                  f"held rounds {held}: acc_max_abs_err={acc_err:.4f} (tol {PFTT_ACC_TOL}) "
                  f"bits_max_rel_err={bits_err.max():.2e} delay_max_rel_err={delay_err.max():.2e} "
                  f"(tol {tol:g}; client-rounds over {COMMS_BITS_RTOL:g}: "
                  f"{int((bits_err > COMMS_BITS_RTOL).sum())} of {bits_err.size}) "
                  f"deliveries_and_noops_equal={flags[0] == flags[1]}", flush=True)
            if (bits_err.max() > tol or delay_err.max() > tol or flags[0] != flags[1]
                    or acc_err > PFTT_ACC_TOL):
                fail(f"TRAIN-COMMS {tag}: card and CPU differ (bits {bits_err.max():.2e}, "
                     f"delays {delay_err.max():.2e}, flags equal {flags[0] == flags[1]}, acc "
                     f"{acc_err:.4f})")
        for n in KERNELS:
            total[n] += launches[n]
        out[tag] = dict(acc_per_round=card["acc_per_round"], round_s=card["round_s"],
                        mean_round_bytes=card["mean_round_bytes"],
                        mean_round_delay_s=card["mean_round_delay_s"],
                        quorum_noops=card["quorum_noops"], uplink_bits=ub,
                        bits_max_rel_err=None if acc_err is None else float(bits_err.max()),
                        cpu_acc_err=acc_err,
                        launches=launches)
    return total, out


def recount_bits(tree, rec, masks, qbits):
    """A float64 numpy recount of a quantizer's payload bits from its
    symbols: n·H over each coded leaf's weighted histogram, 16 bits per
    scale of a channel that sends, 32 per raw element that sends."""
    import numpy as np

    from repro_torch import trees
    total = 0.0
    wflat = trees.flatten(masks)
    for p, x in trees.flatten(tree).items():
        w = np.broadcast_to(wflat[p].cpu().numpy().astype(np.float64), tuple(x.shape))
        if p not in rec:
            total += w.sum() * 32
            continue
        sym = rec[p]["q"].cpu().numpy().astype(np.int64).ravel() + 2 ** qbits // 2
        hist = np.bincount(sym, weights=w.ravel(), minlength=2 ** qbits)
        n = hist.sum()
        pr = hist[hist > 0] / max(n, 1.0)
        total += -n * float((pr * np.log2(pr)).sum())
        scale, ind = rec[p]["scale"], w
        for ax, s in enumerate(scale.shape):
            if s == 1:
                ind = ind.max(axis=ax, keepdims=True)
        total += 16 * (float(ind.max() > 0) if scale.dim() == 0 else float((ind > 0).sum()))
    return total


def train_comms_ppo(torch, np):
    """TRAIN-COMMS (b): ``build_ppo_round(codec=int4)`` at gpt2-small's full
    width with TRAIN-ROBUST (c)'s model, masks and fixed reward (2 clients),
    against the codec-free round on the same inputs in turns (codec, none,
    codec, none, after an untimed warm-up of each), then one robust round
    with int4 (client 1 straggles: its bits 0).  On client 0's post-round
    params, coded against the round-input params under its mask, each
    codec's ``roundtrip`` is timed (CUDA events around the call, median of
    3; bincount sizes its output on the host, so the ms include that sync;
    int4's and count-sketch's calls profiled once) and its bits printed
    beside ``payload_bits_upper_bound`` and
    ``tree_bytes(nonzero_mask=mask)``·8.  Held: masked-out elements decode
    to the reference bit for bit (the quantizers, top-k: count-sketch's
    median decode writes every element, as in the JAX package, and the
    masked aggregation never reads them); the quantizers' scales equal a
    CPU roundtrip's of the same tensors and uniforms and their symbols
    differ by one step on at most 1e-6 of the elements; the bits within
    COMMS_BITS_RTOL of a float64 numpy recount from the symbols; the
    default uniform stream equal on the card and the CPU over the largest
    leaf."""
    from repro_torch import trees
    from repro_torch.comms import codec as codec_mod
    from repro_torch.comms import streams
    from repro_torch.configs import get_config
    from repro_torch.core import cohort
    from repro_torch.core.pfit import PFITConfig
    from repro_torch.models import peft
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw
    from repro_torch.rlhf import ppo, rollout
    from repro_torch.wireless import tree_bytes

    cfg = get_config("gpt2-small")
    L, n = cfg.n_layers, 2
    kernels = wrappers()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator().manual_seed(0))
    params["value_head"] = torch.zeros(cfg.d_model, 1, device="cuda")
    masks = trees.stack([trees.map_leaves(
        lambda a, b: a * b, peft.last_k_layers_mask(params, cfg, 2),
        peft.head_sparsity_mask(params, cfg, 0.4, seed=ci)) for ci in range(n)])
    opt = adamw(PFITConfig.lr)
    prompts = torch.from_numpy(np.random.RandomState(0).randint(
        6, cfg.vocab_size, size=(n, PPO_BATCH, PPO_PROMPT))).cuda()
    reward = torch.from_numpy(np.random.RandomState(1).randn(PPO_BATCH).astype(np.float32)).cuda()
    int4 = codec_mod.get_codec("int4")

    def build(**kw):
        return cohort.build_ppo_round(model, opt, ppo.PPOConfig(), PPO_PROMPT, PPO_GEN,
                                      lambda *a: reward, **kw)

    def noises(rnd):
        return [rollout.gumbel_stream(0, rnd * 17 + ci, PPO_GEN, PPO_BATCH, cfg.vocab_size,
                                      "cuda") for ci in range(n)]

    def uniforms(rnd):
        return codec_mod.round_noises(
            functools.partial(codec_mod.codec_uniforms, 0, device="cuda"), rnd, n)

    def fresh():
        return (trees.stack([params] * n), trees.stack([opt.init(params)] * n),
                trees.map_leaves(torch.clone, params))

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    alphas = ([0.5] * n, [0.5] * n)
    one = torch.ones(n, device="cuda")
    steps = {True: build(codec=int4), False: build()}

    def run(coded):
        extra = (uniforms(0),) if coded else ()
        return timed(steps[coded], *fresh(), masks, prompts, noises(0), *alphas, one, *extra)

    run(True)                                                 # warm-ups
    run(False)
    for f in kernels.values():
        f.launches = 0
    round_ms = {True: [], False: []}
    coded_out = None
    for coded in (True, False, True, False):
        res, ms = run(coded)
        round_ms[coded].append(ms)
        if coded:
            coded_out = res
        del res
    bits = coded_out[-1].tolist()
    robust = build(robust=True, codec=int4)
    st, so, glob = fresh()
    vec = functools.partial(torch.tensor, dtype=torch.float32, device="cuda")
    rout, robust_ms = timed(robust, st, so, glob, trees.map_leaves(torch.zeros_like, st), masks,
                            prompts, noises(1), *alphas, vec([1.0, 0.5]), vec([1, 0]),
                            vec([0, 0]), vec([0, 0]), vec([1, 1]), uniforms(1))
    robust_bits = rout[-1].tolist()
    del rout, st, so, glob
    launches = {k: f.launches for k, f in kernels.items()}
    cr = 4 * n + 1            # client-rounds that trained: 4 rounds, then 1 robust
    expected = {k: 0 for k in KERNELS}
    expected.update(flash_attn=cr * 5 * L, decode_attn=cr * L * PPO_GEN)
    print(f"TRAIN-COMMS ppo gpt2-small full width, {n} clients, batch {PPO_BATCH}, prompt "
          f"{PPO_PROMPT}, gen {PPO_GEN}: int4_round_ms={[round(x, 1) for x in round_ms[True]]} "
          f"plain_round_ms={[round(x, 1) for x in round_ms[False]]} (same inputs, in turns "
          f"int4, plain, int4, plain) int4_bits={[round(b, 1) for b in bits]} "
          f"robust_int4_round_ms={robust_ms:.1f} robust_bits={[round(b, 1) for b in robust_bits]} "
          f"(client 1 straggles)", flush=True)
    print(f"TRAIN-COMMS ppo launches {launches} expected {expected}", flush=True)
    if launches != expected or robust_bits[1] != 0 or not robust_bits[0] > 0 or min(bits) <= 0:
        fail(f"TRAIN-COMMS ppo: launches {launches} != {expected}, or bits {bits} / robust "
             f"{robust_bits} wrong")

    post = cohort.client_view(coded_out[0], 0)
    m0 = cohort.client_view(masks, 0)
    to_cpu = functools.partial(trees.map_leaves, lambda v: v.cpu())
    post_cpu, ref_cpu, m0_cpu = to_cpu(post), to_cpu(params), to_cpu(m0)
    raw_bits = tree_bytes(post, nonzero_mask=m0) * 8
    rows, ok = {}, True
    for name in COMMS_CODECS:
        c = codec_mod.get_codec(name)
        u_card = {}

        def hook(leaf, shape):
            u_card[leaf] = codec_mod.codec_uniforms(0, 0, 0, leaf, shape, "cuda")
            return u_card[leaf]

        times, rec = [], {}
        for i in range(4):                                    # a warm-up, then 3
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            dec, b = codec_mod.roundtrip(c, post, ref=params, bit_weights=m0, noise=hook,
                                         record=rec if i == 3 else None)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = sorted(times[1:])[1]
        if name in ("int4", "countsketch"):       # where a roundtrip's time goes
            profile(torch, f"TRAIN-COMMS roundtrip {name}", lambda: codec_mod.roundtrip(
                c, post, ref=params, bit_weights=m0, noise=hook), 1)
        b = float(b)
        ub = codec_mod.payload_bits_upper_bound(c, post)
        row = dict(ms=ms, bits=b, upper_bound=ub, raw_bits=raw_bits)
        flat_d, flat_r, flat_m = (trees.flatten(t) for t in (dec, params, m0))
        kept = None
        if name != "countsketch":
            kept = all(torch.equal(v[torch.broadcast_to(flat_m[p], v.shape) == 0],
                                   flat_r[p][torch.broadcast_to(flat_m[p], v.shape) == 0])
                       for p, v in flat_d.items())
            ok &= kept
        row["masked_out_equal_ref"] = kept
        if name.startswith("int"):
            rec_cpu = {}
            _, b_cpu = codec_mod.roundtrip(c, post_cpu, ref=ref_cpu, bit_weights=m0_cpu,
                                           noise=lambda leaf, shape: u_card[leaf].cpu(),
                                           record=rec_cpu)
            n_el = sum(e["q"].numel() for e in rec.values())
            steps_apart = sum(int((rec[p]["q"].cpu().int() - e["q"].int()).abs().gt(0).sum())
                              for p, e in rec_cpu.items())
            worst = max(int((rec[p]["q"].cpu().int() - e["q"].int()).abs().max())
                        for p, e in rec_cpu.items())
            scales_eq = all(torch.equal(rec[p]["scale"].cpu(), e["scale"])
                            for p, e in rec_cpu.items())
            recount = recount_bits(post, rec, m0, c.qbits)
            bits_rel = abs(b - recount) / recount
            row.update(cpu_bits=float(b_cpu), one_step_elements=steps_apart,
                       coded_elements=n_el, recount_bits=recount, bits_vs_recount=bits_rel)
            ok &= (scales_eq and worst <= 1 and steps_apart <= 1e-6 * n_el
                   and bits_rel <= COMMS_BITS_RTOL)
            print(f"TRAIN-COMMS roundtrip {name}: CPU bits {float(b_cpu):.1f} "
                  f"scales_equal={scales_eq} symbols one step apart {steps_apart} of {n_el} "
                  f"(max step {worst}; limit {1e-6 * n_el:.1f}) float64 recount "
                  f"{recount:.1f} rel_err={bits_rel:.2e} (tol {COMMS_BITS_RTOL:g})", flush=True)
        rows[name] = row
        n_all = sum(v.numel() for v in flat_d.values())
        print(f"TRAIN-COMMS roundtrip {name:<11} client 0 post-round ({n_all} elements, "
              f"{raw_bits / 32 / n_all:.4f} of them under the mask): "
              f"ms={ms:.2f} (of {[round(t, 2) for t in times]}) bits={b:.1f} "
              f"upper_bound={ub:.1f} tree_bytes_masked_x8={raw_bits:.1f} "
              f"masked_out_equal_ref={kept}", flush=True)
        del dec, u_card
    big = max(trees.flatten(post).items(), key=lambda kv: kv[1].numel())
    key = streams.stream_key(0, codec_mod.CODEC_STREAM, 0, 0, 0)
    same_u = torch.equal(streams.uniforms(key, big[1].shape, "cuda").cpu(),
                         streams.uniforms(key, big[1].shape, "cpu"))
    print(f"TRAIN-COMMS uniforms of {big[0]} {tuple(big[1].shape)} card == CPU: {same_u}",
          flush=True)
    if not (ok and same_u):
        fail(f"TRAIN-COMMS roundtrip checks failed: {rows}, uniforms equal {same_u}")
    return launches, dict(int4_round_ms=round_ms[True], plain_round_ms=round_ms[False],
                          int4_bits=bits, robust_int4_round_ms=robust_ms,
                          robust_bits=robust_bits, roundtrip=rows, launches=launches)


def train_comms_svd(torch, np):
    """TRAIN-COMMS (c): ``factored_fedavg_tree`` over roberta-base's
    full-width LoRA (4 clients, rank 8 on wq and wv of 12 layers: A (4, 12,
    768, 8), B (4, 12, 8, 768) each, numpy seed 2, weights 1, 2, 0.5, 1)
    against ``dense_rank_r_oracle``: each pair's A'·B' within COMMS_SVD_TOL
    of the oracle, relative to its largest element; both timed on CUDA
    events (the re-projection the median of 5 after a warm-up; the O(d³)
    oracle, 2 s a call on an H100 80GB HBM3, one call after it)."""
    from repro_torch import trees
    from repro_torch.comms import factored_agg
    from repro_torch.configs import get_config

    cfg = get_config("roberta-base")
    rng = np.random.RandomState(2)
    n, r, d, reps = COMMS_SVD_CLIENTS, COMMS_SVD_RANK, cfg.d_model, cfg.n_layers

    def rn(*shape):
        return torch.from_numpy((rng.randn(*shape) * 0.05).astype(np.float32)).cuda()

    up = {w: {"a": rn(n, reps, d, r), "b": rn(n, reps, r, d)} for w in ("wq", "wv")}
    w = torch.tensor([1.0, 2.0, 0.5, 1.0], device="cuda")

    def event_ms(fn, reps):
        times = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            res = fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return res, sorted(times)[reps // 2]

    factored_agg.factored_fedavg_tree(up, w)                 # warm-up
    agg, svd_ms = event_ms(lambda: factored_agg.factored_fedavg_tree(up, w), 5)
    dense, dense_ms = event_ms(lambda: {k: factored_agg.dense_rank_r_oracle(v["a"], v["b"], w)
                                        for k, v in up.items()}, 1)
    errs = {k: float((agg[k]["a"] @ agg[k]["b"] - dense[k]).abs().max()
                     / dense[k].abs().max()) for k in up}
    print(f"TRAIN-COMMS svd_reproject roberta-base full width: {n} clients, rank {r}, "
          f"A {tuple(up['wq']['a'].shape)} B {tuple(up['wq']['b'].shape)} on wq and wv: "
          f"factored_ms={svd_ms:.3f} dense_oracle_ms={dense_ms:.3f} "
          f"rel_err={ {k: f'{e:.2e}' for k, e in errs.items()} } (tol {COMMS_SVD_TOL:g})",
          flush=True)
    if max(errs.values()) > COMMS_SVD_TOL or set(trees.flatten(agg)) != set(trees.flatten(up)):
        fail(f"TRAIN-COMMS svd_reproject: product error {errs} over {COMMS_SVD_TOL}")
    return dict(factored_ms=svd_ms, dense_oracle_ms=dense_ms, rel_err=errs)


def train_comms(torch, np):
    """TRAIN-COMMS (a)–(c); its launches are (a)'s and (b)'s."""
    got_a, pftt_rows = train_comms_pftt(torch)
    got_b, ppo_row = train_comms_ppo(torch, np)
    svd_row = train_comms_svd(torch, np)
    return ({k: got_a[k] + got_b[k] for k in KERNELS},
            dict(pftt=pftt_rows, ppo=ppo_row, svd=svd_row))


# ---------------------------------------------------------------- population
POP_FLAGS = ["--arch", "roberta-base", "--population", "256", "--cohort", "8",
             "--sampler", "availability", "--scenario", "avail=diurnal,avail_period=6,seed=1",
             "--fault-plan", "straggle_p=0.3,max_straggle=2,seed=2",
             "--staleness-a", "0.5", "--max-staleness", "2"]   # docs/ci.md's cell
POP_ROUNDS, POP_LONG, POP_CUT = 2, 4, 2
POP_HEALTH_RTOL = 1e-3        # card against CPU re-run
POP_STREAM_TOL = 1e-5         # a resumed stream's floats, when not byte-equal
POP_ORACLE_RTOL = 1e-4        # health against the float64 host oracle
POP_SHEPHERD = dict(PFIT_QUICK, rounds=2)
POP_FULL = dict(population=64, cohort=4, rounds=4, local_steps=2, batch=8, seq=32, rank=8)
POP_HEALTH_REPS = 20          # timed calls of cohort_health alone a round


def pop_trained(cfg, cohorts):
    """The client-rounds that train in a population run: each round's
    sampled clients that the fault trace lets train and the scenario's
    availability trace shows reachable (the port's copies of both)."""
    pop = cfg.population
    trace = cfg.fault_plan.realize(pop.population, cfg.rounds)
    avail = pop.scenario.realize(pop.population, cfg.rounds)
    return int(sum((trace.train[r, ids] * avail.avail_round(r)[ids]).sum()
                   for r, ids in enumerate(cohorts)))


def rel_close(a, b, rtol):
    return abs(a - b) <= rtol * abs(b) + 1e-7


def health_close(card, cpu, rtol):
    """Largest relative difference over every round's health scalars, and
    whether each is within ``rtol``."""
    errs = [abs(h1[k] - h2[k]) / max(abs(h2[k]), 1e-7) for h1, h2 in zip(card, cpu) for k in h1]
    ok = all(rel_close(h1[k], h2[k], rtol) for h1, h2 in zip(card, cpu) for k in h1)
    return max(errs, default=0.0), ok


def check_telemetry(tag, tele_dir, rounds):
    """The stream validates, ``report --check`` exits 0, ``trace.json``
    parses and every span of a round lies inside that round's ``round``
    span, and each round event carries the seven health scalars."""
    from repro_torch.launch import report
    from repro_torch.obs import HEALTH_KEYS, read_events, validate_events

    events = read_events(os.path.join(tele_dir, "events.jsonl"))
    errors = validate_events(events)
    rounds_ev = [e for e in events if e["event"] == "round"]
    health_ok = len(rounds_ev) == rounds and all(
        set(e["health"]) == set(HEALTH_KEYS)
        and all(isinstance(v, float) for v in e["health"].values()) for e in rounds_ev)
    with contextlib.redirect_stdout(io.StringIO()) as out:   # its table
        rc = report.main([tele_dir, "--check"])
    check_line = out.getvalue().strip().splitlines()[-1]
    with open(os.path.join(tele_dir, "trace.json")) as f:
        spans = json.load(f)["traceEvents"]
    outer = [(s["ts"], s["ts"] + s["dur"]) for s in spans if s["name"] == "round"]
    inner = [s for s in spans if s["name"] not in ("round", "eval", "checkpoint")]
    nested = len(outer) == rounds and all(
        any(a <= s["ts"] and s["ts"] + s["dur"] <= b for a, b in outer) for s in inner)
    print(f"{tag} telemetry: {len(events)} events, validate_events errors {errors}, "
          f"report --check rc {rc} ({check_line}), trace.json {len(spans)} spans nested {nested}, "
          f"health scalars in every round event {health_ok}", flush=True)
    if errors or rc != 0 or not nested or not health_ok:
        fail(f"{tag}: telemetry errors {errors}, report rc {rc}, nested {nested}, "
             f"health {health_ok}")
    return events


def streams_match(a, b):
    """'bytes' when two canonical streams are equal byte for byte, 'floats'
    when they differ only in floats within POP_STREAM_TOL, else None."""
    if a == b:
        return "bytes"
    import numpy as np
    la, lb = [json.loads(x) for x in a], [json.loads(x) for x in b]

    def walk(x, y):
        if isinstance(x, dict):
            return isinstance(y, dict) and x.keys() == y.keys() and all(
                walk(x[k], y[k]) for k in x)
        if isinstance(x, list):
            return isinstance(y, list) and len(x) == len(y) and all(
                walk(u, v) for u, v in zip(x, y))
        if isinstance(x, float) and isinstance(y, (int, float)):
            return bool(np.isclose(x, y, rtol=0, atol=POP_STREAM_TOL))
        return x == y

    return "floats" if len(la) == len(lb) and walk(la, lb) else None


def train_pop_pftt(torch):
    """TRAIN-POP (a) and (b): ``launch/train.py``'s population PFTT
    (``--population 256 --cohort 8`` under docs/ci.md's availability and
    straggler flags, the launcher's 50 pretraining and 5 local steps, batch
    8, seed 0, f32) for 2 rounds with ``--telemetry-dir D --trace``:
    seconds and host ms a round, the store's MB, launches against
    ``pftt_expected`` over the client-rounds that train; the telemetry
    checks; a CPU re-run from the same init (cohorts, bytes and delays
    equal, accuracies within PFTT_ACC_TOL, health within POP_HEALTH_RTOL).
    Then (b): 4 rounds uninterrupted, 2 with a checkpoint and a resume to 4
    into the same telemetry directory: ledger, cohorts and tracker equal,
    canonical streams equal byte for byte or within POP_STREAM_TOL, no
    round event twice."""
    import tempfile

    from repro_torch.core.pftt import run_pftt
    from repro_torch.launch import train
    from repro_torch.obs import TelemetryConfig, canonical_stream, read_events

    kernels = wrappers()
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "a")
        args = train.parse_args(POP_FLAGS + ["--fl-rounds", str(POP_ROUNDS),
                                             "--telemetry-dir", d, "--trace"])
        cfg = train.pftt_config(args, verbose=False)
        for f in kernels.values():
            f.launches = 0
        card = run_pftt(cfg)
        launches = {n: f.launches for n, f in kernels.items()}
        trained = pop_trained(cfg, card["cohorts"])
        expected = pftt_expected(cfg, "pftt", trained)
        rounds = len(card["round_wall"])
        print(f"TRAIN-POP (a) pftt population {cfg.population.population} cohort "
              f"{cfg.population.cohort_size} x {rounds} rounds ({trained} client-rounds "
              f"train): pretrain_s={card['pretrain_s']:.3f} "
              f"s_per_round={card['round_s'] / rounds:.4f} "
              f"round_wall={[round(x, 4) for x in card['round_wall']]} "
              f"host_ms_per_round={card['host_s'] / rounds * 1e3:.3f} "
              f"host_overhead_frac={card['host_overhead_frac']:.4f} "
              f"store_MB={card['store_bytes'] / 1e6:.3f} "
              f"acc_per_round={[round(a, 4) for a in card['acc_per_round']]} "
              f"cohorts={card['cohorts']} staleness={card['staleness']}", flush=True)
        print(f"TRAIN-POP (a) launches {launches} expected {expected}", flush=True)
        if launches != expected:
            fail(f"TRAIN-POP (a): kernel launches {launches} != expected {expected}")
        events = check_telemetry("TRAIN-POP (a)", d, POP_ROUNDS)
        phases = [e["wall"]["phases"] for e in events if e["event"] == "round"]
        print(f"TRAIN-POP (a) phases per round (s): {phases}", flush=True)

        t0 = time.perf_counter()
        cpu = run_pftt(dataclasses.replace(cfg, device="cpu", telemetry=TelemetryConfig(
            out_dir=os.path.join(tmp, "a_cpu"))))
        cpu_s = time.perf_counter() - t0
        ledger_ok = same_records(cpu["round_records"], card["round_records"])
        acc_err = max(abs(a - b) for a, b in zip(card["acc_per_round"], cpu["acc_per_round"]))
        h_err, h_ok = health_close(card["health_per_round"], cpu["health_per_round"],
                                   POP_HEALTH_RTOL)
        cohorts_ok = cpu["cohorts"] == card["cohorts"]
        print(f"TRAIN-POP (a) CPU (plain versions, {cpu_s:.1f} s): cohorts_equal={cohorts_ok} "
              f"bytes_and_delays_equal={ledger_ok} "
              f"acc_per_round={[round(a, 4) for a in cpu['acc_per_round']]} "
              f"acc_max_abs_err={acc_err:.4f} (tol {PFTT_ACC_TOL}) "
              f"health_max_rel_err={h_err:.2e} (tol {POP_HEALTH_RTOL:g})", flush=True)
        print(f"TRAIN-POP (a) health card {card['health_per_round']}", flush=True)
        if not (cohorts_ok and ledger_ok and h_ok) or acc_err > PFTT_ACC_TOL:
            fail(f"TRAIN-POP (a): card and CPU differ (cohorts {cohorts_ok}, ledger "
                 f"{ledger_ok}, acc {acc_err:.4f}, health {h_err:.2e})")

        # (b) kill after POP_CUT rounds, resume to POP_LONG
        full_d, kill_d, ck = (os.path.join(tmp, x) for x in ("full", "killed", "ck"))
        long_cfg = dataclasses.replace(cfg, rounds=POP_LONG, telemetry=TelemetryConfig(
            out_dir=full_d))
        full = run_pftt(long_cfg)
        kill_cfg = dataclasses.replace(long_cfg, ckpt_dir=ck, telemetry=TelemetryConfig(
            out_dir=kill_d))
        run_pftt(dataclasses.replace(kill_cfg, rounds=POP_CUT))
        resumed = run_pftt(dataclasses.replace(kill_cfg, resume=True))
        ev_full = read_events(os.path.join(full_d, "events.jsonl"))
        ev_res = read_events(os.path.join(kill_d, "events.jsonl"))
        round_ids = [e["round"] for e in ev_res if e["event"] == "round"]
        no_dup = round_ids == list(range(POP_LONG))
        how = streams_match(canonical_stream(ev_res), canonical_stream(ev_full))
        ledger_ok = same_records(resumed["round_records"], full["round_records"])
        cohorts_ok = resumed["cohorts"] == full["cohorts"]
        tracker_ok = resumed["staleness"] == full["staleness"]
        print(f"TRAIN-POP (b) kill after {POP_CUT} rounds and resume to {POP_LONG}: "
              f"ledger_equal={ledger_ok} cohorts_equal={cohorts_ok} "
              f"tracker_equal={tracker_ok} ({resumed['staleness']}) "
              f"canonical_streams_equal={how} round events {round_ids} "
              f"resume events {sum(e['event'] == 'resume' for e in ev_res)} "
              f"acc_per_round={[round(a, 4) for a in resumed['acc_per_round']]} "
              f"uninterrupted={[round(a, 4) for a in full['acc_per_round']]}", flush=True)
        if not (ledger_ok and cohorts_ok and tracker_ok and no_dup and how):
            fail(f"TRAIN-POP (b): ledger {ledger_ok} cohorts {cohorts_ok} tracker "
                 f"{tracker_ok} no duplicate {no_dup} streams {how}")
    row = {k: card[k] for k in ("acc_per_round", "round_wall", "round_s", "host_s",
                                "host_overhead_frac", "store_bytes", "pretrain_s", "cohorts",
                                "health_per_round", "staleness")}
    return launches, dict(row, launches=launches, trained=trained, cpu_acc_err=acc_err,
                          cpu_health_rel_err=h_err, resume_stream=how)


def shepherd_pop_expected(cfg, trained):
    """Each kernel's launches in one shepherd population run: ``flash_attn``
    once a layer per forward of the policy and ``lora_fused`` on wq and wv
    per forward with LoRA — the pretraining steps (no LoRA), the local
    steps of the client-rounds that train, one evaluation forward per
    sampled client and round.  No generation: population rounds are scored
    by LM loss."""
    L = cfg.n_layers
    fwd = trained * cfg.shepherd_steps + cfg.rounds * cfg.population.cohort_size
    return {"lora_fused": 2 * L * fwd, "flash_attn": L * (cfg.pretrain_steps + fwd),
            "decode_attn": 0, "block_sparse_attn": 0, "ssd_chunk": 0}


def train_pop_shepherd(torch):
    """TRAIN-POP (c): ``run_pfit(method="shepherd")`` at TRAIN-PFIT's quick
    profile with a population of 64 and a cohort of 4 (uniform sampling),
    2 rounds, telemetry with health: seconds a round, launches against
    ``shepherd_pop_expected``; a CPU re-run (ledger and cohorts equal, the
    evaluation losses within PFIT_REWARD_TOL, health within
    POP_HEALTH_RTOL)."""
    import tempfile

    from repro_torch.core.pfit import PFITConfig, run_pfit
    from repro_torch.fl import PopulationConfig
    from repro_torch.obs import TelemetryConfig

    kernels = wrappers()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = PFITConfig(method="shepherd", population=PopulationConfig(
            population=64, cohort_size=4), telemetry=TelemetryConfig(
                out_dir=os.path.join(tmp, "card"), trace=True), **POP_SHEPHERD)
        for f in kernels.values():
            f.launches = 0
        card = run_pfit(cfg)
        launches = {n: f.launches for n, f in kernels.items()}
        expected = shepherd_pop_expected(cfg, cfg.rounds * cfg.population.cohort_size)
        print(f"TRAIN-POP (c) shepherd population 64 cohort 4 x {cfg.rounds} rounds: "
              f"pretrain_s={card['pretrain_s']:.3f} "
              f"s_per_round={card['round_s'] / cfg.rounds:.4f} "
              f"round_wall={[round(x, 4) for x in card['round_wall']]} "
              f"host_ms_per_round={card['host_s'] / cfg.rounds * 1e3:.3f} "
              f"store_MB={card['store_bytes'] / 1e6:.3f} "
              f"eval_loss_per_round={[round(x, 5) for x in card['eval_loss_per_round']]} "
              f"cohorts={card['cohorts']}", flush=True)
        print(f"TRAIN-POP (c) launches {launches} expected {expected}", flush=True)
        if launches != expected:
            fail(f"TRAIN-POP (c): kernel launches {launches} != expected {expected}")
        check_telemetry("TRAIN-POP (c)", cfg.telemetry.out_dir, cfg.rounds)
        t0 = time.perf_counter()
        cpu = run_pfit(dataclasses.replace(cfg, device="cpu", telemetry=TelemetryConfig(
            out_dir=os.path.join(tmp, "cpu"))))
        cpu_s = time.perf_counter() - t0
    ledger_ok = same_records(cpu["round_records"], card["round_records"])
    cohorts_ok = cpu["cohorts"] == card["cohorts"]
    err = max(abs(a - b) for a, b in zip(card["eval_loss_per_round"],
                                         cpu["eval_loss_per_round"]))
    h_err, h_ok = health_close(card["health_per_round"], cpu["health_per_round"],
                               POP_HEALTH_RTOL)
    print(f"TRAIN-POP (c) CPU (plain versions, {cpu_s:.1f} s): ledger_equal={ledger_ok} "
          f"cohorts_equal={cohorts_ok} "
          f"eval_loss_per_round={[round(x, 5) for x in cpu['eval_loss_per_round']]} "
          f"max_abs_err={err:.2e} (tol {PFIT_REWARD_TOL}) health_max_rel_err={h_err:.2e}",
          flush=True)
    if not (ledger_ok and cohorts_ok and h_ok) or err > PFIT_REWARD_TOL:
        fail(f"TRAIN-POP (c): ledger {ledger_ok} cohorts {cohorts_ok} eval loss {err:.2e} "
             f"health {h_err:.2e}")
    row = {k: card[k] for k in ("eval_loss_per_round", "round_wall", "round_s", "host_s",
                                "store_bytes", "pretrain_s", "health_per_round")}
    return launches, dict(row, launches=launches, cpu_eval_loss_err=err)


def train_pop_full(torch, np, device="cuda", arch_cfg=None):
    """TRAIN-POP (d): the robust supervised body with ``health=True`` at
    roberta-base's full width and depth (12 layers, d 768, rank-8 LoRA on
    wq/wv, adapters frozen, TRAIN-ROBERTA's MLM loss at batch 8, sequence
    32, 2 local steps) driven by ``PopulationRunner`` from a
    ``PopulationStore`` of 64 fedlora clients (the LoRA uploaded), cohort 4,
    4 rounds, under TRAIN-POP (a)'s straggler plan.  Each round the body is
    also run with ``health=False`` on copies of the same inputs, the two in
    turns: the state, pending payloads and losses must be equal bit for
    bit.  Each round's health scalars are held against ``host_health`` in
    float64 on that round's own tensors within POP_ORACLE_RTOL; the rows the
    round did not sample must be unchanged bit for bit.  ``cohort_health``
    alone on the round's tensors is timed (mean of POP_HEALTH_REPS calls).
    Launches are read before and after each health-on call and summed; they
    must equal 2·L (``lora_fused``) and L (``flash_attn``) launches for each
    local step of a client-round that trains, and the health-off runs',
    counted apart, the same."""
    from repro_torch import synchronize, trees
    from repro_torch.comms import ChannelBudget
    from repro_torch.configs import get_config
    from repro_torch.core.cohort import HostBatchStacker, build_supervised_round
    from repro_torch.core.robust import StalenessConfig, StalenessTracker
    from repro_torch.data import SPECIAL
    from repro_torch.fl import (ClientSampler, PopulationConfig, PopulationRunner,
                                PopulationStore, stacked_client_init)
    from repro_torch.models import peft
    from repro_torch.models.transformer import Model
    from repro_torch.obs import SpanTracer, cohort_health, host_health
    from repro_torch.optim import adamw, value_and_grad
    from repro_torch.wireless import CommLedger, FaultPlan, RayleighChannel, tree_bytes
    from repro_torch.wireless.scenarios import Scenario

    P = POP_FULL
    dev = torch.device(device)
    mcfg = arch_cfg or get_config("roberta-base")
    model = Model(mcfg, device=dev)
    gen = torch.Generator().manual_seed(0)
    pcfg = peft.PEFTConfig(lora_rank=P["rank"], lora_targets=("mixer/wq", "mixer/wv"))
    frozen = peft.init_adapters(gen, model.init(gen, max_seq=P["seq"]), mcfg, pcfg)
    scale = peft.lora_scale(pcfg)
    opt = adamw(1e-3)

    def client_init(i):
        lora = peft.init_lora(torch.Generator().manual_seed(1000 + i), frozen, pcfg)
        t = {"lora": lora}
        return {"t": t, "o": opt.init(t)}

    stacked = stacked_client_init(client_init, P["population"])
    store = PopulationStore({"trainable": stacked["t"], "opt": stacked["o"],
                             "pending": trees.map_leaves(np.zeros_like, stacked["t"])})

    def local_step(t, op, batch):
        loss, g = value_and_grad(
            lambda tt: model.lm_loss(frozen, batch, lora=tt["lora"], lora_scale=scale), t)
        upd, op = opt.update(g, op, t)
        return trees.tree_add(t, upd), op, loss

    def draw(cid, rnd):
        rng = np.random.RandomState(cid * 1009 + rnd)
        out = []
        for _ in range(P["local_steps"]):
            toks = rng.randint(6, mcfg.vocab_size, size=(P["batch"], P["seq"]))
            mpos = rng.rand(P["batch"], P["seq"]) < 0.15
            out.append({"tokens": np.where(mpos, SPECIAL["mask"], toks), "labels": toks,
                        "mask": mpos.astype(np.float32)})
        return out

    on = build_supervised_round(local_step, robust=True, health=True)
    off = build_supervised_round(local_step, robust=True, health=False)
    kernels = wrappers()
    log = {"on_ms": [], "off_ms": [], "health_ms": [], "oracle_err": [], "bitwise": [],
           "on_launches": dict.fromkeys(KERNELS, 0), "off_launches": dict.fromkeys(KERNELS, 0)}

    def clone(tree):
        return trees.map_leaves(lambda x: x.clone(), tree)

    def counted(step, args, launches):
        """One call of a body, timed; its launches added to ``launches``."""
        before = {n: kernels[n].launches for n in KERNELS}
        synchronize(dev)
        t0 = time.perf_counter()
        outs = step(*args)
        synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        for n in KERNELS:
            launches[n] += kernels[n].launches - before[n]
        return outs, ms

    def step(tr, op, pend, batches, train_m, agg_w, recv_m, rejoin_m, ontime_m):
        """The health-on body, with the health-off body on copies of the same
        inputs beside it (in turns), and the float64 oracle."""
        up_in = clone(tr)
        args = [tr, op, pend, batches, train_m, agg_w, recv_m, rejoin_m, ontime_m]
        copies = [clone(tr), clone(op), clone(pend), batches, train_m, agg_w, recv_m,
                  rejoin_m, ontime_m]
        first_off = len(log["on_ms"]) % 2 == 1
        if first_off:
            outs_off, ms_off = counted(off, copies, log["off_launches"])
        outs, ms_on = counted(on, args, log["on_launches"])
        if not first_off:
            outs_off, ms_off = counted(off, copies, log["off_launches"])
        log["on_ms"].append(ms_on)
        log["off_ms"].append(ms_off)
        same = all(torch.equal(a, b) for a, b in zip(
            (x for o in outs[:4] for x in trees.flatten(o).values()),
            (x for o in outs_off for x in trees.flatten(o).values())))
        log["bitwise"].append(same)
        w = agg_w * ontime_m
        gate = float(w.sum() > 0)
        synchronize(dev)     # cohort_health alone on this round's tensors
        t0 = time.perf_counter()
        for _ in range(POP_HEALTH_REPS):
            cohort_health(outs[2], up_in, outs[3], w, w.sum() > 0, train_m=train_m)
        synchronize(dev)
        log["health_ms"].append((time.perf_counter() - t0) * 1e3 / POP_HEALTH_REPS)
        oracle = host_health(outs[2], up_in, outs[3], w, gate, train_m=train_m)
        hs = {k: float(v) for k, v in outs[-1].items()}
        log["oracle_err"].append(max(abs(hs[k] - oracle[k]) / max(abs(oracle[k]), 1e-7)
                                     for k in hs))
        log.setdefault("oracle_ok", []).append(all(rel_close(hs[k], oracle[k], POP_ORACLE_RTOL)
                                                   for k in hs))
        return outs

    pop = PopulationConfig(population=P["population"], cohort_size=P["cohort"])
    channel = RayleighChannel(seed=0)
    plan = FaultPlan(straggle_p=0.3, max_straggle=2, seed=2)
    tracker = StalenessTracker(P["population"], StalenessConfig(a=0.5, max_staleness=2))
    tracer = SpanTracer()
    runner = PopulationRunner(
        pop=pop, store=store, global_shared=trees.map_leaves(np.array, store.row("trainable", 0)),
        upload_pred=lambda p: True, channel=channel, budget=ChannelBudget(channel),
        ledger=CommLedger(), tracker=tracker,
        trace=plan.realize(P["population"], P["rounds"]),
        strace=Scenario().realize(P["population"], P["rounds"]),
        sampler=ClientSampler("uniform", P["population"], P["cohort"], seed=0),
        device=dev, tracer=tracer, health=True)
    payload_bits = tree_bytes(trees.map_leaves(torch.from_numpy, store.row("trainable", 0))) * 8
    stacker = HostBatchStacker(dev)
    unsampled_ok, gather_ms, scatter_ms = [], [], []
    trained = 0
    for rnd in range(P["rounds"]):
        snap = {s: trees.map_leaves(np.copy, t) for s, t in store.slots.items()}
        out = runner.run_round(rnd, round_step=step, stacker=stacker, draw_batches=draw,
                               payload_bits=payload_bits)
        trained += int((out["plan"].train[out["ids"]] > 0).sum())
        phases = tracer.pop_round()
        gather_ms.append(phases["gather"] * 1e3)
        scatter_ms.append(phases["scatter"] * 1e3)
        keep = np.setdiff1d(np.arange(P["population"]), out["ids"])
        unsampled_ok.append(all(
            np.array_equal(a[keep], b[keep]) for s in store.slots
            for a, b in zip(trees.flatten(store.slots[s]).values(),
                            trees.flatten(snap[s]).values())))
    launches = log["on_launches"]
    # each local step of a training client: one forward through the L
    # layers, lora_fused on wq and wv and flash_attn once a layer
    steps = trained * P["local_steps"]
    expected = dict.fromkeys(KERNELS, 0)
    expected.update(lora_fused=2 * mcfg.n_layers * steps, flash_attn=mcfg.n_layers * steps)
    print(f"TRAIN-POP (d) roberta-base full width, {P['population']} fedlora clients, cohort "
          f"{P['cohort']} x {P['rounds']} rounds: round_ms_health_on={log['on_ms']} "
          f"round_ms_health_off={log['off_ms']} (in turns; off first in odd rounds) "
          f"cohort_health_ms={log['health_ms']} gather_ms={gather_ms} "
          f"scatter_ms={scatter_ms} store_MB={store.nbytes() / 1e6:.3f} "
          f"health_vs_float64_oracle_max_rel_err={log['oracle_err']} "
          f"(tol {POP_ORACLE_RTOL:g}) state_bitwise_equal_on_off={log['bitwise']} "
          f"unsampled_rows_unchanged={unsampled_ok} ({trained} client-rounds train) "
          f"launches {launches} expected {expected} "
          f"(health-off comparison runs {log['off_launches']})", flush=True)
    if not (all(log["bitwise"]) and all(log["oracle_ok"]) and all(unsampled_ok)):
        fail(f"TRAIN-POP (d): bitwise {log['bitwise']} oracle {log['oracle_err']} "
             f"unsampled {unsampled_ok}")
    if launches != expected or log["off_launches"] != expected:
        fail(f"TRAIN-POP (d): health-on launches {launches}, health-off "
             f"{log['off_launches']}, expected {expected} each")
    return launches, dict(launches=launches, round_ms_health_on=log["on_ms"],
                          round_ms_health_off=log["off_ms"], health_ms=log["health_ms"],
                          gather_ms=gather_ms,
                          scatter_ms=scatter_ms, store_bytes=store.nbytes(),
                          oracle_rel_err=log["oracle_err"])


def train_pop(torch, np):
    """TRAIN-POP (a)–(d); its launches are (a)'s, (c)'s and (d)'s
    health-on rounds."""
    got_a, pftt_row = train_pop_pftt(torch)
    got_c, shepherd_row = train_pop_shepherd(torch)
    got_d, full_row = train_pop_full(torch, np)
    return ({k: got_a[k] + got_c[k] + got_d[k] for k in KERNELS},
            dict(pftt=pftt_row, shepherd=shepherd_row, full=full_row))


ARCH_ROUND_ARCHS = ("gpt2-small", "llama3.2-1b", "gemma3-12b", "internvl2-26b",
                    "dbrx-132b", "jamba-v0.1-52b", "mamba2-1.3b", "deepseek-v2-236b",
                    "whisper-base")
ARCH_ROUND_FLAGS = ["--fl-clients", "4", "--fl-rounds", "2", "--assert-fused"]
# (d_model, its flags, the archs run there): heads of 64; the launcher's
# default width (no flag: d 64, heads of 16); d 72, heads of 18 (MLA's (34,
# 18), SSD heads of 16: the element path); d 1088, heads of 272 (MLA's
# (288, 272): split) for four archs, whose CPU re-runs cost seconds each
ARCH_WIDTHS = ((256, ["--fl-dmodel", "256"], ARCH_ROUND_ARCHS), (64, [], ARCH_ROUND_ARCHS),
               (72, ["--fl-dmodel", "72"], ARCH_ROUND_ARCHS),
               (1088, ["--fl-dmodel", "1088"],
                ("gpt2-small", "llama3.2-1b", "deepseek-v2-236b", "whisper-base")))
ARCH_LOSS_TOL = 1e-5


def arch_expected(cfg, steps):
    """Each kernel's launches in one ``--assert-fused`` arch round of
    ``steps`` client-steps: every engine step's forward runs ``lora_fused``
    once per factored projection (the backward is plain; MLA's four
    targets all run factored in the sequence forward), and the engine's and
    the oracle's forwards (the oracle replays every step with merged
    weights, so no ``lora_fused``) each run ``flash_attn`` per ``attn``,
    ``local``, ``enc`` or ``mla`` layer and twice per ``dec`` layer (self
    and cross), and ``ssd_chunk`` per mamba layer."""
    from repro_torch.core.arch_round import MIXER_TARGETS
    n = mixer_counts(cfg)
    n_lora = sum(len(MIXER_TARGETS.get(k.mixer, ())) * st.repeats
                 for st in cfg.stages for k in st.pattern)
    flash = sum(n.get(m, 0) for m in ("attn", "local", "enc", "mla")) + 2 * n.get("dec", 0)
    return {"lora_fused": n_lora * steps, "flash_attn": flash * 2 * steps,
            "decode_attn": 0, "block_sparse_attn": 0, "ssd_chunk": n.get("mamba", 0) * 2 * steps}


def train_arch(torch):
    """ARCH-ROUND: ``launch/train.py --arch X --fl-clients 4 --fl-rounds 2
    --assert-fused`` at each of ``ARCH_WIDTHS`` (``--fl-dmodel 256``, heads
    of 64; the launcher's default d 64, heads of 16; d 72, heads of 18; d
    1088, heads of 272, four archs) for its archs on the card — seconds a round, loss per round, the on-card oracle error
    (≤ 1e-5, asserted by the launcher), launches against ``arch_expected``
    — then the same on the CPU from the same init (drawn on the CPU):
    losses within ARCH_LOSS_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.core.arch_round import ArchRoundConfig
    from repro_torch.launch import train

    kernels = wrappers()
    total = {n: 0 for n in KERNELS}
    rows = {}
    for d_model, width_flags, archs in ARCH_WIDTHS:
        for arch in archs:
            t0 = time.perf_counter()
            argv = ["--arch", arch] + ARCH_ROUND_FLAGS + width_flags
            for f in kernels.values():
                f.launches = 0
            with contextlib.redirect_stdout(io.StringIO()) as out:
                res = train.main(argv)
            launches = {n: f.launches for n, f in kernels.items()}
            d = ArchRoundConfig(arch=arch)
            cfg = get_config(arch).reduced(d_model=d_model, repeats=d.repeats)
            expected = arch_expected(cfg, 2 * 4 * d.local_steps)
            t_card = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                cpu = train.main(argv + ["--device", "cpu"])
            errs = [abs(a - b) for a, b in zip(res["loss_per_round"], cpu["loss_per_round"])]
            t_end = time.perf_counter()
            heads = (f"q/k {cfg.mla.nope_head_dim + cfg.mla.rope_head_dim}, v "
                     f"{cfg.mla.v_head_dim}" if cfg.mla
                     else f"SSD heads of {cfg.ssm.headdim}" if cfg.attention_free
                     else f"head width {cfg.hd}")
            print(f"ARCH-ROUND {arch} d_model {d_model} ({heads}): round_s "
                  f"{[round(x, 4) for x in res['round_s']]} loss_per_round "
                  f"{[round(x, 6) for x in res['loss_per_round']]} oracle_max_err "
                  f"{res['oracle_loss_max_err']:.3e} dense_merges "
                  f"{res['dense_merges_in_engine']} targets {res['lora_targets']}", flush=True)
            print(f"ARCH-ROUND {arch} d_model {d_model} launches {launches} expected "
                  f"{expected}; CPU losses {[round(x, 6) for x in cpu['loss_per_round']]} "
                  f"max_abs_err {max(errs):.3e} (tol {ARCH_LOSS_TOL:g}); seconds card "
                  f"{t_card - t0:.1f} cpu {t_end - t_card:.1f}", flush=True)
            tag = f"ARCH-ROUND {arch} d_model {d_model}"
            if "fused path asserted" not in out.getvalue():
                fail(f"{tag}: the launcher's fused-path assertion did not pass")
            if launches != expected:
                fail(f"{tag}: kernel launches {launches} != expected {expected}")
            if max(errs) > ARCH_LOSS_TOL:
                fail(f"{tag}: card vs CPU losses differ by {max(errs):.3e}")
            for n in KERNELS:
                total[n] += launches[n]
            rows[f"{arch} d{d_model}"] = dict(
                round_s=res["round_s"], loss_per_round=res["loss_per_round"],
                oracle_max_err=res["oracle_loss_max_err"], launches=launches,
                cpu_loss_max_err=max(errs))
    return total, rows

MESH_ACC_TOL = 1e-6
MESH_CLIENTS = 3           # TRAIN-MESH (b): two ranks, one ghost
MESH_ARGV = ["--arch", "roberta-base", "--fl-clients", "4", "--fl-rounds", "3"]


def mesh_config(n_clients):
    """TRAIN-PFTT's pftt run (the launcher's settings) at ``n_clients``."""
    from repro_torch.launch import train
    return train.pftt_config(train.parse_args(MESH_ARGV), n_clients=n_clients,
                             verbose=False)


def run_counted(run):
    """``run()`` with every kernel's launch count set to 0 just before it →
    (its result, the launches)."""
    kernels = wrappers()
    for f in kernels.values():
        f.launches = 0
    res = run()
    return res, {n: f.launches for n, f in kernels.items()}


def ledger_rows(res):
    return [(r["bytes"], r["delay_s"], r["outages"]) for r in res["round_records"]]


def mesh_rank(argv):
    """One rank of TRAIN-MESH (b): ``chip_smoke.py --mesh-rank RANK WORLD
    STORE OUT`` joins a gloo group of WORLD processes on card 0 through the
    ``FileStore`` STORE, runs ``run_pftt`` at ``mesh_config(MESH_CLIENTS)``
    under the group's client mesh and writes its result and launches to
    OUT (JSON)."""
    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    import torch
    import torch.distributed as dist

    from repro_torch.core.pftt import run_pftt
    from repro_torch.launch.mesh import client_mesh
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        mesh = client_mesh()
        res, launches = run_counted(lambda: run_pftt(mesh_config(MESH_CLIENTS), mesh=mesh))
        with open(out, "w") as f:
            json.dump({"acc_per_round": res["acc_per_round"], "ledger": ledger_rows(res),
                       "round_s": res["round_s"], "pretrain_s": res["pretrain_s"],
                       "launches": launches}, f)
    finally:
        dist.destroy_process_group()


def train_mesh(torch, np):
    """TRAIN-MESH (a)–(c): see the module docstring.  Its checkpoints and
    rank outputs live in a temporary directory removed at the end."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        return train_mesh_in(torch, np, tmp)


def train_mesh_in(torch, np, tmp):
    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.core.pftt import run_pftt
    from repro_torch.launch.mesh import client_mesh

    total = {n: 0 for n in KERNELS}
    # (a) one rank over NCCL against the unsharded run, both checkpointing
    cfg = mesh_config(4)
    runs = {}
    plain, plain_l = run_counted(lambda: run_pftt(dataclasses.replace(
        cfg, ckpt_dir=os.path.join(tmp, "plain"))))
    dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "nccl"),
                            rank=0, world_size=1)
    events, orig = [], sharding._all_reduce

    def timed(t, mesh, op):       # CUDA events around each all_reduce
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = orig(t, mesh, op)
        ev[1].record()
        events.append((ev, t.numel() * t.element_size()))
        return out

    try:
        mesh = client_mesh()
        t0 = time.perf_counter()     # NCCL sets its communicator up here
        sharding.psum(torch.zeros(1, device="cuda"), mesh)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        sharding._all_reduce = timed
        shard, shard_l = run_counted(lambda: run_pftt(
            dataclasses.replace(cfg, ckpt_dir=os.path.join(tmp, "mesh")), mesh=mesh))
    finally:
        sharding._all_reduce = orig
        dist.destroy_process_group()
    torch.cuda.synchronize()
    reduce_ms = [ev[0].elapsed_time(ev[1]) for ev, _ in events]
    reduce_bytes = [b for _, b in events]
    by_size = {b: sorted(m for m, c in zip(reduce_ms, reduce_bytes) if c == b)
               for b in sorted(set(reduce_bytes))}
    files = [os.path.join(tmp, d, "pftt_pftt.npz") for d in ("plain", "mesh")]
    with np.load(files[0]) as a, np.load(files[1]) as b:
        state_equal = sorted(a.files) == sorted(b.files) and all(
            np.array_equal(a[k], b[k]) for k in a.files if not k.startswith("__"))
    runs["a"] = dict(plain_round_s=plain["round_s"], mesh_round_s=shard["round_s"],
                     allreduce_ms=reduce_ms, allreduce_bytes=reduce_bytes,
                     nccl_setup_s=setup_s, launches=shard_l, state_bit_equal=state_equal)
    same = (ledger_rows(plain) == ledger_rows(shard)
            and plain["acc_per_round"] == shard["acc_per_round"]
            and same_records(plain["round_records"], shard["round_records"]))
    print(f"TRAIN-MESH (a) run_pftt pftt 4 clients 3 rounds, one-rank NCCL group vs "
          f"unsharded, same card: s_per_round mesh "
          f"{sum(shard['round_s']) / len(shard['round_s']):.4f} "
          f"{[round(x, 4) for x in shard['round_s']]} unsharded "
          f"{sum(plain['round_s']) / len(plain['round_s']):.4f} "
          f"{[round(x, 4) for x in plain['round_s']]}; acc {shard['acc_per_round']}; "
          f"records equal {same}; checkpointed state bit-equal {state_equal}; launches "
          f"{shard_l} unsharded {plain_l}", flush=True)
    print(f"TRAIN-MESH (a) all_reduce: {len(reduce_ms)} calls in 3 rounds, ms between "
          f"CUDA events on the caller's stream around the call (one rank: the hand-off to "
          f"NCCL's stream, no cross-card transfer) median {sorted(reduce_ms)[len(reduce_ms) // 2]:.4f} "
          f"max {max(reduce_ms):.4f} total {sum(reduce_ms):.3f}; by bytes a call (calls, "
          f"median ms): {({b: (len(m), round(m[len(m) // 2], 4)) for b, m in by_size.items()})}"
          f"; NCCL communicator setup (one warm-up reduce, before the run) {setup_s:.3f} s",
          flush=True)
    if not (same and state_equal and shard_l == plain_l):
        fail("TRAIN-MESH (a): the one-rank sharded run differs from the unsharded run")
    for n in KERNELS:
        total[n] += shard_l[n]

    # (b) two ranks on the one card over gloo, 3 clients (rank 1: client 2
    # and a ghost) against the unsharded card run of the same clients
    cfg3 = mesh_config(MESH_CLIENTS)
    ref, ref_l = run_counted(lambda: run_pftt(cfg3))
    world, t0 = 2, time.perf_counter()
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank",
                               str(r), str(world), os.path.join(tmp, "gloo"), outs[r]],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"TRAIN-MESH (b) rank {r} exited {p.returncode}:\n{log[-3000:]}")
    ranks = []
    for o in outs:
        with open(o) as f:
            ranks.append(json.load(f))
    summed = {n: sum(r["launches"][n] for r in ranks) for n in KERNELS}
    ghost = {n: pftt_expected(mesh_config(4), "pftt")[n]
             - pftt_expected(cfg3, "pftt")[n] for n in KERNELS}
    pre = {n: pftt_expected(dataclasses.replace(cfg3, rounds=0), "pftt")[n]
           for n in KERNELS}
    expected = {n: ref_l[n] + ghost[n] + (world - 1) * pre[n] for n in KERNELS}
    acc_err = max(abs(a - b) for r in ranks
                  for a, b in zip(r["acc_per_round"], ref["acc_per_round"]))
    same_ledger = all([tuple(x) for x in r["ledger"]] == ledger_rows(ref) for r in ranks)
    runs["b"] = dict(rank_round_s=[r["round_s"] for r in ranks], plain_round_s=ref["round_s"],
                     acc_max_abs_err=acc_err, launches=summed, seconds=time.perf_counter() - t0)
    print(f"TRAIN-MESH (b) two ranks on one card over gloo, 3 clients (one ghost): "
          f"s_per_round rank0 {sum(ranks[0]['round_s']) / 3:.4f} rank1 "
          f"{sum(ranks[1]['round_s']) / 3:.4f} unsharded {sum(ref['round_s']) / 3:.4f}; "
          f"acc_max_abs_err {acc_err:.2e} (tol {MESH_ACC_TOL:g}); records equal "
          f"{same_ledger}; launches summed {summed} = unsharded {ref_l} + ghost {ghost} "
          f"+ rank 1's pretraining {pre}: {summed == expected}; "
          f"{time.perf_counter() - t0:.1f} s with the spawns", flush=True)
    if acc_err > MESH_ACC_TOL or not same_ledger or summed != expected:
        fail("TRAIN-MESH (b): the two-rank run differs from the unsharded run")
    for n in KERNELS:
        total[n] += summed[n]

    # (c) the launcher under torchrun, one rank
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", "1", "-m", "repro_torch.launch.train"]
                          + MESH_ARGV[:4] + ["--fl-rounds", "1"], cwd=ROOT, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=300)
    text = proc.stdout.decode(errors="replace")
    runs["c"] = dict(exit=proc.returncode, seconds=time.perf_counter() - t0)
    print(f"TRAIN-MESH (c) torchrun --nproc-per-node 1 launch.train --fl-clients 4 "
          f"--fl-rounds 1: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s; "
          f"{[ln for ln in text.splitlines() if ln.startswith(('federated', 'final'))]}",
          flush=True)
    if proc.returncode != 0 or "client mesh" not in text:
        fail(f"TRAIN-MESH (c): torchrun launch failed:\n{text[-3000:]}")
    return total, runs


LAUNCH_GEN = 8
LAUNCH_STEPS = 3
REMAT_LOSS_TOL = 1e-5
CKPT_TOL = 1e-6            # the launcher's run against the same seeds' Trainer


def launch_phase(torch, np):
    """LAUNCH: see the module docstring."""
    from repro_torch import trees
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch import serve, steps, train

    total = {n: 0 for n in KERNELS}
    args = serve.parse_args(["--arch", "gpt2-small", "--batch", "8", "--prompt-len", "128",
                             "--gen", str(LAUNCH_GEN), "--lora-rank", "8"])
    model, params, lora, lscale, prompts, _, _ = serve.build(args)
    rng = np.random.RandomState(1)
    lora = trees.map_with_path(
        lambda p, v: v if p.endswith("/mask") else torch.from_numpy(
            (rng.randn(*v.shape) * 0.05).astype(np.float32)).to(v.device), lora)
    want = serve.generate(model, params, prompts, LAUNCH_GEN, lora=lora, lora_scale=lscale)
    prefill = steps.make_prefill_step(model, serve.cache_len(model, prompts, LAUNCH_GEN),
                                      lora_scale=lscale)
    decode = steps.make_serve_step(model, lora_scale=lscale)

    def via_steps():
        logits, cache = prefill(params, {"tokens": prompts}, lora=lora)
        got = [logits]
        for _ in range(LAUNCH_GEN):
            logits, cache = decode(params, cache, logits.argmax(-1, keepdim=True), lora=lora)
            got.append(logits)
        torch.cuda.synchronize()
        return got

    got, launches = run_counted(via_steps)
    diff = max(float((a - b).abs().max()) for a, b in zip(got, want["logits"]))
    expected = expected_launches(model, lora, "auto", LAUNCH_GEN)
    print(f"LAUNCH make_prefill_step + make_serve_step gpt2-small full width batch 8 "
          f"prompt 128, {LAUNCH_GEN} decode steps: max |logit - SERVE path's| {diff:.3e}; "
          f"launches {launches} expected {expected}", flush=True)
    if diff != 0.0 or launches != expected:
        fail("LAUNCH: the step builders' logits or launches differ from the SERVE path's")
    for n in KERNELS:
        total[n] += launches[n]
    del model, params, lora, want, got
    torch.cuda.empty_cache()

    argv = ["--arch", "roberta-base", "--steps", str(LAUNCH_STEPS), "--batch", "16",
            "--seq", "128", "--lora-rank", "8"]
    row = {}
    for remat in (True, False):
        tr = train.Trainer(train.parse_args(argv), remat=remat)
        rng = np.random.RandomState(0)
        batches = [tr.to_device(tr.batch(rng)) for _ in range(LAUNCH_STEPS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, losses, per_step = [], [], []
        for b in batches:
            t0 = time.perf_counter()
            loss, got = run_counted(lambda b=b: float(tr.step(b)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            per_step.append(got)
        peak = torch.cuda.max_memory_allocated()
        layers = tr.cfg.n_layers
        k = 2 if remat else 1            # remat recomputes each forward kernel
        expected = {"lora_fused": 2 * layers * k, "flash_attn": layers * k,
                    "decode_attn": 0, "block_sparse_attn": 0, "ssd_chunk": 0}
        row["remat" if remat else "plain"] = dict(step_ms=ms, losses=losses,
                                                  max_memory_allocated=peak,
                                                  launches_per_step=per_step[0])
        print(f"LAUNCH launch.train --steps {LAUNCH_STEPS} roberta-base full width batch 16 "
              f"seq 128 remat={remat} (the first step cold; warm steps: "
              f"tools/train_step_timing.py): median_step_ms {sorted(ms)[len(ms) // 2]:.2f} "
              f"step_ms {[round(x, 2) for x in ms]} losses "
              f"{[round(x, 6) for x in losses]} max_memory_allocated {peak / 2**20:.1f} MiB "
              f"launches a step {per_step[0]}", flush=True)
        if any(p != expected for p in per_step):
            fail(f"LAUNCH remat={remat}: launches a step {per_step} != {expected}")
        for n in KERNELS:
            total[n] += sum(p[n] for p in per_step)
        if remat:    # on the host: the plain run's peak must not count them
            template = trees.map_leaves(lambda v: v.detach().cpu(), tr.params())
            trained = trees.flatten(template)
        del tr, batches
        torch.cuda.empty_cache()
    err = max(abs(a - b) for a, b in zip(row["remat"]["losses"], row["plain"]["losses"]))
    print(f"LAUNCH remat vs plain: max loss difference {err:.3e} (tol {REMAT_LOSS_TOL:g}); "
          f"peak memory {row['remat']['max_memory_allocated'] / 2**20:.1f} vs "
          f"{row['plain']['max_memory_allocated'] / 2**20:.1f} MiB", flush=True)
    if err > REMAT_LOSS_TOL:
        fail(f"LAUNCH: remat changes the losses by {err:.3e}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        path = os.path.join(tmp, "roberta.npz")
        with contextlib.redirect_stdout(io.StringIO()):
            main_losses, got = run_counted(lambda: train.main(argv + ["--ckpt", path]))
        loaded = trees.flatten(load_checkpoint(path, template))
    ck_err = max(float((loaded[p] - v).abs().max()) for p, v in trained.items())
    loss_err = max(abs(a - b) for a, b in zip(main_losses, row["remat"]["losses"]))
    print(f"LAUNCH launch.train --ckpt: losses {[round(x, 6) for x in main_losses]}, the "
          f"checkpoint read back through load_checkpoint within {ck_err:.3e} of the "
          f"remat run's trained parameters", flush=True)
    if ck_err > CKPT_TOL or loss_err > CKPT_TOL:
        fail(f"LAUNCH: --ckpt's parameters ({ck_err:.3e}) or losses ({loss_err:.3e}) "
             "differ from the remat run's")
    for n in KERNELS:
        total[n] += got[n]
    return total, row


# ---------------------------------------------------------------- TP
# (a), (b): 2 steps, cut from 3 for the script's time (TRAIN-ORACLES); the
# (2, 2) gloo run's steps take 3.7-4.6 s each past its first
TP_N_STEPS = 2
TP_STEPS = ["--arch", "llama3.2-1b", "--depth", "2", "--steps", str(TP_N_STEPS), "--batch",
            "4", "--seq", "128", "--lr", "1e-4"]    # make_train_step's default lr
TP_TOL = 1e-4              # (b), (d): losses, parameters, gradients
# (b): the elements AdamW leaves open (see tp_phase) at lr 1e-4.  Each
# step moves an element by at most about lr, so two runs may part by
# 2·lr a step there; on an H100 80GB HBM3 at 700 W the open elements of
# the (2, 2) gloo run parted from the meshless run's by at most 1.01e-4
# after 3 steps.
TP_OPEN_TOL = 2e-4
TP_SERVE = dict(batch=8, prompt=128, gen=16, cache_len=544)   # segments of 136
TP_SP = dict(batch=2, seq=512)          # mamba_sp: 128 positions a rank
# moe_a2a's model: 4 tokens a rank, so no choice can be dropped: a rank's
# 4 experts take at most 4 of a token's 6 choices (16), and c_out =
# ceil8(1.5 · t·k / M) = 16.  The meshless model is the reference there,
# and its capacity is not a2a's: at 16 tokens a rank a2a drops choices
# that the meshless model keeps.
TP_A2A = dict(batch=1, seq=16)
# moe_a2a's layer alone (TP_A2A_LAYER), where it drops: 16 tokens a rank
# pulled towards rank 0's experts (a shift of about 2 in their logits), so
# every rank sends rank 0 more than c_out = 40 choices and rank 0's experts
# get more than c2 = 40 each; held against ``a2a_loopback``, the same
# capacities on one process, balance loss included
TP_A2A_LAYER = dict(batch=1, seq=64, pull=4.0)
TP_SAMPLES = 2048          # gradient elements compared a leaf and rank (beside its norm)
TP_WORLD = 4


def tp_cut(arch, depth=2):
    """``arch`` at its published widths, every stage cut to ``depth``
    repeats (``launch.train --depth``)."""
    from repro_torch.configs import Stage, get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, stages=tuple(
        Stage(st.pattern, min(st.repeats, depth), st.stream) for st in cfg.stages))


def tp_setup(torch, np, name):
    """(cfg, whole params drawn on the card from CUDA seed 0, inputs) of
    the TP phase's (c) serve / (d) sp / (d) a2a model."""
    from repro_torch.models.transformer import Model
    cfg = {"serve": lambda: tp_cut("llama3.2-1b"), "sp": lambda: tp_cut("mamba2-1.3b"),
           "a2a": mla_cut}[name]()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = Model(cfg, device="cuda").init(gen, max_seq=1024)
    rng = np.random.RandomState(2)
    if name == "serve":
        from repro_torch import trees
        from repro_torch.models import peft
        pc = peft.PEFTConfig(lora_rank=8, lora_targets=("mixer/wq", "mixer/wv"))
        lora = trees.map_with_path(
            lambda p, v: v if p.endswith("/mask") else torch.from_numpy(
                (rng.randn(*v.shape) * 0.05).astype(np.float32)).cuda(),
            peft.init_lora(torch.Generator().manual_seed(1), params, pc))
        s = TP_SERVE
        toks = rng.randint(6, cfg.vocab_size, (s["batch"], s["prompt"] + s["gen"]))
        return cfg, params, {"lora": lora, "scale": peft.lora_scale(pc),
                             "tokens": torch.from_numpy(toks).cuda()}
    s = TP_SP if name == "sp" else TP_A2A
    toks = rng.randint(6, cfg.vocab_size, (s["batch"], s["seq"] + 1))
    return cfg, params, {"tokens": torch.from_numpy(toks[:, :-1]).cuda(),
                         "labels": torch.from_numpy(toks[:, 1:]).cuda(),
                         "mask": torch.ones(s["batch"], s["seq"], device="cuda")}


def tp_a2a_layer(torch):
    """(moe config, act, whole layer params, x, r) of moe_a2a's layer check:
    ``mla_cut``'s MoE layer (routed experts and the 2 shared) drawn on the
    card from CUDA seed 3, and x (1, 64, 5120) pulled towards the first
    quarter of the experts (rank 0's) by TP_A2A_LAYER["pull"] along their
    router columns' summed direction."""
    from repro_torch.models.moe import init_moe
    cfg = mla_cut()
    gen = torch.Generator(device="cuda").manual_seed(3)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device="cuda") * std
    params = init_moe(normal, cfg.d_model, cfg.moe, cfg.act)
    s = TP_A2A_LAYER
    u = params["router"][:, :cfg.moe.n_experts // TP_WORLD].sum(-1)
    x = normal((s["batch"], s["seq"], cfg.d_model), 1.0) + s["pull"] * u / u.norm()
    return cfg.moe, cfg.act, params, x, normal(tuple(x.shape), 1.0)


def a2a_loopback(torch, x, params, cfg, act, n_model):
    """``moe.moe_ffn_a2a`` over ``n_model`` model ranks on one process:
    each sequence block routed and bucketed to the ranks at capacity c_out,
    each rank's experts over what the blocks sent it at capacity c2, the
    outputs sent back, the balance loss the blocks' mean, the shared experts
    on the whole x → (y, aux, choices dropped at c_out, at c2)."""
    from repro_torch.models import moe
    k, e_loc = cfg.top_k, cfg.n_experts // n_model
    b, seq, d = x.shape
    s = seq // n_model
    t = b * s
    c_out = max(8, -(-int(t * k / n_model * 1.5) // 8) * 8)
    sends, toks, aux, drop_out = [], [], 0.0, 0
    for r in range(n_model):
        xt = x[:, r * s:(r + 1) * s].reshape(t, d)
        gates, w, idx = moe.route(xt, params["router"], cfg)
        flat_e, flat_w = idx.reshape(-1), w.reshape(-1)
        table = moe._bucket_table(flat_e // e_loc, n_model, c_out)
        ok = table < t * k
        tcl = table.clamp(max=t * k)
        tok = torch.where(ok, table // k, t)
        sends.append((torch.cat([xt, xt.new_zeros(1, d)])[tok],
                      torch.where(ok, torch.cat([flat_e, flat_e.new_zeros(1)])[tcl] % e_loc,
                                  e_loc),
                      torch.where(ok, torch.cat([flat_w, flat_w.new_zeros(1)])[tcl], 0.0)))
        toks.append(tok)
        aux = aux + moe._balance(gates, idx, cfg) / n_model
        drop_out += t * k - int(ok.sum())
    n_recv = n_model * c_out
    c2 = min(max(8, -(-int(n_recv / e_loc) // 8) * 8), n_recv)
    backs, drop_in = [], 0
    for m in range(n_model):
        rx, re_, rw = (torch.stack([sends[r][i][m] for r in range(n_model)]).reshape(
            (n_recv, d) if i == 0 else (n_recv,)) for i in range(3))
        table2 = moe._bucket_table(re_, e_loc, c2)
        ok2 = table2 < n_recv
        t2 = table2.clamp(max=n_recv)
        xe = torch.cat([rx, rx.new_zeros(1, d)])[t2] * ok2[..., None].to(rx.dtype)
        sl = slice(m * e_loc, (m + 1) * e_loc)
        ye = moe._experts(xe, params["wg"][sl], params["wu"][sl], params["wd"][sl], act)
        wtab = torch.where(ok2, torch.cat([rw, rw.new_zeros(1)])[t2], 0.0)
        ye = (ye.float() * wtab[..., None]).to(x.dtype)
        backs.append(x.new_zeros(n_recv + 1, d).index_add(
            0, t2.reshape(-1), ye.reshape(-1, d))[:n_recv].reshape(n_model, c_out, d))
        drop_in += int((re_ < e_loc).sum()) - int(ok2.sum())
    y = torch.cat([x.new_zeros(t + 1, d).index_add(
        0, toks[r].reshape(-1),
        torch.stack([backs[m][r] for m in range(n_model)]).reshape(-1, d))[:t].reshape(b, s, d)
        for r in range(n_model)], 1)
    return moe._shared(x, y, params, cfg, act, None), aux, drop_out, drop_in


def tp_serve(torch, model, params, inp):
    """Prefill of the prompt, then the teacher-forced decode steps → (logits
    (gen + 1, B, V), decode_attn launches a decode step)."""
    s, kernels = TP_SERVE, wrappers()
    toks = inp["tokens"]
    per_step = []
    with torch.no_grad():
        logits, cache = model.prefill(params, toks[:, :s["prompt"]], s["cache_len"],
                                      lora=inp["lora"], lora_scale=inp["scale"])
        out = [logits]
        for i in range(s["gen"]):
            before = kernels["decode_attn"].launches
            logits, cache = model.decode_step(params, cache, toks[:, s["prompt"] + i:][:, :1],
                                              lora=inp["lora"], lora_scale=inp["scale"])
            per_step.append(kernels["decode_attn"].launches - before)
            out.append(logits)
    torch.cuda.synchronize()
    return torch.stack(out), per_step


def tp_grad_stats(torch, grads, specs, mc):
    """Per leaf of this rank's gradient blocks: (L2 norm, TP_SAMPLES
    elements at positions drawn from the leaf's path)."""
    import zlib

    from repro_torch import trees
    from repro_torch.sharding import shard_leaf
    out = {}
    for p, g in trees.flatten(grads).items():
        if g is None:
            continue
        if specs is not None:
            g = shard_leaf(g, specs[p], mc)
        flat = g.detach().reshape(-1)
        idx = torch.randint(0, flat.numel(), (TP_SAMPLES,),
                            generator=torch.Generator().manual_seed(zlib.crc32(p.encode())))
        out[p] = (float(flat.double().norm()), flat[idx.to(flat.device)].double().cpu().numpy())
    return out


def tp_rank(argv):
    """One rank of the TP phase's (c) and (d): ``chip_smoke.py --tp-rank
    RANK WORLD STORE OUT`` joins a gloo group of WORLD processes on card 0
    through the ``FileStore`` STORE, builds the (1, WORLD) mesh, runs
    SERVE-TP, then mamba_sp's and moe_a2a's loss and gradient (the balance
    loss weighted 0: see ``tp_phase``), and pickles its results to OUT."""
    import pickle

    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import trees
    from repro_torch.models import moe, parallel, transformer
    from repro_torch.models.transformer import Model
    from repro_torch.optim import value_and_grad
    from repro_torch.sharding import MeshCtx, Spec
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    res = {}
    try:
        mc = MeshCtx.create((1, world))
        cfg, params, inp = tp_setup(torch, np, "serve")
        model = Model(cfg, device="cuda", meshctx=mc)
        loc = model.shard(params)
        del params
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (logits, per_step), launches = run_counted(lambda: tp_serve(torch, model, loc, inp))
        rel = {p[len("stages/0/layers/0/"):]: Spec(*tuple(s)[1:])
               for p, s in model.specs.items() if p.startswith("stages/0/layers/0/")}
        plan = parallel.layer_plan(mc, cfg, cfg.stages[0].pattern[0], rel)
        res["serve"] = {"s": time.perf_counter() - t0, "launches": launches,
                        "decode_per_step": per_step,
                        "heads": cfg.n_heads // world if plan.attn else cfg.n_heads,
                        "peak": torch.cuda.max_memory_allocated(),
                        "logits": logits.cpu().numpy() if rank == 0 else None}
        del model, loc, logits
        aux_w, transformer.AUX_WEIGHT = transformer.AUX_WEIGHT, 0.0
        for name, opts in (("sp", {"mamba_sp": True}), ("a2a", {"moe_a2a": True})):
            torch.cuda.empty_cache()
            cfg, params, batch = tp_setup(torch, np, name)
            model = Model(cfg, device="cuda", meshctx=mc, opts=opts)
            loc = model.shard(params)
            del params
            t0 = time.perf_counter()
            (loss, grads), launches = run_counted(
                lambda: value_and_grad(lambda p: model.lm_loss(p, batch), loc))
            torch.cuda.synchronize()
            res[name] = {"s": time.perf_counter() - t0, "loss": float(loss),
                         "launches": launches,
                         "stats": tp_grad_stats(torch, grads, None, mc)}
            del model, loc, grads
        transformer.AUX_WEIGHT = aux_w
        torch.cuda.empty_cache()
        cfg, act, params, x, r = tp_a2a_layer(torch)
        e_loc = cfg.n_experts // world
        sl = slice(mc.coord(mc.model_axis) * e_loc, (mc.coord(mc.model_axis) + 1) * e_loc)
        leaves = dict(trees.flatten(params), x=x)
        leaves.update({n: params[n][sl] for n in ("wg", "wu", "wd")})
        leaves = {p: v.detach().clone().requires_grad_() for p, v in leaves.items()}
        del params
        t0 = time.perf_counter()
        tree = trees.unflatten({p: v for p, v in leaves.items() if p != "x"})
        (y, aux), launches = run_counted(lambda: moe.moe_ffn_a2a(
            leaves["x"], tree, cfg, act, tp=parallel.LayerTP(mc=mc, moe=True)))
        ((y * r).sum() + aux).backward()
        torch.cuda.synchronize()
        res["a2a_layer"] = {"s": time.perf_counter() - t0, "aux": float(aux.detach()),
                            "y": y.detach().cpu().numpy() if rank == 0 else None,
                            "launches": launches,
                            "stats": tp_grad_stats(torch, {p: v.grad for p, v in leaves.items()},
                                                   None, mc)}
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def torchrun(nproc, argv, timeout=600):
    """``python -m torch.distributed.run --standalone --nproc-per-node N -m
    repro_torch.launch.train ARGV`` from the checkout → (exit code, output)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc-per-node", str(nproc), "-m",
                             "repro_torch.launch.train"] + argv,
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def finish(proc, tag, timeout=600):
    try:
        log = proc.communicate(timeout=timeout)[0].decode(errors="replace")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        fail(f"{tag} exited {proc.returncode}:\n{log[-3000:]}")
    return log


def tp_phase(torch, np):
    """TP: see the module docstring.  Its checkpoints and rank outputs live
    in a temporary directory removed at the end."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        return tp_phase_in(torch, np, tmp)


def tp_phase_in(torch, np, tmp):
    import pickle

    from repro_torch import trees
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch import dryrun, train
    from repro_torch.models import transformer
    from repro_torch.models.transformer import Model
    from repro_torch.optim import value_and_grad
    from repro_torch.sharding import MeshCtx, Spec, param_specs
    row = {}
    # (a) one NCCL rank and (b) four gloo ranks as (2, 2) start together and
    # share the card and the host with the meshless run below: their s a
    # step are not each other's
    ckpt_a, ckpt_b = os.path.join(tmp, "a.npz"), os.path.join(tmp, "b.npz")
    rep_a, rep_b = os.path.join(tmp, "a.json"), os.path.join(tmp, "b.json")
    proc_a = torchrun(1, TP_STEPS + ["--data-axis", "1", "--ckpt", ckpt_a, "--report", rep_a])
    proc_b = torchrun(TP_WORLD, TP_STEPS + ["--data-axis", "2", "--ckpt", ckpt_b,
                                            "--report", rep_b])
    # the meshless card run: TP_N_STEPS steps.  AdamW's direction m̂/(√v̂ + eps) turns
    # a rounding difference of a gradient into up to lr a step where √v̂ is
    # small (TRAIN-ROBERTA's note; at initialisation many attention weights
    # have |g| ~ 1e-9, under eps): an element whose √v̂ falls under 1e-4 of
    # its leaf's largest |g| (plus 1e-6) at some step is "open", held to
    # TP_OPEN_TOL; every other element to TP_TOL
    torch.cuda.reset_peak_memory_stats()
    tr = train.Trainer(train.parse_args(TP_STEPS), remat=True)
    rng = np.random.RandomState(0)
    unsure, losses = {}, []
    t1 = time.perf_counter()
    for t in range(1, TP_N_STEPS + 1):
        b = tr.to_device(tr.batch(rng))
        g = trees.flatten(value_and_grad(lambda p, b=b: tr.loss(p, b), tr.trainable)[1])
        losses.append(float(tr.step(b)))
        for p, v in trees.flatten(tr.opt_state["nu"]).items():
            small = (v / (1 - 0.999 ** t)).sqrt() < 1e-4 * g[p].abs().max() + 1e-6
            unsure[p] = small if p not in unsure else unsure[p] | small
        del g
    torch.cuda.synchronize()
    plain_s = (time.perf_counter() - t1) / TP_N_STEPS
    plain_peak = torch.cuda.max_memory_allocated()
    want = {p: v.cpu() for p, v in trees.flatten(tr.params()).items()}
    unsure = {p: u.cpu() for p, u in unsure.items()}
    lr = tr.args.lr
    del tr
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    dry = dryrun.run_one("llama3.2-1b", "train_4k", "single", "train",
                         out_dir=os.path.join(tmp, "dryrun"), verbose=False)
    pd, rf = dry["per_device"], dry["roofline"]
    print(f"DRYRUN llama3.2-1b train_4k on the abstract (16, 16) mesh (fsdp, bf16, meta; "
          f"{time.perf_counter() - t1:.1f} s): per device {pd['flops']:.4e} FLOPs (global "
          f"{dry['global']['flops']:.4e}, replication {pd['replication']:.3f}), collectives "
          f"{pd['collectives']} wire {pd['collective_wire_bytes']:.4e} B, args "
          f"{pd['argument_bytes']:.4e} B; roofline compute {rf['compute_s'] * 1e3:.2f} ms, "
          f"memory {rf['memory_s'] * 1e3:.2f} ms, collective {rf['collective_s'] * 1e3:.2f} "
          f"ms ({rf['dominant']}; H100 SXM data-sheet figures)", flush=True)
    row["dryrun"] = {"per_device": pd, "roofline": rf, "global_flops": dry["global"]["flops"]}

    finish(proc_a, "TP (a) torchrun")
    with open(rep_a) as f:
        rep = json.load(f)
    got = trees.flatten(load_checkpoint(ckpt_a, want))
    equal = rep["losses"] == losses and all(torch.equal(got[p], v) for p, v in want.items())
    print(f"TP (a) torchrun 1 rank (NCCL) --steps {TP_N_STEPS} --data-axis 1 llama3.2-1b "
          f"full width, "
          f"2 layers, batch 4, seq 128, lr {lr:g}: losses {[round(x, 6) for x in rep['losses']]} "
          f"meshless {[round(x, 6) for x in losses]}; losses and trained parameters "
          f"bit-equal: {equal}; s a step {[round(x, 3) for x in rep['step_s']]} against "
          f"meshless {plain_s:.3f} (sharing the card with (b)); peak "
          f"{rep['max_memory_allocated'][0] / 2**20:.0f} against {plain_peak / 2**20:.0f} MiB",
          flush=True)
    if not equal:
        fail("TP (a): the (1, 1) run is not bit-equal to the meshless run")
    row["a"] = {"losses": rep["losses"], "step_s": rep["step_s"], "plain_s_per_step": plain_s}

    finish(proc_b, "TP (b) torchrun")
    with open(rep_b) as f:
        rep = json.load(f)
    got = trees.flatten(load_checkpoint(ckpt_b, want))
    settled, open_err, worst, n_open = 0.0, 0.0, "", 0
    for p, v in want.items():
        d = (got[p] - v).abs()
        e = float((d * ~unsure[p]).max())
        if e > settled:
            settled, worst = e, p
        open_err = max(open_err, float((d * unsure[p]).max()))
        n_open += int(unsure[p].sum())
    loss_err = max(abs(a - c) for a, c in zip(rep["losses"], losses))
    print(f"TP (b) torchrun 4 ranks (gloo, one card) --steps {TP_N_STEPS} --data-axis 2: "
          f"losses "
          f"{[round(x, 6) for x in rep['losses']]} max_abs_err {loss_err:.2e} (tol {TP_TOL:g}); "
          f"unsharded parameters max_abs_err {settled:.2e} at {worst} (tol {TP_TOL:g}; "
          f"{n_open} of {sum(u.numel() for u in unsure.values())} elements open, "
          f"at most {open_err:.2e}, tol {TP_OPEN_TOL:g}); s a step "
          f"{[round(x, 3) for x in rep['step_s']]} (gloo stages every collective through the "
          f"host); peak MiB per rank {[round(m / 2**20) for m in rep['max_memory_allocated']]} "
          f"against meshless {plain_peak / 2**20:.0f}", flush=True)
    if loss_err > TP_TOL or settled > TP_TOL or open_err > TP_OPEN_TOL:
        fail("TP (b): the (2, 2) run differs from the meshless run")
    row["b"] = {"losses": rep["losses"], "step_s": rep["step_s"], "n_open": n_open,
                "max_memory_allocated": rep["max_memory_allocated"],
                "plain_max_memory_allocated": plain_peak}
    del want, unsure, got
    torch.cuda.empty_cache()

    # (c), (d): four ranks of chip_smoke.py --tp-rank
    outs = [os.path.join(tmp, f"tp{r}.pkl") for r in range(TP_WORLD)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
                               str(TP_WORLD), os.path.join(tmp, "gloo"), outs[r]],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(TP_WORLD)]
    for r, p in enumerate(procs):
        finish(p, f"TP (c)/(d) rank {r}")
    ranks = []
    for o in outs:
        with open(o, "rb") as f:
            ranks.append(pickle.load(f))
    total = {n: sum(r[k]["launches"][n] for r in ranks
                    for k in ("serve", "sp", "a2a", "a2a_layer")) for n in KERNELS}
    # (c) against the meshless card run
    cfg, params, inp = tp_setup(torch, np, "serve")
    ref, _ = tp_serve(torch, Model(cfg, device="cuda"), params, inp)
    del params
    ref = ref.cpu().numpy()
    err = float(np.abs(ranks[0]["serve"]["logits"] - ref).max())
    tol = 1e-3 * max(1.0, float(np.abs(ref).max()))
    s, layers = TP_SERVE, cfg.n_layers
    seg = s["cache_len"] // TP_WORLD
    want_l = []
    for r in range(TP_WORLD):
        steps = [layers * int(s["prompt"] + i + 1 > r * seg) for i in range(s["gen"])]
        want_l.append(({"lora_fused": 2 * layers * (1 + s["gen"]), "flash_attn": layers,
                        "decode_attn": sum(steps), "block_sparse_attn": 0, "ssd_chunk": 0},
                       steps))
    got_l = [(r["serve"]["launches"], r["serve"]["decode_per_step"]) for r in ranks]
    print(f"SERVE-TP llama3.2-1b full width, 2 layers, on (1, 4) gloo: batch {s['batch']}, "
          f"prefill {s['prompt']}, {s['gen']} decode steps, cache {s['cache_len']} (segments "
          f"of {seg}), LoRA on wq/wv: max |logit - meshless| {err:.3e} (tol {tol:.3e}); "
          f"flash_attn on {ranks[0]['serve']['heads']} of {cfg.n_heads} heads a rank; "
          f"launches per rank {[g[0] for g in got_l]}; decode_attn a step per rank "
          f"{[g[1] for g in got_l]}; s {[round(r['serve']['s'], 3) for r in ranks]}; peak MiB "
          f"{[round(r['serve']['peak'] / 2**20) for r in ranks]}", flush=True)
    if err > tol or got_l != want_l or ranks[1]["serve"]["decode_per_step"][0] != 0:
        fail(f"SERVE-TP: logits {err:.3e} or launches {got_l} != {want_l}")
    row["serve"] = {"logit_err": err, "launches": [g[0] for g in got_l],
                    "s": [r["serve"]["s"] for r in ranks]}
    # (d) against the meshless card runs, the balance loss weighted 0 on
    # both sides (JAX's moe_a2a averages it over the sequence shards; the
    # CPU tests hold that against JAX)
    aux_w = transformer.AUX_WEIGHT
    transformer.AUX_WEIGHT = 0.0
    try:
        for name in ("sp", "a2a"):
            torch.cuda.empty_cache()
            cfg, params, batch = tp_setup(torch, np, name)
            loss, grads = value_and_grad(lambda p: Model(cfg, device="cuda").lm_loss(p, batch),
                                         params)
            specs = trees.flatten(param_specs(MeshCtx.abstract((1, TP_WORLD)), params, cfg))
            del params
            loss_err, norm_err, elem_err = 0.0, 0.0, 0.0
            for r, rk in enumerate(ranks):
                want_s = tp_grad_stats(torch, grads, specs, MeshCtx.abstract((1, TP_WORLD),
                                                                             rank=r))
                loss_err = max(loss_err, abs(rk[name]["loss"] - float(loss)))
                for p, (norm, smp) in want_s.items():
                    gn, gs = rk[name]["stats"][p]
                    norm_err = max(norm_err, abs(gn - norm) / max(1.0, norm))
                    elem_err = max(elem_err, float(np.abs(gs - smp).max()))
            del grads
            what = ("mamba_sp mamba2-1.3b full width, 2 layers, batch 2, seq 512"
                    if name == "sp" else "moe_a2a deepseek-v2 (mla_cut: 2 layers, 16 "
                    "routed experts), batch 1, seq 16")
            print(f"TP (d) {what} on (1, 4) gloo: loss {ranks[0][name]['loss']:.6f} vs "
                  f"meshless {float(loss):.6f} (err {loss_err:.2e}); gradients: per leaf and "
                  f"rank norm rel err {norm_err:.2e}, {TP_SAMPLES} sampled elements max abs "
                  f"err {elem_err:.2e} (tol {TP_TOL:g}); launches rank 0 "
                  f"{ranks[0][name]['launches']}; s {[round(r[name]['s'], 3) for r in ranks]}",
                  flush=True)
            if loss_err > TP_TOL or norm_err > TP_TOL or elem_err > TP_TOL:
                fail(f"TP (d) {name}: the (1, 4) run differs from the meshless run")
            row[name] = {"loss_err": loss_err, "grad_norm_rel_err": norm_err,
                         "grad_elem_err": elem_err, "s": [r[name]["s"] for r in ranks]}
    finally:
        transformer.AUX_WEIGHT = aux_w
    # (d) moe_a2a's layer where its capacities drop, against a2a_loopback
    torch.cuda.empty_cache()
    cfg, act, params, x, r = tp_a2a_layer(torch)
    leaves = {p: v.detach().clone().requires_grad_()
              for p, v in dict(trees.flatten(params), x=x).items()}
    del params
    y, aux, drop_out, drop_in = a2a_loopback(
        torch, leaves["x"], trees.unflatten({p: v for p, v in leaves.items() if p != "x"}),
        cfg, act, TP_WORLD)
    ((y * r).sum() + aux).backward()
    grads = {p: v.grad for p, v in leaves.items()}
    specs = {p: Spec(*(("model",) if p in ("wg", "wu", "wd") else (None,))
                     + (None,) * (g.dim() - 1)) for p, g in grads.items()}
    y_err = float(np.abs(ranks[0]["a2a_layer"]["y"] - y.detach().cpu().numpy()).max())
    aux_err = max(abs(rk["a2a_layer"]["aux"] - float(aux.detach())) for rk in ranks)
    norm_err, elem_err = 0.0, 0.0
    for rank, rk in enumerate(ranks):
        want_s = tp_grad_stats(torch, grads, specs, MeshCtx.abstract((1, TP_WORLD), rank=rank))
        for p, (norm, smp) in want_s.items():
            gn, gs = rk["a2a_layer"]["stats"][p]
            norm_err = max(norm_err, abs(gn - norm) / max(1.0, norm))
            elem_err = max(elem_err, float(np.abs(gs - smp).max()))
    del leaves, grads, y
    s = TP_A2A_LAYER
    print(f"TP (d) moe_a2a layer (mla_cut's: d {x.shape[-1]}, {cfg.n_experts} routed experts "
          f"of {cfg.d_ff}, top-{cfg.top_k}, {cfg.n_shared_experts} shared), batch {s['batch']}, "
          f"seq {s['seq']} pulled {s['pull']:g} towards rank 0's experts, on (1, 4) gloo "
          f"against a2a_loopback: choices dropped at c_out {drop_out}, at c2 {drop_in}; "
          f"max |y - loopback| {y_err:.2e}, balance loss err {aux_err:.2e}, gradients: per leaf "
          f"and rank norm rel err {norm_err:.2e}, {TP_SAMPLES} sampled elements max abs err "
          f"{elem_err:.2e} (tol {TP_TOL:g}); s {[round(rk['a2a_layer']['s'], 3) for rk in ranks]}",
          flush=True)
    if min(drop_out, drop_in) < 1 or max(y_err, aux_err, norm_err, elem_err) > TP_TOL:
        fail("TP (d) moe_a2a layer: no drops at a capacity, or the (1, 4) run differs from "
             "a2a_loopback")
    row["a2a_layer"] = {"drops": [drop_out, drop_in], "y_err": y_err, "aux_err": aux_err,
                        "grad_norm_rel_err": norm_err, "grad_elem_err": elem_err}
    return total, row


def profile(torch, label, run, reps):
    """torch.profiler over ``reps`` calls of ``run``: the device's busy
    share of the wall time and the kernels that fill it, per call, and the
    seconds the trace took to parse.  Prints 'not measured' when the trace
    holds no device events.  CUDA activity only: on an H100 80GB HBM3,
    tracing every CPU op as well doubled a TRAIN-PFIT run's wall time (19.2
    against 9.6 s untraced) and took 158 s to parse, for the same kernels
    and busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wall_us = (t1 - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    if not by_name:
        print(f"PROFILE {label}: no device events in the trace (not measured)")
        return None
    busy = sum(t for _, t in by_name.values())
    print(f"PROFILE {label} x{reps}: wall_us_per_call={wall_us / reps:.1f} "
          f"device_busy_us_per_call={busy / reps:.1f} "
          f"device_busy_share={busy / wall_us:.3f} "
          f"trace_parse_s={time.perf_counter() - t1:.1f}")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"PROFILE   {t / reps:10.1f} us/call  {n / reps:6.1f} calls/call  {name[:90]}")
    return wall_us / reps, busy / reps


def profile_path(torch, tag, model, params, lora, lscale, prompts, patches, frames,
                 steps=16):
    """One prefill, then ``steps`` decode steps, each under the profiler →
    the decode steps' (wall, device busy) µs a step."""
    state = {}

    def prefill():
        state["logits"], state["cache"] = model.prefill(
            params, prompts, model.cfg.n_prefix_tokens + prompts.shape[1] + steps,
            patches=patches, frames=frames, lora=lora, lora_scale=lscale)

    def decode():
        state["logits"], state["cache"] = model.decode_step(
            params, state["cache"], state["logits"].argmax(-1, keepdim=True),
            lora=lora, lora_scale=lscale)

    profile(torch, f"{tag} prefill", prefill, 1)
    return profile(torch, f"{tag} decode", decode, steps)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    import numpy as np

    from repro_torch.kernels import _build

    smi = smi_line()
    print(f"DEVICE {smi}", flush=True)
    print(f"DEVICE torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} count {torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"BUILD {len(built)} sources in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{n} {s:.1f} s' for n, s in built.items())})", flush=True)
    spills = []
    for name in _build.sources():
        for line in ptxas_lines(_build.build_log(name)):
            print(f"PTXAS {name}: {line}")
            if "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line:
                spills.append(f"{name}: {line}")
    if spills:
        fail(f"ptxas spilled in {len(spills)} instances: {spills}")
    from repro_torch.kernels.flash_attn.ops import RANK_TILE, occupancy, split_occupancy
    for dk, dv in ((256, 256), (192, 128), (96, 64)):   # one block an SM each
        for bq in (32, 64):
            blocks, smem = occupancy(dk, dv, bq)
            print(f"OCCUPANCY flash_attn f32 (q/k {dk}, v {dv}) {bq}-row q tile: "
                  f"{blocks} blocks an SM, {smem} bytes of shared memory a block", flush=True)
    for ranks in (3, 4, 5):   # the clusters of the rows past 256 run below (272, 512, 528)
        blocks, clusters, smem = split_occupancy(ranks)
        print(f"OCCUPANCY flash_attn f32 rows past 256 split over {ranks} ranks of "
              f"{RANK_TILE}, 32-row q tile: {blocks} blocks an SM, {clusters} clusters at "
              f"once, {smem} bytes of shared memory a block", flush=True)

    t0 = time.perf_counter()
    rows = check_kernels(torch)
    print(f"PHASE kernels {time.perf_counter() - t0:.1f} s", flush=True)
    launches, serve_rows = {n: 0 for n in KERNELS}, {}
    for spec in SERVES:
        t0 = time.perf_counter()
        got, res, tok_s, served = serve_path(torch, np, spec)
        print(f"PHASE {spec['tag']} {time.perf_counter() - t0:.1f} s", flush=True)
        for n in KERNELS:
            launches[n] += got[n]
        serve_rows[spec["tag"]] = {"prefill_ms": res["prefill_s"] * 1e3,
                                   "prefill_median_ms": res["prefill_median_ms"],
                                   "decode_tok_s": tok_s, "launches": got}
        if spec.get("profile", True):
            t0 = time.perf_counter()
            prof = profile_path(torch, spec["tag"], *served)
            print(f"PHASE {spec['tag']} profile {time.perf_counter() - t0:.1f} s", flush=True)
            if prof is not None:
                serve_rows[spec["tag"]].update(decode_wall_us=prof[0], decode_busy_us=prof[1])
            if "absorbed_ms" in res and prof is not None:
                share = res["absorbed_ms"] * 1e3 / prof[1]
                serve_rows[spec["tag"]].update(absorbed_ms=res["absorbed_ms"],
                                               absorbed_share_of_busy=share)
                print(f"{spec['tag']} absorbed MLA decode {res['absorbed_ms'] * 1e3:.1f} us "
                      f"of {prof[1]:.1f} us device busy a decode step ({share:.3f}; "
                      f"wall {prof[0]:.1f} us)", flush=True)
        del res, served
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got, res, tok_s, prof = serve_sparse_kv(torch, np)
    print(f"PHASE SERVE-SPARSE-KV {time.perf_counter() - t0:.1f} s", flush=True)
    for n in KERNELS:
        launches[n] += got[n]
    serve_rows["SERVE-SPARSE-KV"] = {"prefill_ms": res["prefill_s"] * 1e3,
                                     "prefill_median_ms": res["prefill_median_ms"],
                                     "decode_tok_s": tok_s, "launches": got}
    if prof is not None:
        serve_rows["SERVE-SPARSE-KV"].update(decode_wall_us=prof[0] / 16,
                                             decode_busy_us=prof[1] / 16)
    del res
    torch.cuda.empty_cache()
    unused = [n for n in KERNELS if launches[n] == 0]
    if unused:
        fail(f"kernels never launched on the serving paths: {unused}")

    t0 = time.perf_counter()
    grad_rows = check_grads(torch)
    print(f"PHASE grads {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    got, pftt_rows = train_pftt(torch)
    print(f"PHASE TRAIN-PFTT {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    got_r, roberta_row = train_roberta(torch, np)
    print(f"PHASE TRAIN-ROBERTA {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    got_f, pfit_rows = train_pfit(torch)
    print(f"PHASE TRAIN-PFIT {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    got_p, ppo_row = train_ppo(torch, np)
    print(f"PHASE TRAIN-PPO {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    got_ra, robust_pftt_row = train_robust_pftt(torch)
    got_rb, robust_pfit_row = train_robust_pfit(torch)
    got_rc, robust_ppo_row = train_robust_ppo(torch, np)
    print(f"PHASE TRAIN-ROBUST {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    got_o, oracles_row = train_oracles(torch)
    ENGINE_RUNS.clear()
    print(f"PHASE TRAIN-ORACLES {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    got_c, comms_row = train_comms(torch, np)
    print(f"PHASE TRAIN-COMMS {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    got_pop, pop_row = train_pop(torch, np)
    print(f"PHASE TRAIN-POP {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    got_a, arch_rows = train_arch(torch)
    print(f"PHASE ARCH-ROUND {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    got_m, mesh_rows = train_mesh(torch, np)
    print(f"PHASE TRAIN-MESH {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    got_l, launch_row = launch_phase(torch, np)
    print(f"PHASE LAUNCH {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    got_t, tp_row = tp_phase(torch, np)
    print(f"PHASE TP {time.perf_counter() - t0:.1f} s", flush=True)
    for n in KERNELS:
        launches[n] += (got[n] + got_r[n] + got_f[n] + got_p[n] + got_ra[n] + got_rb[n]
                        + got_rc[n] + got_o[n] + got_c[n] + got_pop[n] + got_a[n] + got_m[n]
                        + got_l[n] + got_t[n])

    kernels = [dict(name=n, route="cuda", source=f"src/repro_torch/csrc/{n}.cu",
                    replaces=REPLACES[n], launches=launches[n],
                    max_abs_err=rows[n]["max_abs_err"], ms=rows[n]["ms"],
                    plain_ms=rows[n]["plain_ms"], bound_ms=rows[n]["bound_ms"],
                    bound_by=rows[n]["bound_by"], library_ms=rows[n]["library_ms"],
                    shape=rows[n]["shape"], dtype=rows[n]["dtype"],
                    **({"read_ms": rows[n]["read_ms"]} if "read_ms" in rows[n] else {}))
               for n in KERNELS]
    print(json.dumps({"serve": serve_rows}))
    print(json.dumps({"train": {"grad": grad_rows, "pftt": pftt_rows,
                                "roberta": roberta_row, "pfit": pfit_rows,
                                "ppo": ppo_row, "robust": {
                                    "pftt": robust_pftt_row, "pfit": robust_pfit_row,
                                    "ppo": robust_ppo_row}, "oracles": oracles_row,
                                "comms": comms_row,
                                "pop": pop_row, "arch_round": arch_rows,
                                "mesh": mesh_rows, "launch": launch_row, "tp": tp_row}}))
    print(json.dumps({"kernels": kernels}))
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(sys.argv[2:])
    elif sys.argv[1:2] == ["--tp-rank"]:
        tp_rank(sys.argv[2:])
    else:
        main()
