"""Dry run of one (architecture × input shape × mesh × step × policy) cell
on ``meta`` tensors, the counterpart of ``repro.launch.dryrun``: rank 0's
program of the production mesh, traced and counted without a buffer or a
card.

The model is built under an abstract ``MeshCtx`` of the (16, 16) or
(2, 16, 16) mesh (``launch/mesh.py``): its parameters are cut to rank 0's
blocks by ``param_specs`` (the ``--shard-policy``), the batch is the whole
one (the model runs rank 0's rows) and every collective records its
logical op and bytes and moves nothing.  Per device it reports the FLOPs
counted on those local shapes (``launch/flop_cost.py``), beside the global
FLOPs counted on the unsharded model — their ratio over the chip count
shows the replicated compute of the plans that gather a weight whole —
the collective bytes by logical op and their wire estimate (an
all-reduce weighted 2×, as the JAX dry run weighs its HLO's), and the
argument bytes of rank 0's shards.  Peak memory cannot be measured on
``meta`` and is null.  The roofline takes the H100 SXM's data-sheet
figures (``launch/mesh.py``).  ``zero1`` computes under ``tp`` with the
optimizer moments under ``fsdp`` (one reduce-scatter of the gradients and
one all-gather of the parameters a step); ``dp`` shards the batch over
every axis (non-MoE only).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k --mesh single [--step auto|train|train_peft|prefill|
        decode|fl_round] [--opts moe_a2a,...] [--shard-policy fsdp]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Results go to ``experiments/dryrun_torch/<arch>_<shape>_<mesh>_<step>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch import trees
from repro_torch.configs import ASSIGNED, SHAPES, get_config
from repro_torch.launch.flop_cost import count_flops
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, make_meshctx
from repro_torch.launch.steps import (make_fl_round_step, make_input_batch_shapes,
                                      make_peft_step, make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import peft as peft_mod
from repro_torch.models.transformer import Model

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def pick_impl(cfg, shape, opts=None):
    """Attention implementation, as the JAX dry run picks it: block-sparse
    for long_500k on attention archs (or everywhere with ``sparse_impl``),
    else auto."""
    if (opts or {}).get("sparse_impl") and not cfg.attention_free:
        return "sparse"
    if shape.name == "long_500k" and not cfg.attention_free:
        return "sparse"
    return "auto"


def layer_param_count(cfg, kind, active_only: bool = False) -> int:
    """One layer's parameter count (``repro.models.blocks``' formula)."""
    d = cfg.d_model
    n = d
    if kind.mixer in ("attn", "local", "enc", "dec"):
        n += d * cfg.n_heads * cfg.hd * 2 + d * cfg.n_kv_heads * cfg.hd * 2
        if kind.mixer == "dec":
            n += d * cfg.n_heads * cfg.hd * 2 + d * cfg.n_kv_heads * cfg.hd * 2 + d
    elif kind.mixer == "mla":
        m = cfg.mla
        qk = m.nope_head_dim + m.rope_head_dim
        n += (d * m.q_lora_rank + m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qk
              + d * (m.kv_lora_rank + m.rope_head_dim) + m.kv_lora_rank
              + m.kv_lora_rank * cfg.n_heads * (m.nope_head_dim + m.v_head_dim)
              + cfg.n_heads * m.v_head_dim * d)
    elif kind.mixer == "mamba":
        s = cfg.ssm
        conv_dim = cfg.d_inner + 2 * s.n_groups * s.state
        proj_out = 2 * cfg.d_inner + 2 * s.n_groups * s.state + cfg.ssm_heads
        n += (d * proj_out + s.conv_width * conv_dim + conv_dim + 3 * cfg.ssm_heads
              + cfg.d_inner + cfg.d_inner * d)
    mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    if kind.ff == "mlp":
        n += d + mult * d * cfg.d_ff
    elif kind.ff == "moe":
        m = cfg.moe
        e = m.top_k if active_only else m.n_experts
        n += d + d * m.n_experts + e * mult * d * m.d_ff
        if m.n_shared_experts:
            n += mult * d * (m.n_shared_experts * m.d_ff)
    return n


def param_count(cfg) -> int:
    """Analytic parameter count (the JAX config's ``param_count``)."""
    total = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    if cfg.pos == "learned":
        total += max(cfg.max_position, 4096) * cfg.d_model
    total += sum(layer_param_count(cfg, k) * s.repeats for s in cfg.stages for k in s.pattern)
    total += cfg.d_model
    if cfg.n_prefix_tokens:
        total += cfg.prefix_dim * cfg.d_model
    if cfg.n_classes:
        total += cfg.d_model * cfg.n_classes
    return total


def active_param_count(cfg) -> int:
    """MoE-aware parameters active per token (``active_param_count``)."""
    total = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    total += sum(layer_param_count(cfg, k, active_only=True) * s.repeats
                 for s in cfg.stages for k in s.pattern)
    return total + cfg.d_model


def analytic_memory_bytes(cfg, shape, step, cache_bytes: int = 0) -> int:
    """First-order HBM traffic of a step, global (the JAX dry run's model):

    train:   4·P(bf16) + 16·N (f32 moments read+write) + 6·L·T·d·2
    prefill: P + 2·L·T·d·2 + cache write
    decode:  P_active + full cache read + small
    """
    n = param_count(cfg)
    p_bytes = n * 2
    t = shape.global_batch * shape.seq_len
    layer_act = cfg.n_layers * cfg.d_model * 2
    if step in ("train", "train_peft", "fl_round"):
        return 4 * p_bytes + 16 * n + 6 * t * layer_act
    if step == "prefill":
        return p_bytes + 2 * t * layer_act + cache_bytes
    return active_param_count(cfg) * 2 + cache_bytes + shape.global_batch * layer_act


def tree_bytes(tree) -> int:
    return sum(v.numel() * v.element_size() for v in trees.flatten(tree).values()
               if isinstance(v, torch.Tensor))


def wire_bytes(record):
    """{logical op: bytes} of a record and the wire estimate (all-reduce
    2×: a reduce-scatter and an all-gather)."""
    totals = {op: 0 for op in OPS}
    for op, n in record:
        totals[op] += n
    wire = (2 * totals["all-reduce"] + totals["all-gather"] + totals["reduce-scatter"]
            + totals["all-to-all"] + totals["collective-permute"])
    return totals, wire


def _programs(model, cfg, shape, step, impl, dtype, n_fl_clients=8):
    """(step function, its arguments, cache bytes) of one model (whole or
    under the mesh): parameters, optimizer state and caches on ``meta``,
    the model's blocks when it has a mesh."""
    params = model.init(None, max_seq=shape.seq_len + 8)
    batch = make_input_batch_shapes(cfg, shape, dtype)

    def local(tree):
        return tree if model.mc is None else model.shard(tree)

    def peft_trees():
        pc = peft_mod.PEFTConfig(lora_rank=16, adapter_dim=64)
        gen = torch.Generator().manual_seed(0)
        full = peft_mod.init_adapters(gen, params, cfg, pc)
        lora = peft_mod.init_lora(gen, full, pc)
        return pc, local(full), lora

    if step == "train":
        fn, opt = make_train_step(model, impl=impl)
        p = local(params)
        return fn, (p, opt.init(p), batch), 0
    if step == "train_peft":
        pc, frozen, lora = peft_trees()
        fn, opt = make_peft_step(model, pc, impl=impl)
        tr = {"adapters": trees.select(frozen, peft_mod.is_adapter_path), "lora": lora}
        return fn, (tr, frozen, opt.init(tr), batch), 0
    if step == "prefill":
        fn = make_prefill_step(model, cache_len=shape.seq_len, impl=impl)
        cache = model.init_cache(shape.global_batch, shape.seq_len)
        return (lambda p, b: fn(p, b)), (local(params), batch), tree_bytes(cache["stages"])
    if step == "decode":
        fn = make_serve_step(model, impl=impl)
        cache = model.init_cache(shape.global_batch, shape.seq_len)
        cache["pos"] = shape.seq_len - 1
        whole = model._alloc_cache(shape.global_batch, shape.seq_len, None, None,
                                   torch.device("meta"))
        tok = torch.zeros(shape.global_batch, 1, dtype=torch.long, device="meta")
        return fn, (local(params), cache, tok), tree_bytes(whole["stages"])
    if step == "fl_round":
        pc, frozen, lora = peft_trees()
        lora_c = trees.map_leaves(lambda t: t.unsqueeze(0).expand(
            (n_fl_clients,) + tuple(t.shape)).contiguous(), lora)
        per_client = {k: torch.empty((n_fl_clients, max(1, v.shape[0] // n_fl_clients))
                                     + tuple(v.shape[1:]), dtype=v.dtype, device="meta")
                      for k, v in batch.items()}
        fn, opt = make_fl_round_step(model, pc, n_fl_clients, impl=impl)
        tr = {"adapters": trees.select(frozen, peft_mod.is_adapter_path), "lora": lora_c}
        return fn, (tr, frozen, opt.init(tr), per_client), 0
    raise ValueError(step)


def run_one(arch: str, shape_name: str, mesh_kind: str, step: str = "auto",
            out_dir: str = "experiments/dryrun_torch", opts=None, policy: str = "fsdp",
            tag: str = "", dtype=torch.bfloat16, verbose: bool = True):
    """Trace and count one cell; write and return its JSON row."""
    opts = dict(opts or {})
    shape = SHAPES[shape_name]
    if opts.pop("sparse_kv", None):
        opts["sparse_kv_seq"] = shape.seq_len
    sparse_impl = opts.pop("sparse_impl", None)
    cfg = get_config(arch)
    impl = pick_impl(cfg, shape, {"sparse_impl": sparse_impl})
    if step == "auto":
        step = {"train": "train", "prefill": "prefill", "decode": "decode"}[shape.kind]
    mc = make_meshctx(multi_pod=mesh_kind == "multi")
    if policy == "dp":
        if any(k.ff == "moe" for st in cfg.stages for k in st.pattern):
            raise ValueError("the dp policy is for non-MoE archs only")
        mc = dataclasses.replace(mc, batch_axes=mc.all_axes)
    p_policy = "tp" if policy == "zero1" else policy
    model = Model(cfg, dtype=dtype, device="meta", impl=impl, remat=True, opts=opts,
                  meshctx=mc, policy=p_policy)
    whole = Model(cfg, dtype=dtype, device="meta", impl=impl, remat=True, opts=opts)

    t0 = time.time()
    fn, args, cache_bytes = _programs(model, cfg, shape, step, impl, dtype)
    mc.record.clear()
    _, local_flops = count_flops(fn, *args)
    record = list(mc.record)
    t_local = time.time() - t0
    t0 = time.time()
    gfn, gargs, _ = _programs(whole, cfg, shape, step, impl, dtype)
    _, global_flops = count_flops(gfn, *gargs)
    t_global = time.time() - t0

    inputs = args[-1]                     # the whole batch (or tokens): rank 0's rows
    rows = model._rows(shape.global_batch)
    arg_bytes = tree_bytes(args[:-1]) + tree_bytes(inputs) // (mc.data_size if rows else 1)
    if policy == "zero1" and step == "train":
        # the moments stay FSDP-sharded: one reduce-scatter of the gradients
        # and one all-gather of the parameters at the update
        pbytes = tree_bytes(args[0])
        fsdp = Model(cfg, dtype=dtype, device="meta", meshctx=mc, policy="fsdp")
        ratio = tree_bytes(fsdp.shard(fsdp.init(None, max_seq=shape.seq_len + 8))) / pbytes
        arg_bytes -= tree_bytes(args[1]) - int(tree_bytes(args[1]) * ratio)
        record += [("reduce-scatter", pbytes // mc.data_size), ("all-gather", pbytes)]
    coll, wire = wire_bytes(record)
    eff_cache = cache_bytes
    if (step == "decode" and impl == "sparse" and opts.get("sparse_gather_decode")
            and cfg.sparse_attn and not cfg.attention_free):
        sp = cfg.sparse_attn
        nb = shape.seq_len // sp.block_size
        a = sp.sink_blocks + sp.local_blocks + max(1, nb // sp.stride)
        eff_cache = int(cache_bytes * min(1.0, a / nb))
    n_chips = mc.size
    mem_global = analytic_memory_bytes(cfg, shape, step, eff_cache)
    compute_s = local_flops["total"] / PEAK_FLOPS_BF16
    memory_s = mem_global / n_chips / HBM_BW
    collective_s = wire / NVLINK_BW
    tokens = shape.global_batch * (shape.seq_len if shape.kind in ("train", "prefill") else 1)
    model_flops = (6 if shape.kind == "train" else 2) * active_param_count(cfg) * tokens
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "step": step, "impl": impl,
        "n_chips": n_chips, "opts": sorted(opts) + (["sparse_impl"] if sparse_impl else []),
        "shard_policy": policy,
        "trace_s": round(t_local, 1), "flop_count_s": round(t_local + t_global, 1),
        "global": {"flops": global_flops["total"], "gemm_flops": global_flops["gemm"],
                   "analytic_hbm_bytes": mem_global, "cache_bytes": cache_bytes},
        "per_device": {
            "flops": local_flops["total"], "gemm_flops": local_flops["gemm"],
            "replication": (local_flops["total"] * n_chips / global_flops["total"]
                            if global_flops["total"] else None),
            "collective_wire_bytes": wire, "collectives": coll,
            "peak_memory_bytes": None, "argument_bytes": arg_bytes, "output_bytes": None},
        "roofline": {"compute_s": compute_s, "memory_s": memory_s,
                     "collective_s": collective_s,
                     "dominant": max([("compute", compute_s), ("memory", memory_s),
                                      ("collective", collective_s)], key=lambda kv: kv[1])[0],
                     "hardware": "H100 SXM data sheet (700 W): bf16 989 TFLOP/s, HBM "
                                 "3.35 TB/s, NVLink 450 GB/s a direction"},
        "model_flops_total": model_flops,
        "useful_flops_ratio": model_flops / global_flops["total"] if global_flops["total"]
        else None,
    }
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    with open(os.path.join(out_dir, f"{arch}_{shape_name}_{mesh_kind}_{step}{suffix}.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    if verbose:
        rf = result["roofline"]
        print(f"[dryrun] {arch:18s} {shape_name:12s} {mesh_kind:6s} {step:10s} OK "
              f"trace={t_local:.0f}s dom={rf['dominant']}")
        print(f"  flops/dev={local_flops['total']:.3e} global={global_flops['total']:.3e} "
              f"replication={result['per_device']['replication']:.3f} "
              f"coll/dev={wire:.3e} args/dev={arg_bytes:.3e}")
        print(f"  roofline/dev: compute={compute_s * 1e3:.2f}ms memory={memory_s * 1e3:.2f}ms "
              f"collective={collective_s * 1e3:.2f}ms")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--step", default="auto")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opts", default="",
                    help="comma list: causal_skip,sparse_gather_decode,moe_a2a,mamba_sp,"
                         "sparse_kv,sparse_impl")
    ap.add_argument("--shard-policy", default="fsdp",
                    choices=["fsdp", "fsdp_experts_only", "tp", "zero1", "dp"])
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    args = ap.parse_args(argv)
    opts = {k: True for k in args.opts.split(",") if k}
    if args.all:
        failures = []
        for arch in ASSIGNED:
            for shape in SHAPES:
                try:
                    run_one(arch, shape, args.mesh, out_dir=args.out, opts=opts,
                            policy=args.shard_policy, tag=args.tag)
                except Exception as e:   # noqa: BLE001 — the matrix reports every cell
                    traceback.print_exc()
                    failures.append((arch, shape, str(e)[:200]))
        print(f"\n{len(failures)} failures: {failures}")
        sys.exit(1 if failures else 0)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    return run_one(args.arch, args.shape, args.mesh, args.step, args.out, opts=opts,
                   policy=args.shard_policy, tag=args.tag)


if __name__ == "__main__":
    main()
