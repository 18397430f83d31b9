#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA
   versions; exits nonzero when CUDA is unavailable.
2. build   — compiles every CUDA source of ``src/repro_torch/csrc`` with nvcc
   (one process per source, all at once) and prints the ptxas register /
   shared-memory report.
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
4. serve   — three serving paths through the port's entry points
   (``launch/serve.py`` build/generate), each with random weights from seed
   0 and nonzero rank-8 LoRA factors from a numpy seed, f32:
   * SERVE: gpt2-small at full width (12 layers, d 768, vocab 50257),
     batch 8, prompt 128, 64 greedy decode steps;
   * SERVE-SPARSE: the same model with the paper's block-sparse attention
     (``impl="sparse"``, block 128, local 4, sink 1, stride 8), batch 8,
     prompt 896, 128 decode steps (1024 = max_position);
   * SERVE-MAMBA: mamba2-1.3b at full width and depth (48 layers, d 2048,
     64 heads of 64, state 128, vocab 50280), batch 4, prompt 512, 32
     decode steps, LoRA on in_proj and out_proj.
   Each path's kernel launch counts are set to 0 just before it runs and
   checked against the path's just after; prefill is then run 7 more times
   and its median printed beside the run's one prefill; then prefill and
   the first 8 decode steps are re-run on the CPU through the plain versions
   (teacher-forced with the card's tokens, on a subset of the rows) and the
   logits are held to the path's tolerance.
5. profile — torch.profiler over one prefill and 16 decode steps of each
   serving path.

Before the last line it prints one JSON object with a row per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failed check exits
nonzero before that line.
"""
import json
import os
import subprocess
import sys
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
)
TEACHER_STEPS = 8
PREFILL_REPS = 7
SERVING_SPARSE = dict(block_size=128, local_blocks=4, sink_blocks=1, stride=8)


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
        # the last row: the reduced RoBERTa encoder's non-causal attention
        for bsz, s, h, kh, d, window, causal in ((8, 128, 12, 12, 64, 0, True),
                                                 (8, 77, 12, 12, 64, 0, True),
                                                 (2, 200, 8, 2, 32, 96, True),
                                                 (8, 32, 4, 4, 32, 0, False)):
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
                main=(s == 128 and dt == torch.float32)))
        for bsz, sc, h, kh, d, clen, window in ((8, 192, 12, 12, 64, 192, 0),
                                                (8, 192, 12, 12, 64, 101, 0),
                                                (8, 192, 12, 12, 64, 1, 0),
                                                (2, 256, 8, 4, 128, 201, 64)):
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
                library=(None if h != kh else lambda q=qt, k=kt, v=vt:
                         F.scaled_dot_product_attention(q, k, v)),
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
    # N 2048, at prefill (M 2048) and decode (M 4); the decode rows in bf16 too
    for m, k, n, path, dt in ((7168, 768, 768, "sparse", torch.float32),
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
    from repro_torch.kernels.ssd_chunk.ops import shared_cb, ssd_plan, ssd_scan
    from repro_torch.kernels.ssd_chunk.ref import ssd_ref

    cases = []
    for bsz, s, h, p, n, chunk, with_h0 in ((4, 512, 64, 64, 128, 256, False),
                                            (4, 300, 64, 64, 128, 256, False),
                                            (4, 512, 64, 64, 128, 256, True),
                                            (1, 2048, 64, 64, 128, 256, False)):
        if dt == torch.bfloat16 and (s != 512 or with_h0):
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
            ssd=f"fused={int(ssd_plan(bsz, s, h, p, n, chunk=chunk))} cb_groups={groups} ",
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


# ---------------------------------------------------------------- serving
def wrappers():
    from repro_torch.kernels.block_sparse_attn.ops import block_sparse_attention
    from repro_torch.kernels.decode_attn.ops import decode_attention
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.lora_fused.ops import lora_matmul
    from repro_torch.kernels.ssd_chunk.ops import ssd_scan
    return dict(zip(KERNELS, (lora_matmul, flash_attention, decode_attention,
                              block_sparse_attention, ssd_scan)))


def expected_launches(model, lora, impl, gen):
    """Each kernel's launches on one prefill plus ``gen`` decode steps."""
    from repro_torch import trees
    cfg = model.cfg
    kinds = [k for st in cfg.stages for k in st.pattern for _ in range(st.repeats)]
    n_attn = sum(k.mixer == "attn" for k in kinds)
    n_mamba = sum(k.mixer == "mamba" for k in kinds)
    n_lora = sum(v.shape[0] for p, v in trees.flatten(lora).items() if p.endswith("/a"))
    sparse = impl == "sparse" and cfg.sparse_attn is not None
    return {"lora_fused": n_lora * (1 + gen),
            "flash_attn": 0 if sparse else n_attn,
            "decode_attn": n_attn * gen,
            "block_sparse_attn": n_attn if sparse else 0,
            "ssd_chunk": n_mamba}


def serve_path(torch, np, spec):
    """One serving path at full width through ``serve.build``/``generate``:
    launch counts against the path's, then a teacher-forced CPU re-run of
    ``spec["rows"]`` rows through the plain versions."""
    from repro_torch import trees
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model

    tag, t_start = spec["tag"], time.perf_counter()
    args = serve.parse_args(["--arch", spec["arch"], "--batch", str(spec["batch"]),
                             "--prompt-len", str(spec["prompt_len"]),
                             "--gen", str(spec["gen"]),
                             "--lora-rank", str(spec["rank"])])
    model, params, lora, lscale, prompts = serve.build(args, impl=spec["impl"])
    # init_lora zeros B: load nonzero A and B from a numpy seed so the
    # rank-r path does real work
    rng = np.random.RandomState(1)
    lora = trees.map_with_path(
        lambda p, v: v if p.endswith("/mask") else torch.from_numpy(
            (rng.randn(*v.shape) * 0.05).astype(np.float32)).to(v.device), lora)
    t_built = time.perf_counter()

    serve.generate(model, params, prompts, 2, lora=lora, lora_scale=lscale)  # warm-up
    kernels = wrappers()
    for f in kernels.values():
        f.launches = 0
    res = serve.generate(model, params, prompts, args.gen, lora=lora, lora_scale=lscale)
    launches = {n: f.launches for n, f in kernels.items()}
    expected = expected_launches(model, lora, spec["impl"], args.gen)
    tok_s = args.batch * args.gen / res["decode_s"]
    # prefill again, PREFILL_REPS times: its median moves less with the host
    # than the single prefill of the run
    reps = []
    for _ in range(PREFILL_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, prompts, prompts.shape[1] + args.gen, lora=lora, lora_scale=lscale)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) * 1e3)
    res["prefill_median_ms"] = sorted(reps)[PREFILL_REPS // 2]
    print(f"{tag} {spec['arch']} full width ({model.cfg.n_layers} layers, impl "
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
    lg, cache = cpu.prefill(p_cpu, prompts[:rows].cpu(), prompts.shape[1] + args.gen,
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
    return launches, res, tok_s, (model, params, lora, lscale, prompts)


def profile(torch, label, run, reps):
    """torch.profiler over ``reps`` calls of ``run``: the device's busy
    share of the wall time and the kernels that fill it, per call.  Prints
    'not measured' when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    if not by_name:
        print(f"PROFILE {label}: no device events in the trace (not measured)")
        return
    busy = sum(t for _, t in by_name.values())
    print(f"PROFILE {label} x{reps}: wall_us_per_call={wall_us / reps:.1f} "
          f"device_busy_us_per_call={busy / reps:.1f} "
          f"device_busy_share={busy / wall_us:.3f}")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"PROFILE   {t / reps:10.1f} us/call  {n / reps:6.1f} calls/call  {name[:90]}")


def profile_path(torch, tag, model, params, lora, lscale, prompts, steps=16):
    """One prefill, then ``steps`` decode steps, each under the profiler."""
    state = {}

    def prefill():
        state["logits"], state["cache"] = model.prefill(
            params, prompts, prompts.shape[1] + steps, lora=lora, lora_scale=lscale)

    def decode():
        state["logits"], state["cache"] = model.decode_step(
            params, state["cache"], state["logits"].argmax(-1, keepdim=True),
            lora=lora, lora_scale=lscale)

    profile(torch, f"{tag} prefill", prefill, 1)
    profile(torch, f"{tag} decode", decode, steps)


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
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"PTXAS {name}: {line.strip()}")

    t0 = time.perf_counter()
    rows = check_kernels(torch)
    print(f"PHASE kernels {time.perf_counter() - t0:.1f} s", flush=True)
    launches, serve_rows = {n: 0 for n in KERNELS}, {}
    for spec in SERVES:
        got, res, tok_s, served = serve_path(torch, np, spec)
        for n in KERNELS:
            launches[n] += got[n]
        serve_rows[spec["tag"]] = {"prefill_ms": res["prefill_s"] * 1e3,
                                   "prefill_median_ms": res["prefill_median_ms"],
                                   "decode_tok_s": tok_s, "launches": got}
        t0 = time.perf_counter()
        profile_path(torch, spec["tag"], *served)
        print(f"PHASE {spec['tag']} profile {time.perf_counter() - t0:.1f} s", flush=True)
        del res, served
        torch.cuda.empty_cache()
    unused = [n for n in KERNELS if launches[n] == 0]
    if unused:
        fail(f"kernels never launched on the serving paths: {unused}")

    kernels = [dict(name=n, route="cuda", source=f"src/repro_torch/csrc/{n}.cu",
                    replaces=REPLACES[n], launches=launches[n],
                    max_abs_err=rows[n]["max_abs_err"], ms=rows[n]["ms"],
                    plain_ms=rows[n]["plain_ms"], bound_ms=rows[n]["bound_ms"],
                    bound_by=rows[n]["bound_by"], library_ms=rows[n]["library_ms"],
                    shape=rows[n]["shape"], dtype=rows[n]["dtype"],
                    **({"read_ms": rows[n]["read_ms"]} if "read_ms" in rows[n] else {}))
               for n in KERNELS]
    print(json.dumps({"serve": serve_rows}))
    print(json.dumps({"kernels": kernels}))
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
