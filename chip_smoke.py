#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA
   versions; exits nonzero when CUDA is unavailable.
2. build   — compiles every CUDA source of ``src/repro_torch/csrc`` with nvcc
   (one process per source, all at once) and prints the ptxas register /
   shared-memory report.
3. kernels — calls each kernel's wrapper on the card at the serving path's
   shapes, in f32 and bf16, and holds it against its plain PyTorch version
   (tolerances of tests/test_kernels.py); times the kernel, the plain version
   and one PyTorch library call of the same function, each on a cold L2
   (median of 30 calls).
4. serve   — gpt2-small at full width (12 layers, d 768, vocab 50257), random
   weights from seed 0 and nonzero rank-8 LoRA factors from a numpy seed,
   through the port's serving entry points: batch 8, prompt 128, 64 greedy
   decode steps, f32.  Checks every kernel's launch count against the
   path's, then re-runs prefill and the first 8 decode steps on the CPU
   through the plain versions (teacher-forced with the card's tokens) and
   holds the logits to 1e-3.

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
TOL = {("lora_fused", "float32"): 1e-4, ("lora_fused", "bfloat16"): 3e-2,
       ("flash_attn", "float32"): 2e-5, ("flash_attn", "bfloat16"): 2e-2,
       ("decode_attn", "float32"): 2e-5, ("decode_attn", "bfloat16"): 3e-2}
SERVE = dict(batch=8, prompt_len=128, gen=64, rank=8)
TEACHER_STEPS = 8
LOGIT_TOL = 1e-3


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


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- kernels
def kernel_cases(torch):
    """(name, label, kernel call, plain call, library call, bytes, flops,
    dtype) at the serving path's shapes plus ragged and GQA/window cases."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn.ops import decode_attention
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
                main=(m == 8 and dt == torch.float32)))
        for bsz, s, h, kh, d, window in ((8, 128, 12, 12, 64, 0), (8, 77, 12, 12, 64, 0),
                                         (2, 200, 8, 2, 32, 96)):
            q, kk, vv = rn(bsz, s, h, d, dtype=dt), rn(bsz, s, kh, d, dtype=dt), rn(bsz, s, kh, d, dtype=dt)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kk, vv))
            allowed = sum(min(i + 1, window) if window else i + 1 for i in range(s))
            cases.append(dict(
                name="flash_attn", label=f"B={bsz} S={s} H={h} K={kh} hd={d} causal window={window}",
                dtype=dname,
                kernel=lambda q=q, k=kk, v=vv, w=window: flash_attention(q, k, v, causal=True, window=w),
                plain=lambda q=q, k=kk, v=vv, w=window: attention_ref(q, k, v, causal=True, window=w),
                library=(None if window or h != kh else lambda q=qt, k=kt, v=vt:
                         F.scaled_dot_product_attention(q, k, v, is_causal=True)),
                nbytes=(2 * bsz * s * h * d + 2 * bsz * s * kh * d) * es,
                flops=4 * d * allowed * bsz * h,
                main=(s == 128 and dt == torch.float32)))
        for bsz, sc, h, kh, d, clen, window in ((8, 192, 12, 12, 64, 192, 0),
                                                (8, 192, 12, 12, 64, 101, 0),
                                                (8, 192, 12, 12, 64, 1, 0),
                                                (2, 256, 8, 4, 128, 201, 64)):
            q, kc, vc = rn(bsz, 1, h, d, dtype=dt), rn(bsz, sc, kh, d, dtype=dt), rn(bsz, sc, kh, d, dtype=dt)
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
                main=(clen == 192 and dt == torch.float32)))
    return cases


def check_kernels(torch):
    rows = {}
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")  # 128 MB > L2
    for c in kernel_cases(torch):
        out = c["kernel"]()
        ref = c["plain"]()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[(c["name"], c["dtype"])]
        ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        ms = device_ms(c["kernel"], flush)
        plain_ms = device_ms(c["plain"], flush)
        lib_ms = device_ms(c["library"], flush) if c["library"] else None
        b_ms, b_by = bound(c["nbytes"], c["flops"], c["dtype"])
        lib_txt = f"{lib_ms:.4f}" if lib_ms is not None else "none"
        print(f"CHECK {c['name']:<11} {c['dtype']:<8} {c['label']:<48} "
              f"max_abs_err={err:.3e} tol={tol:g} {'ok' if ok else 'MISMATCH'} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_txt} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        if not ok:
            fail(f"{c['name']} {c['dtype']} {c['label']}: max_abs_err {err:.3e} > {tol:g}")
        if c["main"]:
            rows[c["name"]] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                   bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                                   shape=c["label"], dtype=c["dtype"])
    return rows


# ---------------------------------------------------------------- serving
def serve_full_width(torch, np):
    from repro_torch import trees
    from repro_torch.kernels.decode_attn.ops import decode_attention
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.lora_fused.ops import lora_matmul
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model

    args = serve.parse_args(["--arch", "gpt2-small", "--batch", str(SERVE["batch"]),
                             "--prompt-len", str(SERVE["prompt_len"]),
                             "--gen", str(SERVE["gen"]),
                             "--lora-rank", str(SERVE["rank"])])
    model, params, lora, lscale, prompts = serve.build(args)
    # init_lora zeros B: load nonzero A and B from a numpy seed so the
    # rank-r path does real work
    rng = np.random.RandomState(1)
    lora = trees.map_with_path(
        lambda p, v: v if p.endswith("/mask") else torch.from_numpy(
            (rng.randn(*v.shape) * 0.05).astype(np.float32)).to(v.device), lora)
    n_lora = sum(v.shape[0] for p, v in trees.flatten(lora).items() if p.endswith("/a"))
    n_attn = model.cfg.n_layers

    serve.generate(model, params, prompts, 2, lora=lora, lora_scale=lscale)  # warm-up
    wrappers = (lora_matmul, flash_attention, decode_attention)
    for f in wrappers:
        f.launches = 0
    res = serve.generate(model, params, prompts, args.gen, lora=lora, lora_scale=lscale)
    launches = dict(zip(("lora_fused", "flash_attn", "decode_attn"),
                        (f.launches for f in wrappers)))
    expected = {"lora_fused": n_lora * (1 + args.gen), "flash_attn": n_attn,
                "decode_attn": n_attn * args.gen}
    tok_s = args.batch * args.gen / res["decode_s"]
    print(f"SERVE gpt2-small full width: batch {args.batch} prompt {args.prompt_len} "
          f"gen {args.gen} rank {args.lora_rank} f32  prefill_ms={res['prefill_s'] * 1e3:.3f} "
          f"decode_s={res['decode_s']:.4f} decode_tok_s={tok_s:.1f} "
          f"ms_per_decode_step={res['decode_s'] / args.gen * 1e3:.3f}", flush=True)
    print(f"SERVE launches {launches} expected {expected}", flush=True)
    if launches != expected:
        fail(f"kernel launches {launches} != expected {expected}")
    toks = res["tokens"]
    if toks.shape != (args.batch, args.gen) or not bool(
            ((toks >= 0) & (toks < model.cfg.vocab_size)).all()):
        fail(f"bad tokens {tuple(toks.shape)}")
    if not all(bool(torch.isfinite(lg).all()) for lg in res["logits"]):
        fail("non-finite logits")

    # teacher-forced CPU re-run through the plain versions
    cpu = Model(model.cfg, device="cpu")
    p_cpu = trees.map_with_path(lambda _, v: v.cpu(), params)
    l_cpu = trees.map_with_path(lambda _, v: v.cpu(), lora)
    t0 = time.perf_counter()
    lg, cache = cpu.prefill(p_cpu, prompts.cpu(), prompts.shape[1] + args.gen,
                            lora=l_cpu, lora_scale=lscale)
    errs = [(lg - res["logits"][0].cpu()).abs().max().item()]
    for t in range(TEACHER_STEPS):
        lg, cache = cpu.decode_step(p_cpu, cache, toks[:, t:t + 1].cpu(),
                                    lora=l_cpu, lora_scale=lscale)
        errs.append((lg - res["logits"][t + 1].cpu()).abs().max().item())
    print(f"SERVE teacher-forced CPU logits max_abs_err per step "
          f"{[f'{e:.2e}' for e in errs]} (tol {LOGIT_TOL:g}, "
          f"CPU {time.perf_counter() - t0:.1f} s)", flush=True)
    if max(errs) > LOGIT_TOL:
        fail(f"card vs CPU logits differ by {max(errs):.3e} > {LOGIT_TOL:g}")
    return launches, res, tok_s, (model, params, lora, lscale, prompts)


def profile_decode(torch, model, params, lora, lscale, prompts, steps=16):
    """torch.profiler over ``steps`` decode steps of the serving path: the
    device's busy share of the loop's wall time and the kernels that fill
    it.  Prints 'not measured' when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    logits, cache = model.prefill(params, prompts, prompts.shape[1] + steps,
                                  lora=lora, lora_scale=lscale)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = model.decode_step(params, cache, logits.argmax(-1, keepdim=True),
                                              lora=lora, lora_scale=lscale)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    if not by_name:
        print("PROFILE decode: no device events in the trace (not measured)")
        return
    busy = sum(t for _, t in by_name.values())
    print(f"PROFILE decode {steps} steps: wall_us_per_step={wall_us / steps:.1f} "
          f"device_busy_us_per_step={busy / steps:.1f} "
          f"device_busy_share={busy / wall_us:.3f}")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"PROFILE   {t / steps:9.1f} us/step  {n // steps:3d} calls/step  {name[:90]}")


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

    rows = check_kernels(torch)
    launches, res, tok_s, served = serve_full_width(torch, np)
    profile_decode(torch, *served)

    replaces = {"lora_fused": "src/repro/kernels/lora_fused/kernel.py:69",
                "flash_attn": "src/repro/kernels/flash_attn/kernel.py:85",
                "decode_attn": "src/repro/kernels/decode_attn/kernel.py:92"}
    kernels = [dict(name=n, route="cuda", source=f"src/repro_torch/csrc/{n}.cu",
                    replaces=replaces[n], launches=launches[n],
                    max_abs_err=rows[n]["max_abs_err"], ms=rows[n]["ms"],
                    plain_ms=rows[n]["plain_ms"], bound_ms=rows[n]["bound_ms"],
                    bound_by=rows[n]["bound_by"], library_ms=rows[n]["library_ms"],
                    shape=rows[n]["shape"], dtype=rows[n]["dtype"])
               for n in ("lora_fused", "flash_attn", "decode_attn")]
    print(json.dumps({"serve": {"prefill_ms": res["prefill_s"] * 1e3,
                                "decode_tok_s": tok_s}}))
    print(json.dumps({"kernels": kernels}))
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
