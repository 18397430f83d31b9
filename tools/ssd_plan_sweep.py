#!/usr/bin/env python3
"""Times the SSD scan (``csrc/ssd_chunk.cu``) with each plan, on one NVIDIA
GPU: the measurement behind the plan rule of its source note.

    python3 tools/ssd_plan_sweep.py

It compiles a copy of the committed source into
``src/repro_torch/build/sweep/`` (gitignored) whose ``ssd_fuse`` returns
false (C·Bᵀ in a launch of its own), checks it against the plain version,
and times it beside the library the port builds (the rule: at P 64, C·Bᵀ's
tiles as the first blocks of the chunk states' launch) at SERVE-MAMBA's
prefill (B 4, S 512, H 64, P 64, N 128, chunk 256, B/C shared over the
heads as the mixer passes them, f32 and bf16; f32 also with B/C per head),
a prompt of 8 chunks (B 1, S 2048) and a small grid (B 1, S 512, H 8);
once an empty kernel (the timer's floor).  Cold L2, median of 30 (the timer
of ``chip_smoke.py``).  Prints one SWEEP line per row and plan.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

RULE = "bool ssd_fuse(int P) {"
# (B, S, H, P, N, chunk, dtype, B/C shared over the heads)
ROWS = ((4, 512, 64, 64, 128, 256, "float32", True),
        (4, 512, 64, 64, 128, 256, "bfloat16", True),
        (4, 512, 64, 64, 128, 256, "float32", False),
        (1, 2048, 64, 64, 128, 256, "float32", True),
        (1, 512, 8, 64, 128, 256, "float32", True))


def build_separate():
    """The C entry of a copy whose rule never fuses C·Bᵀ."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_chunk import ops
    src = (_build.CSRC / "ssd_chunk.cu").read_text()
    assert src.count(RULE) == 1, "the plan rule moved"
    out = _build.BUILD / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "ssd_chunk_separate.cu"
    cu.write_text(src.replace(RULE, RULE + " return false;"))
    lib = cu.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
                    str(cu)], check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    fn = getattr(ctypes.CDLL(str(lib)), "ssd_chunk")
    fn.argtypes, fn.restype = ops._ARGTYPES, ctypes.c_int
    return fn


def separate_call(fn, x, dt, a, bm, cm, chunk):
    """``ssd_scan``'s C call (no h0) through the copy ``fn``; returns y."""
    import torch
    from repro_torch.kernels.ssd_chunk import ops
    b, s, h, p = x.shape
    n = bm.shape[-1]
    shared = ops.shared_cb(bm, cm)
    size = ops.workspace_floats(b, s, h, p, n, chunk, shared)
    ws = torch.empty(size, device=x.device)
    y = torch.empty_like(x)
    h_out = torch.empty((b, h, p, n), device=x.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        assert fn(ops.DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                  bm.data_ptr(), cm.data_ptr(), None, y.data_ptr(), h_out.data_ptr(),
                  ws.data_ptr(), size, b, s, h, p, n, chunk, int(shared), *x.stride()[:3],
                  *bm.stride()[:3], *cm.stride()[:3], stream) == 0
        return y
    return call


def main():
    import torch

    import chip_smoke
    from repro_torch.kernels.ssd_chunk import ops
    from repro_torch.kernels.ssd_chunk.ref import ssd_ref

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(f"DEVICE {chip_smoke.smi_line()}", flush=True)
    flush = torch.empty(32 * 1024 * 1024, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    separate = build_separate()
    empty = lambda: torch.cuda._sleep(0)  # an empty kernel: the timer's floor
    print(f"SWEEP ssd_chunk empty ms={chip_smoke.device_ms(empty, flush):.4f}", flush=True)
    for b, s, h, p, n, chunk, dname, shared in ROWS:
        dt = getattr(torch, dname)
        row = (torch.randn(b, s, h * p + 2 * n, generator=g, device="cuda")).to(dt)
        row[..., h * p:] *= 0.5
        x = row[..., :h * p].reshape(b, s, h, p)
        bm = row[..., h * p:h * p + n].reshape(b, s, 1, n).expand(b, s, h, n)
        cm = row[..., h * p + n:].reshape(b, s, 1, n).expand(b, s, h, n)
        if not shared:
            bm, cm = bm.contiguous(), cm.contiguous()
        dts = torch.nn.functional.softplus(torch.randn(b, s, h, generator=g, device="cuda"))
        a = -torch.exp(torch.randn(h, generator=g, device="cuda") * 0.3)
        y_r, _ = ssd_ref(x, dts, a, bm, cm, chunk=chunk)
        atol, rtol = chip_smoke.TOL[("ssd_chunk", dname)]
        rows = [(f"rule (fused {int(ops.ssd_plan(b, s, h, p, n, chunk=chunk))})",
                 lambda: ops.ssd_scan(x, dts, a, bm, cm, chunk=chunk)[0]),
                ("fused=0", separate_call(separate, x, dts, a, bm, cm, chunk))]
        for name, call in rows:
            y = call()
            torch.cuda.synchronize()
            assert torch.allclose(y.float(), y_r.float(), atol=atol, rtol=rtol), name
        label = (f"B={b} S={s} H={h} P={p} N={n} chunk={chunk} "
                 + ("shared" if shared else "per-head"))
        for name, call in rows:
            print(f"SWEEP ssd_chunk {dname} {label} {name} "
                  f"ms={chip_smoke.device_ms(call, flush):.4f}", flush=True)
    print(f"DEVICE {chip_smoke.smi_line()}", flush=True)


if __name__ == "__main__":
    main()
