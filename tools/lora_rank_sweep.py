#!/usr/bin/env python3
"""Times the fused LoRA kernel's routes for a rank above 32, on one NVIDIA
GPU: the measurement behind the rank rule of
``src/repro_torch/csrc/lora_fused.cu``.

    python3 tools/lora_rank_sweep.py

Route (a) forms x·A for ranks up to 64 in the decode branch's main loop
(lane q owns ranks q and q + 32); route (b) writes round(x·A) into an M × r
workspace by a first launch and reads it in the epilogue.  The port takes
(a) at 4 < M ≤ 16 (at M ≤ 4 64 ranks spill) and (b) elsewhere above rank
32.  The script compiles a copy of the committed source whose rule
(``loop_ranks``) returns 32, so every call above rank 32 takes (b), into
``src/repro_torch/build/sweep/`` (gitignored), prints its ptxas register and
spill lines, checks the port and the copy against the plain version and
times each, in turns with the library call (``torch.matmul`` of the merged
weight), at llama3.2-1b's wq and wv shapes (K 2048; N 2048 and 512) for
prefill (M 4096, where both take (b)) and decode (M 8) at rank 64, f32 and
bf16: cold L2, median of 30 (the timer of ``chip_smoke.py``).  Prints one
SWEEP line per shape and route.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

RULE = "  return M > 4 && M <= 16 ? SKINNY_LOOP : RMAX;\n"
# (M, K, N, r, dtype): llama3.2-1b's wq and wv at prefill (batch 8 × 512)
# and decode (batch 8)
SHAPES = tuple((m, 2048, n, 64, d) for d in ("float32", "bfloat16")
               for m in (4096, 8) for n in (2048, 512))


def build_workspace_route():
    """The committed source with x·A through the workspace above rank 32 in
    every branch."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "lora_fused.cu").read_text()
    assert RULE in src, "the rank rule moved"
    out = _build.BUILD / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "lora_fused_workspace_route.cu"
    cu.write_text(src.replace(RULE, "  return RMAX;\n"))
    lib = cu.with_suffix(".so")
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                          str(lib), str(cu)], check=True, capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(str(lib)), "lora_fused")
    fn.restype = ctypes.c_int
    return fn, res.stdout + res.stderr


def main():
    import torch

    import chip_smoke
    from repro_torch.kernels.lora_fused import ops
    from repro_torch.kernels.lora_fused.ref import lora_ref

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(f"DEVICE {chip_smoke.smi_line()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(32 * 1024 * 1024, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    other, log = build_workspace_route()
    other.argtypes = ops._ARGTYPES
    for line in chip_smoke.ptxas_lines(log):
        print(f"PTXAS workspace route: {line}", flush=True)
    for m, k, n, r, dname in SHAPES:
        dt = getattr(torch, dname)
        x = torch.randn(m, k, generator=g, device="cuda").to(dt)
        w = (torch.randn(k, n, generator=g, device="cuda") * 0.02).to(dt)
        a = (torch.randn(k, r, generator=g, device="cuda") * 0.02).to(dt)
        b = (torch.randn(r, n, generator=g, device="cuda") * 0.05).to(dt)
        ref = lora_ref(x, w, a, b, scale=2.0)
        atol = chip_smoke.TOL[("lora_fused", dname)][0]
        merged = (w.float() + 2.0 * (a.float() @ b.float())).to(dt)
        out = torch.empty(m, n, dtype=dt, device="cuda")
        ws = torch.empty(m, r, dtype=dt, device="cuda")

        def other_route():
            return other(ops.DTYPES[dt], x.data_ptr(), w.data_ptr(), a.data_ptr(),
                         b.data_ptr(), ws.data_ptr(), out.data_ptr(), m, n, k, r, 2.0, stream)

        assert other_route() == 0
        torch.cuda.synchronize()
        assert torch.allclose(out.float(), ref.float(), atol=atol, rtol=atol), "other route"
        got = ops.lora_matmul(x, w, a, b, scale=2.0)
        assert torch.allclose(got.float(), ref.float(), atol=atol, rtol=atol), "the port's"
        es = torch.finfo(dt).bits // 8
        b_ms, b_by = chip_smoke.bound((m * k + k * n + k * r + r * n + m * n) * es,
                                      2 * m * k * n + 2 * m * k * r + 2 * m * r * n, dname)
        port = "a_loop64" if 4 < m <= 16 else "b_workspace"
        rows = [(f"{port} (the port)", lambda: ops.lora_matmul(x, w, a, b, scale=2.0)),
                ("library", lambda: torch.matmul(x, merged))]
        if port != "b_workspace":
            rows.insert(1, ("b_workspace", other_route))
        for label, call in rows + rows[::-1]:
            ms = chip_smoke.device_ms(call, flush)
            print(f"SWEEP lora_rank {dname} M={m} K={k} N={n} r={r} {label} ms={ms:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
    print(f"DEVICE {chip_smoke.smi_line()}", flush=True)


if __name__ == "__main__":
    main()
