#!/usr/bin/env python3
"""Times the decode branch of the fused LoRA kernel (``lora_skinny``, M ≤ 16)
with each K split forced, on one NVIDIA GPU: the measurement behind the
split rule of ``src/repro_torch/csrc/lora_fused.cu``.

    python3 tools/lora_skinny_sweep.py

It compiles copies of the committed source into
``src/repro_torch/build/sweep/`` (gitignored) whose ``skinny_split`` returns
1, 2, 4, 8 or 16, checks each against the plain version, and times each, the
library the port builds (the rule itself), ``torch.matmul`` of the merged
weight and ``torch.sum`` of W (a plain read of the bytes the call must
stream) at the serving decode shapes: cold L2, median of 30 (the timer of
``chip_smoke.py``).  Each is timed a second time with the L2 evicted by a
read of the flush buffer instead of a write (``clean_ms``): the write leaves
up to 50 MB of dirty lines that a large read must write back.  Prints one
SWEEP line per shape and variant.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

RULE = "int skinny_split(int strips, int K, int sms) {\n"
SPLITS = (1, 2, 4, 8, 16)
# (M, K, N, dtype): gpt2-small's decode projections at batch 8 and 12,
# mamba2-1.3b's in_proj and out_proj at batch 4
SHAPES = ((8, 768, 768, "float32"), (12, 768, 768, "float32"),
          (4, 2048, 8512, "float32"), (4, 4096, 2048, "float32"),
          (8, 768, 768, "bfloat16"), (4, 4096, 2048, "bfloat16"))


class ReadFlush:
    """Stands in for ``chip_smoke.device_ms``'s flush buffer: evicts the L2
    by reading 128 MB, so the lines it leaves behind are clean."""

    def __init__(self, buf):
        self.buf = buf

    def zero_(self):
        self.buf.sum()


def build(split):
    from repro_torch.kernels import _build
    src = (_build.CSRC / "lora_fused.cu").read_text()
    assert RULE in src, "the split rule moved"
    out = _build.BUILD / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"lora_fused_split{split}.cu"
    cu.write_text(src.replace(RULE, RULE + f"  return {split};\n"))
    lib = cu.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(lib), str(cu)], check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(lib)), "lora_fused")
    fn.restype = ctypes.c_int
    return fn


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
    libs = {s: build(s) for s in SPLITS}
    for m, k, n, dname in SHAPES:
        dt = getattr(torch, dname)
        x = torch.randn(m, k, generator=g, device="cuda").to(dt)
        w = (torch.randn(k, n, generator=g, device="cuda") * 0.02).to(dt)
        a = (torch.randn(k, 8, generator=g, device="cuda") * 0.02).to(dt)
        b = (torch.randn(8, n, generator=g, device="cuda") * 0.05).to(dt)
        ref = lora_ref(x, w, a, b, scale=2.0)
        atol = chip_smoke.TOL[("lora_fused", dname)][0]
        merged = (w.float() + 2.0 * (a.float() @ b.float())).to(dt)
        rows = [("rule", lambda: ops.lora_matmul(x, w, a, b, scale=2.0)),
                ("library", lambda: torch.matmul(x, merged)),
                ("read_w", lambda: w.sum())]
        for split, fn in libs.items():
            fn.argtypes = ops._ARGTYPES
            out = torch.empty(m, n, dtype=dt, device="cuda")
            call = (lambda fn=fn, out=out: fn(ops.DTYPES[dt], x.data_ptr(), w.data_ptr(),
                                              a.data_ptr(), b.data_ptr(), None, out.data_ptr(),
                                              m, n, k, 8, 2.0, stream))
            assert call() == 0
            torch.cuda.synchronize()
            assert torch.allclose(out.float(), ref.float(), atol=atol, rtol=atol), split
            rows.append((f"split={split}", call))
        for label, call in rows:
            ms = chip_smoke.device_ms(call, flush)
            clean = chip_smoke.device_ms(call, ReadFlush(flush))
            print(f"SWEEP lora_skinny {dname} M={m} K={k} N={n} r=8 {label} ms={ms:.4f} "
                  f"clean_ms={clean:.4f}", flush=True)
    print(f"DEVICE {chip_smoke.smi_line()}", flush=True)


if __name__ == "__main__":
    main()
