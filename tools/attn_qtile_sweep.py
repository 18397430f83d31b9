#!/usr/bin/env python3
"""Times the prefill attention kernels with each q tile forced, on one
NVIDIA GPU: the measurement behind the q-tile rule of
``src/repro_torch/csrc/flash_attn.cu`` and ``block_sparse_attn.cu``.

    python3 tools/attn_qtile_sweep.py

For each kernel it compiles two copies of the committed source into
``src/repro_torch/build/sweep/`` (gitignored), with the rule's condition
replaced by ``true`` (64-row q tile) and by ``false`` (32-row q tile), and
times each, and the library the port builds (the rule itself), at the
serving shapes and around the rule's edge: f32, cold L2, median of 30 (the
timer of ``chip_smoke.py``).  Prints one SWEEP line per shape and tile.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

RULES = {"flash_attn": "blocks64 >= 2LL * repro::sm_count()",
         "block_sparse_attn": "block > 32 && blocks64 >= 2LL * repro::sm_count()"}


def build(name, forced):
    from repro_torch.kernels import _build
    src = (_build.CSRC / f"{name}.cu").read_text()
    assert RULES[name] in src, f"{name}: the q-tile rule moved"
    out = _build.BUILD / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{name}_{forced}.cu"
    cu.write_text(src.replace(RULES[name], forced))
    lib = cu.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(lib), str(cu)], check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.restype = ctypes.c_int
    return fn


def main():
    import torch

    import chip_smoke
    from repro_torch.configs import SparseAttnConfig
    from repro_torch.kernels.block_sparse_attn import ops as bsa_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(f"DEVICE {chip_smoke.smi_line()}", flush=True)
    flush = torch.empty(32 * 1024 * 1024, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    libs = {n: {"64": build(n, "true"), "32": build(n, "false")} for n in RULES}
    for b, s, h, causal in ((8, 128, 12, True), (8, 77, 12, True), (8, 256, 12, True),
                            (8, 512, 12, True), (8, 32, 4, False)):
        d = 64 if h == 12 else 32
        q, k, v = rn(b, s, h, d), rn(b, s, h, d), rn(b, s, h, d)
        ref = flash_ops.flash_attention(q, k, v, causal=causal)
        for tile, fn in [("rule", None), *libs["flash_attn"].items()]:
            out = torch.empty_like(q)
            if fn is None:
                call = lambda: flash_ops.flash_attention(q, k, v, causal=causal)
            else:
                fn.argtypes = flash_ops._ARGTYPES
                call = lambda fn=fn, out=out: fn(0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                 out.data_ptr(), None, b, s, s, h, h, d, d, 0, d,
                                                 d, int(causal), 0, d ** -0.5, stream)
            r = call()
            if fn is not None:
                assert r == 0, r
                torch.cuda.synchronize()
                assert torch.allclose(out, ref, atol=2e-5, rtol=2e-5)
            ms = chip_smoke.device_ms(call, flush)
            print(f"SWEEP flash_attn B={b} S={s} H={h} hd={d} causal={int(causal)} "
                  f"q_tile={tile} ms={ms:.4f}", flush=True)
    for b, s, h, cfg in ((8, 896, 12, SparseAttnConfig(block_size=128, local_blocks=4,
                                                          sink_blocks=1, stride=8)),
                         (2, 896, 12, SparseAttnConfig(block_size=128, local_blocks=4,
                                                          sink_blocks=1, stride=8)),
                         (8, 512, 12, SparseAttnConfig(block_size=64, local_blocks=2,
                                                          sink_blocks=1, stride=4))):
        d, bs = 64, cfg.block_size
        q, k, v = rn(b, s, h, d), rn(b, s, h, d), rn(b, s, h, d)
        ref = bsa_ops.block_sparse_attention(q, k, v, cfg)
        idx, valid = bsa_ops.device_table(s // bs, s // bs, cfg, 0, q.device)
        for tile, fn in [("rule", None), *libs["block_sparse_attn"].items()]:
            out = torch.empty_like(q)
            if fn is None:
                call = lambda: bsa_ops.block_sparse_attention(q, k, v, cfg)
            else:
                fn.argtypes = bsa_ops._ARGTYPES
                call = lambda fn=fn, out=out: fn(0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                 out.data_ptr(), None, idx.data_ptr(),
                                                 valid.data_ptr(), b, s, s, h, h, d, d, 0,
                                                 d, d, bs, idx.shape[1], 0, d ** -0.5, stream)
            r = call()
            if fn is not None:
                assert r == 0, r
                torch.cuda.synchronize()
                assert torch.allclose(out, ref, atol=2e-5, rtol=2e-5)
            ms = chip_smoke.device_ms(call, flush)
            print(f"SWEEP block_sparse_attn B={b} S={s} H={h} hd={d} block={bs} "
                  f"q_tile={tile} ms={ms:.4f}", flush=True)
    print(f"DEVICE {chip_smoke.smi_line()}", flush=True)


if __name__ == "__main__":
    main()
