#!/usr/bin/env python3
"""Times the flash-decode kernel (``csrc/decode_attn.cu``) with each cluster
size (split) forced, on one NVIDIA GPU: the measurement behind the split
rule of its source note.

    python3 tools/decode_split_sweep.py

It compiles copies of the committed source into
``src/repro_torch/build/sweep/`` (gitignored) whose ``decode_split``
returns 1, 2, 4, 8 or 16, checks each against the plain version, and times
each, the library the port builds (the rule itself),
``F.scaled_dot_product_attention`` over the positions read (with the sparse
pattern as a mask) and ``torch.sum`` over the K and V positions the call
reads (a plain read of the bytes it must stream) at SERVE's dense decode,
SERVE-SPARSE's decode at cache_len 897 and 1024, and the GQA / window row of
``chip_smoke.py``, and once an empty kernel (the timer's floor): cold L2,
median of 30 (the timer of ``chip_smoke.py``).
Each is timed a second time with the L2 evicted by a read of the flush
buffer instead of a write (``clean_ms``).  Prints one SWEEP line per row and
variant.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)

RULE = "int decode_split(int bh, int positions_max, int sms, int minb) {\n"
SPLITS = (1, 2, 4, 8, 16)
# (B, Sc, H, K, hd, cache_len, window, sparse, dtype)
ROWS = ((8, 192, 12, 12, 64, 192, 0, False, "float32"),
        (8, 1024, 12, 12, 64, 897, 0, True, "float32"),
        (8, 1024, 12, 12, 64, 1024, 0, True, "float32"),
        (2, 256, 8, 4, 128, 201, 64, False, "float32"),
        (8, 1024, 12, 12, 64, 1024, 0, True, "bfloat16"))


def build(splits):
    """One library per forced split, all nvcc processes started together."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "decode_attn.cu").read_text()
    assert RULE in src, "the split rule moved"
    out = _build.BUILD / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for split in splits:
        cu = out / f"decode_attn_split{split}.cu"
        cu.write_text(src.replace(RULE, RULE + f"  return {split};\n"))
        procs[split] = (cu.with_suffix(".so"), subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(cu.with_suffix(".so")), str(cu)], stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL))
    fns = {}
    for split, (lib, proc) in procs.items():
        assert proc.wait() == 0, f"nvcc failed for split {split}"
        fns[split] = getattr(ctypes.CDLL(str(lib)), "decode_attn")
        fns[split].restype = ctypes.c_int
    return fns


def main():
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from lora_skinny_sweep import ReadFlush
    from repro_torch.configs import SparseAttnConfig
    from repro_torch.kernels.decode_attn import ops
    from repro_torch.kernels.decode_attn.ref import decode_ref
    from repro_torch.models.attention import sparse_position_mask

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(f"DEVICE {chip_smoke.smi_line()}", flush=True)
    flush = torch.empty(32 * 1024 * 1024, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    serving = SparseAttnConfig(**chip_smoke.SERVING_SPARSE)
    libs = build(SPLITS)
    empty = lambda: torch.cuda._sleep(0)  # an empty kernel: the timer's floor
    print(f"SWEEP decode_attn empty ms={chip_smoke.device_ms(empty, flush):.4f} "
          f"clean_ms={chip_smoke.device_ms(empty, ReadFlush(flush)):.4f}", flush=True)
    for b, sc, h, kh, d, clen, window, sparse, dname in ROWS:
        dt = getattr(torch, dname)
        cfg = serving if sparse else None
        q = torch.randn(b, 1, h, d, generator=g, device="cuda").to(dt)
        kv = torch.randn(2, b, sc, kh, d, generator=g, device="cuda").to(dt)
        kc, vc = kv
        ref = decode_ref(q, kc, vc, clen, window=window, sparse=cfg)
        atol = chip_smoke.TOL[("decode_attn", dname)][0]
        pos = torch.arange(sc, device="cuda")
        mask = (pos < clen) & (pos >= clen - window if window else True)
        if cfg is not None:
            mask &= sparse_position_mask(pos, clen, cfg)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t[:, mask].transpose(1, 2).contiguous() for t in (kc, vc))
        rows = [(f"rule (split {ops.split_plan(b, sc, h, window=window, sparse=cfg)})",
                 lambda: ops.decode_attention(q, kc, vc, clen, window=window, sparse=cfg)),
                ("read", chip_smoke.read_call(kv, chip_smoke.read_ranges(sc, clen, window, cfg)))]
        if h == kh:
            rows.append(("library", lambda: F.scaled_dot_product_attention(qt, kt, vt)))
        pattern = ops._pattern(cfg)
        for split, fn in libs.items():
            fn.argtypes = ops._ARGTYPES
            out = torch.empty_like(q)
            call = (lambda fn=fn, out=out: fn(ops.DTYPES[dt], q.data_ptr(), kc.data_ptr(),
                                              vc.data_ptr(), out.data_ptr(), None, b, sc, h, kh,
                                              ops.plan(d, d, widths=ops.SQUARE).tile[0], 0, d,
                                              clen, 0, window, *pattern, d ** -0.5, stream))
            assert call() == 0
            torch.cuda.synchronize()
            assert torch.allclose(out.float(), ref.float(), atol=atol, rtol=atol), split
            rows.append((f"split={split}", call))
        label = (f"B={b} Sc={sc} H={h} K={kh} hd={d} cache_len={clen} window={window}"
                 + (" sparse" if sparse else ""))
        for name, call in rows:
            ms = chip_smoke.device_ms(call, flush)
            clean = chip_smoke.device_ms(call, ReadFlush(flush))
            print(f"SWEEP decode_attn {dname} {label} {name} ms={ms:.4f} "
                  f"clean_ms={clean:.4f}", flush=True)
    print(f"DEVICE {chip_smoke.smi_line()}", flush=True)


if __name__ == "__main__":
    main()
