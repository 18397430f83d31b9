#!/usr/bin/env python3
"""Times the prefill attention kernels' wide heads on one NVIDIA GPU: the
parent-against-change rows of PERF.md, and what splitting a head over a
thread block cluster costs where the kernels keep one block.

    python3 tools/attn_split_sweep.py
    python3 tools/attn_split_sweep.py --trees PARENT . . PARENT

Without ``--trees``: at the shapes of ``VARIANT_SHAPES`` (SERVE-GEMMA3's
and SERVE-MLA's, whose (256, 256) and (192, 128) tiles run one block a
(batch·head, q tile), and heads of 512, which split), each of
``VARIANTS``: the committed kernel as the wrappers call it; the split
forced (the C entry points' rows-past-256 path, ``rows`` 2, takes any
width: heads of 240 in two ranks of (128, 128), MLA's (192, 128) in two,
the second with q/k dims 128–191 and no v columns); and ``flash_attn``
built from copies of the sources with the split's ranks at 64 q rows, and
with its exchange dropped (each rank adds only its own partial S and
passes no cluster barrier in the loop: a wrong S, timed for its cost).
Each is checked against the plain version but the last; f32, cold L2,
median of 30 (the timer of ``chip_smoke.py``).  One VARIANT line a shape.

With ``--trees``: each directory in turn (a checkout's root, e.g. the
parent commit unpacked by ``git archive`` into a gitignored directory, and
``.``) times the wide rows of ``ROWS`` through its own wrappers and its own
build, in a process of its own; the order given is the order run (parent,
change, change, parent compares two commits on one card).  One ROW line a
row and tree, with the plain version's, SDPA's and the bound's times.
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (kernel, B, S, H, K, dk, dv, window or sparse pattern, scale, label): the
# wide rows of PERF.md, at their paths' shapes
ROWS = [
    ("flash", 2, 128, 4, 4, 272, 272, 0, None, "SERVE-WIDTHS hd 272"),
    ("flash", 2, 128, 4, 4, 512, 512, 0, None, "SERVE-WIDTHS hd 512"),
    ("flash", 2, 128, 4, 4, 288, 272, 0, None, "MLA (288, 272)"),
    ("flash", 2, 128, 4, 4, 528, 512, 0, None, "MLA (528, 512)"),
    ("flash", 2, 1024, 4, 4, 512, 512, 0, None, "hd 512 at S 1024"),
    ("bsa", 2, 128, 4, 4, 512, 512, (16, 2, 1, 4), None, "SERVE-WIDTHS sparse hd 512"),
    ("flash", 4, 256, 128, 128, 192, 128, 0, 192 ** -0.5, "SERVE-MLA prefill"),
    ("flash", 2, 1152, 16, 8, 240, 240, 1024, None, "SERVE-GEMMA3 local"),
    ("flash", 2, 1152, 16, 8, 240, 240, 0, None, "SERVE-GEMMA3 global"),
    ("bsa", 2, 1152, 16, 8, 240, 240, (128, 4, 1, 8), None, "SERVE-GEMMA3-SPARSE global"),
    ("bsa", 4, 512, 128, 128, 192, 128, (128, 4, 1, 8), 192 ** -0.5, "MLA sparse"),
    # narrow rows: the split leaves them as they were
    ("flash", 8, 128, 12, 12, 64, 64, 0, None, "SERVE prefill hd 64"),
    ("bsa", 8, 896, 12, 12, 64, 64, (128, 4, 1, 8), None, "SERVE-SPARSE prefill hd 64"),
]

# flash_attn builds of the variants: (file, text, replacement) edits of a
# copy of the sources, each text found once
EDITS = {
    "64-row ranks": [("attn_tile.cuh", "constexpr int SPLIT_BQ = 32;",
                      "constexpr int SPLIT_BQ = 64;")],
    "no exchange": [
        ("attn_tile.cuh", '    asm volatile("barrier.cluster.arrive;\\n" ::: "memory");\n  };', "  };"),
        ("attn_tile.cuh", '    asm volatile("barrier.cluster.wait;\\n" ::: "memory");\n#pragma', "#pragma"),
        ("attn_tile.cuh", "for (int r = 0; r < rk.ranks; ++r)", "for (int r = 0; r < 1; ++r)"),
        ("attn_tile.cuh", "cluster.map_shared_rank(mine, r)", "mine")],
}
# (name, build: None the committed one, else a key of EDITS; split forced)
VARIANTS = [("as called", None, False), ("split", None, True),
            ("split, 64-row ranks", "64-row ranks", True),
            ("split, no exchange", "no exchange", True)]
VARIANT_SHAPES = [
    ("flash", 2, 1152, 16, 8, 240, 240, 1024, None, "SERVE-GEMMA3 local"),
    ("flash", 2, 1152, 16, 8, 240, 240, 0, None, "SERVE-GEMMA3 global"),
    ("bsa", 2, 1152, 16, 8, 240, 240, (128, 4, 1, 8), None, "SERVE-GEMMA3-SPARSE global"),
    ("flash", 4, 256, 128, 128, 192, 128, 0, 192 ** -0.5, "SERVE-MLA prefill"),
    ("bsa", 4, 512, 128, 128, 192, 128, (128, 4, 1, 8), 192 ** -0.5, "MLA sparse"),
    ("flash", 2, 1024, 4, 4, 512, 512, 0, None, "hd 512 at S 1024"),
]


def inputs(torch, row, gen):
    kind, b, s, h, kh, dk, dv, mask, scale, _ = row
    rn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")  # noqa: E731
    return rn(b, s, h, dk), rn(b, s, kh, dk), rn(b, s, kh, dv)


def calls(torch, row, q, k, v):
    """(kernel, plain, library, bytes, flops) of a row through the wrappers
    of the ``repro_torch`` on the path."""
    import chip_smoke
    from repro_torch.configs import SparseAttnConfig
    from repro_torch.kernels.block_sparse_attn.ops import block_sparse_attention
    from repro_torch.kernels.block_sparse_attn.ref import block_sparse_ref
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.flash_attn.ref import attention_ref
    from repro_torch.models.attention import make_mask, sparse_block_table

    kind, b, s, h, kh, dk, dv, mask, scale, label = row
    if kind == "flash":
        m = make_mask(s, s, causal=True, window=mask, device="cuda")
        case = chip_smoke.attn_case(
            torch, "flash_attn", label,
            lambda: flash_attention(q, k, v, causal=True, window=mask, scale=scale),
            lambda: attention_ref(q, k, v, causal=True, window=mask, scale=scale),
            q, k, v, int(m.sum()), mask=m if mask else None, scale=scale, causal=True)
    else:
        bs, local, sink, stride = mask
        cfg = SparseAttnConfig(block_size=bs, local_blocks=local, sink_blocks=sink,
                               stride=stride)
        idx, valid = sparse_block_table(s // bs, s // bs, cfg, 0)
        m = torch.zeros(s, s, dtype=torch.bool, device="cuda")
        for i in range(idx.shape[0]):
            for j in idx[i][valid[i]]:
                m[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = True
        m &= torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
        case = chip_smoke.attn_case(
            torch, "block_sparse_attn", label,
            lambda: block_sparse_attention(q, k, v, cfg, scale=scale),
            lambda: block_sparse_ref(q, k, v, cfg, scale=scale),
            q, k, v, int(m.sum()), mask=m, scale=scale)
    return case


def time_rows(tree):
    """Every row of ROWS through ``tree``'s wrappers and build."""
    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    assert _build.CSRC.is_relative_to(os.path.abspath(tree)), _build.CSRC
    _build.build_all()
    flush = torch.empty(32 * 1024 * 1024, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for row in ROWS:
        q, k, v = inputs(torch, row, gen)
        c = calls(torch, row, q, k, v)
        err = (c["kernel"]().float() - c["plain"]().float()).abs().max().item()
        ms = chip_smoke.device_ms(c["kernel"], flush)
        plain = chip_smoke.device_ms(c["plain"], flush)
        lib = chip_smoke.device_ms(c["library"], flush)
        b_ms, b_by = chip_smoke.bound(c["nbytes"], c["flops"], "float32")
        print(f"ROW tree={tree} {c['name']} {row[-1]} (B={row[1]} S={row[2]} H={row[3]} "
              f"K={row[4]} dk={row[5]} dv={row[6]}) ms={ms:.4f} plain_ms={plain:.4f} "
              f"library_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"bound_share={b_ms / ms:.3f} max_abs_err={err:.3e}", flush=True)
        del q, k, v, c
        torch.cuda.empty_cache()


def build_variant(name, edits):
    """A copy of the sources under ``build/sweep/`` with ``edits`` made, and
    its flash_attn library being built."""
    import shutil

    from repro_torch.kernels import _build
    out = _build.BUILD / "sweep" / re.sub(r"\W+", "_", name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out)
    for f, text, new in edits:
        src = (out / f).read_text()
        assert src.count(text) == 1, (name, text)
        (out / f).write_text(src.replace(text, new))
    lib = out / "flash_attn.so"
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(out), "-o", str(lib),
                             str(out / "flash_attn.cu")], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT), lib


def sweep_variants():
    """Each VARIANT_SHAPES call through each of VARIANTS (the edited builds
    for ``flash_attn`` only; one block only where the plan has no
    cluster)."""
    import torch

    import chip_smoke
    from repro_torch.configs import SparseAttnConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_sparse_attn import ops as bsa_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops

    procs = {n: build_variant(n, e) for n, e in EDITS.items()}
    _build.build_all()
    libs = {None: {"flash": _build.function("flash_attn", flash_ops._ARGTYPES),
                   "bsa": _build.function("block_sparse_attn", bsa_ops._ARGTYPES)}}
    for n, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(out.decode())
        fn = ctypes.CDLL(str(lib)).flash_attn
        fn.restype = ctypes.c_int
        fn.argtypes = flash_ops._ARGTYPES
        libs[n] = {"flash": fn}
    flush = torch.empty(32 * 1024 * 1024, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for row in VARIANT_SHAPES:
        kind, b, s, h, kh, dk, dv, mask, scale, label = row
        q, k, v = inputs(torch, row, gen)
        ref = calls(torch, row, q, k, v)["plain"]()
        p = flash_ops.plan(dk, dv)
        sc = dk ** -0.5 if scale is None else scale
        line = f"VARIANT {kind} {label} (B={b} S={s} H={h} K={kh} dk={dk} dv={dv})"
        if kind == "bsa":
            bs, local, sink, stride = mask
            cfg = SparseAttnConfig(block_size=bs, local_blocks=local, sink_blocks=sink,
                                   stride=stride)
            idx, valid = bsa_ops.device_table(s // bs, s // bs, cfg, 0, q.device)
        for name, build, forced in VARIANTS:
            fn = libs[build].get(kind)
            if fn is None or (not forced and p.cluster is not None):
                continue
            tile, rows = ((256, 256), 2) if forced else (p.tile, p.path)
            out = torch.empty(b, s, h, dv, device="cuda")
            if kind == "flash":
                call = lambda fn=fn, out=out, tile=tile, rows=rows: fn(  # noqa: E731
                    0, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, b, s, s,
                    h, kh, *tile, rows, dk, dv, 1, mask, sc, stream)
            else:
                call = lambda fn=fn, out=out, tile=tile, rows=rows: fn(  # noqa: E731
                    0, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                    idx.data_ptr(), valid.data_ptr(), b, s, s, h, kh, *tile, rows, dk, dv,
                    mask[0], idx.shape[1], 0, sc, stream)
            assert call() == 0
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            assert build == "no exchange" or err < 2e-5, (label, name, err)
            line += f" {name}={chip_smoke.device_ms(call, flush):.4f} (err {err:.1e})"
        print(line, flush=True)
        del q, k, v, ref
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="*", help="checkout roots to time ROWS in, in turn")
    ap.add_argument("--rows-in", help=argparse.SUPPRESS)   # one tree, in this process
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    import chip_smoke
    print(f"DEVICE {chip_smoke.smi_line()}", flush=True)
    if args.rows_in:
        # chip_smoke put this checkout's src first: the tree's goes before it
        sys.path.insert(0, os.path.join(os.path.abspath(args.rows_in), "src"))
        time_rows(args.rows_in)
    elif args.trees:
        for tree in args.trees:
            src = os.path.join(os.path.abspath(tree), "src")
            env = dict(os.environ, PYTHONPATH=src)
            subprocess.run([sys.executable, os.path.abspath(__file__), "--rows-in", tree],
                           env=env, check=True)
    else:
        sweep_variants()
    print(f"DEVICE {chip_smoke.smi_line()}", flush=True)


if __name__ == "__main__":
    main()
