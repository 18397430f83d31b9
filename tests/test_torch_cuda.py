"""The hand-written kernels on the card against their plain versions.

Marked ``cuda``: they need an NVIDIA GPU with nvcc and skip elsewhere (the
decision is taken inside the fixture, never at import).  Run them on the
card with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerances are those of ``tests/test_kernels.py``.
"""
import functools

import pytest
import torch

from repro_torch.configs import SparseAttnConfig
from repro_torch.kernels.block_sparse_attn import ops as bsa_ops
from repro_torch.kernels.block_sparse_attn.ops import block_sparse_attention
from repro_torch.kernels.block_sparse_attn.ref import block_sparse_ref
from repro_torch.kernels.decode_attn.ops import decode_attention, split_plan
from repro_torch.kernels.decode_attn.ref import decode_ref
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.kernels.flash_attn.ref import attention_ref
from repro_torch.kernels.lora_fused import ops as lora_ops
from repro_torch.kernels.lora_fused.ops import lora_matmul
from repro_torch.kernels.lora_fused.ref import lora_ref
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk.ops import ssd_plan, ssd_scan
from repro_torch.kernels.ssd_chunk.ref import ssd_ref
from repro_torch.models.attention import make_mask, sparse_block_table

pytestmark = pytest.mark.cuda

TOL = {"lora": {torch.float32: 1e-4, torch.bfloat16: 3e-2},
       "flash": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
       "decode": {torch.float32: 2e-5, torch.bfloat16: 3e-2},
       "ssd": {torch.float32: (5e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}}
SERVE_SPARSE = SparseAttnConfig(block_size=128, local_blocks=4, sink_blocks=1, stride=8)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rn(gen, *shape, std=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)


def _close(out, ref, tol):
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,r", [(8, 768, 768, 8), (1, 100, 70, 3),
                                     (16, 768, 768, 32), (1024, 768, 768, 8),
                                     (77, 130, 200, 16),
                                     # the prefill branch's edges: its first row
                                     # count, SERVE-SPARSE's prefill, element
                                     # copies (no row 16-byte aligned), the most
                                     # x·A pairs per thread
                                     (17, 768, 768, 8), (7168, 768, 768, 8),
                                     (300, 130, 70, 3), (1024, 768, 768, 32),
                                     # with 1024 and 7168 above, a row count
                                     # for each tile the rule takes on a
                                     # 132-SM card: 64×64, 96×64, 64×128
                                     (512, 768, 768, 8),
                                     # the decode branch (M ≤ 16): M edges
                                     # 1, 2, 9, 12, 15 with N not a multiple
                                     # of the vector or the strip, K not a
                                     # multiple of the split, r 1, 17, 32
                                     (1, 768, 768, 8), (2, 1001, 200, 17),
                                     (9, 130, 70, 1), (12, 768, 768, 8),
                                     (15, 768, 768, 3), (16, 2048, 8512, 32),
                                     # f32 splits on a 132-SM card: 1 (K 100
                                     # above), 2 here, 4 (N 8512), 8 (N 768)
                                     (4, 256, 20000, 8),
                                     # ranks above 32 in both branches
                                     # (decode at 4 < M ≤ 16 holds up to 64
                                     # in its main loop, else the
                                     # workspace): r 33, llama3.2-1b's wq /
                                     # wv at r 64, r 128 and 512; N and r
                                     # off the vector
                                     (8, 768, 768, 33), (1024, 768, 768, 33),
                                     (8, 2048, 2048, 64), (4096, 2048, 512, 64),
                                     (12, 768, 768, 128), (300, 768, 768, 128),
                                     (16, 1024, 768, 512), (600, 1024, 768, 512),
                                     (5, 300, 70, 100), (77, 130, 200, 100),
                                     # ranks 33–64 at M ≤ 4 (the workspace)
                                     (4, 2048, 2048, 64), (3, 1001, 70, 40)])
def test_lora_fused_kernel(gen, dtype, m, k, n, r):
    x, w = _rn(gen, m, k, dtype=dtype), _rn(gen, k, n, std=0.05, dtype=dtype)
    a, b = _rn(gen, k, r, std=0.05, dtype=dtype), _rn(gen, r, n, std=0.05, dtype=dtype)
    before = lora_matmul.launches
    out = lora_matmul(x, w, a, b, scale=2.0)
    torch.cuda.synchronize()
    assert lora_matmul.launches == before + 1
    _close(out, lora_ref(x, w, a, b, scale=2.0), TOL["lora"][dtype])
    # the split reductions run in a fixed order: a second call is bitwise equal
    assert torch.equal(lora_matmul(x, w, a, b, scale=2.0), out)


@pytest.mark.parametrize("m,r,elems", [(1, 32, 0), (4096, 32, 0), (4, 33, 4 * 33),
                                       (8, 64, 0), (16, 64, 0), (8, 65, 8 * 65),
                                       (17, 33, 17 * 33), (4096, 64, 4096 * 64)])
def test_lora_fused_workspace_rule(gen, m, r, elems):
    """The workspace the C rank rule asks for: none up to rank 32, none at
    4 < M ≤ 16 up to 64 (x·A in the decode loop), else M × r."""
    assert lora_ops.workspace_elems(m, r) == elems


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal,window", [
    (8, 128, 128, 12, 12, 64, True, 0), (8, 77, 77, 12, 12, 64, True, 0),
    (2, 256, 256, 8, 4, 64, True, 96), (1, 33, 33, 4, 1, 128, True, 0),
    (2, 200, 200, 8, 2, 32, True, 0),
    # non-causal: the reduced RoBERTa encoder, ragged, GQA at hd 128, window
    (8, 32, 32, 4, 4, 32, False, 0), (2, 65, 130, 8, 8, 64, False, 0),
    (1, 70, 90, 4, 1, 128, False, 0), (2, 100, 100, 4, 4, 64, False, 24),
    # the q tile's edges: Sq 1, 31, 33, 65, 129 with Sk ≠ Sq (a row past
    # Sk sees every key)
    (2, 1, 40, 4, 4, 64, True, 0), (2, 31, 77, 4, 2, 64, True, 0),
    (2, 33, 20, 4, 4, 64, True, 0), (2, 65, 64, 4, 4, 32, True, 0),
    (2, 129, 100, 4, 4, 64, True, 0),
    # window edges inside a kv tile
    (2, 200, 200, 8, 8, 64, True, 40), (1, 300, 300, 4, 4, 128, True, 45),
    # GQA at hd 32 and 128
    (2, 96, 96, 8, 2, 32, True, 0), (1, 150, 150, 8, 2, 128, True, 0),
    # grids that take the 64-row q tile on a 132-SM card (ceil(Sq/64)·B·H
    # ≥ 264), at hd 64, 128 and 32; the cases above take the 32-row tile
    (8, 256, 256, 12, 12, 64, True, 0), (4, 600, 600, 8, 2, 128, True, 0),
    (8, 300, 300, 8, 8, 32, True, 64), (8, 256, 256, 12, 12, 64, False, 0),
])
def test_flash_attn_kernel(gen, dtype, b, sq, sk, h, kh, d, causal, window):
    q = _rn(gen, b, sq, h, d, dtype=dtype)
    k, v = _rn(gen, b, sk, kh, d, dtype=dtype), _rn(gen, b, sk, kh, d, dtype=dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _close(out, attention_ref(q, k, v, causal=causal, window=window), TOL["flash"][dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kh,dk,dv,causal,window", [
    # deepseek-v2's published widths (SERVE-MLA's prefill, the 64-row q
    # tile), ragged and GQA; the reduced d-256 MLA (q/k 80 padded to 96) at
    # the arch round's shape, non-causal with Sq ≠ Sk, and a window
    (4, 256, 256, 128, 128, 192, 128, True, 0), (2, 77, 77, 8, 8, 192, 128, True, 0),
    (2, 300, 300, 4, 2, 192, 128, False, 0), (4, 16, 16, 4, 4, 96, 64, True, 0),
    (2, 65, 130, 4, 4, 96, 64, False, 0), (8, 256, 256, 12, 12, 96, 64, True, 40)])
def test_flash_attn_kernel_mla_widths(gen, dtype, b, sq, sk, h, kh, dk, dv, causal, window):
    """The (q/k, v) instances (192, 128) and (96, 64) with an explicit
    scale against the plain version."""
    q, k = _rn(gen, b, sq, h, dk, dtype=dtype), _rn(gen, b, sk, kh, dk, dtype=dtype)
    v = _rn(gen, b, sk, kh, dv, dtype=dtype)
    out = flash_attention(q, k, v, causal=causal, window=window, scale=0.09)
    assert out.shape == (b, sq, h, dv)
    _close(out, attention_ref(q, k, v, causal=causal, window=window, scale=0.09),
           TOL["flash"][dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dk,dv,h,kh", [(192, 128, 16, 16), (96, 64, 8, 2)])
def test_block_sparse_attn_kernel_mla_widths(gen, dtype, dk, dv, h, kh):
    cfg = SparseAttnConfig(block_size=128, local_blocks=4, sink_blocks=1, stride=8)
    q, k = _rn(gen, 2, 512, h, dk, dtype=dtype), _rn(gen, 2, 512, kh, dk, dtype=dtype)
    v = _rn(gen, 2, 512, kh, dv, dtype=dtype)
    _close(block_sparse_attention(q, k, v, cfg, scale=0.08),
           block_sparse_ref(q, k, v, cfg, scale=0.08), TOL["flash"][dtype])


# Any head width (the plan of kernels/flash_attn/ops.py): widths that are
# not whole 16-byte chunks (elements), both sides of 256 and far past it
# (split; the decode kernel's slices), and MLA's pairs at the launcher's
# d 72, 1088 and 2048
ANY_WIDTHS = [(d, d) for d in (1, 3, 18, 34, 100, 250, 260, 272, 288, 512, 528, 1000)] + [
    (34, 18), (288, 272), (528, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dk,dv", ANY_WIDTHS)
def test_prefill_attention_kernels_any_width(gen, dtype, dk, dv):
    """``flash_attn`` causal with GQA 2 and a window, non-causal with an
    explicit scale, and ``block_sparse_attn`` (block 32, q offset 64) at
    any (dk, dv) against the plain versions, one launch a call whatever
    the plan's cluster."""
    plan = flash_ops.plan(dk, dv, dtype.itemsize)
    q, k = _rn(gen, 2, 160, 4, dk, dtype=dtype), _rn(gen, 2, 160, 2, dk, dtype=dtype)
    v = _rn(gen, 2, 160, 2, dv, dtype=dtype)
    tol = TOL["flash"][dtype]
    for kw in (dict(causal=True, window=70), dict(causal=False, scale=0.07)):
        before = flash_attention.launches
        out = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1 and out.shape == (2, 160, 4, dv)
        _close(out, attention_ref(q, k, v, **kw), tol)
    cfg = SparseAttnConfig(block_size=32, local_blocks=2, sink_blocks=1, stride=2)
    kk, vv = _rn(gen, 2, 224, 2, dk, dtype=dtype), _rn(gen, 2, 224, 2, dv, dtype=dtype)
    before = block_sparse_attention.launches
    out = block_sparse_attention(q, kk, vv, cfg, q_offset=64)
    torch.cuda.synchronize()
    assert block_sparse_attention.launches == before + 1, plan
    _close(out, block_sparse_ref(q, kk, vv, cfg, q_offset=64), tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [d for d, dv in ANY_WIDTHS if d == dv])
def test_decode_attention_kernel_any_width(gen, dtype, d):
    """``decode_attn`` at any head width against the plain version, GQA 2:
    dense, windowed with the LSE, under the sparse mask at a position
    offset, one launch a call; the split rule's cluster for the plan."""
    q = _rn(gen, 2, 1, 8, d, dtype=dtype)
    kc, vc = _rn(gen, 2, 300, 4, d, dtype=dtype), _rn(gen, 2, 300, 4, d, dtype=dtype)
    cfg = SparseAttnConfig(block_size=32, local_blocks=2, sink_blocks=1, stride=3)
    assert 1 <= split_plan(2, 300, 8, head_dim=d, itemsize=dtype.itemsize) <= 16
    for kw in (dict(cache_len=300), dict(cache_len=257, window=100, return_lse=True),
               dict(cache_len=350, sparse=cfg, offset=64), dict(cache_len=1)):
        before = decode_attention.launches
        got = decode_attention(q, kc, vc, **kw)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        want = decode_ref(q, kc, vc, **kw)
        if kw.get("return_lse"):
            (got, got_lse), (want, want_lse) = got, want
            torch.testing.assert_close(got_lse, want_lse, atol=1e-4, rtol=0)
        _close(got, want, TOL["decode"][dtype])


@pytest.mark.parametrize("d", [18, 250, 272, 1000])
def test_attention_kernels_any_width_unaligned(gen, d):
    """f32 operands 4 bytes past a 16-byte boundary at widths of every
    plan: the element path, the split and the decode kernel's slices read
    nothing as 16-byte chunks."""
    q, k, v = _unaligned(gen, 2, 96, 4, d), _unaligned(gen, 2, 96, 2, d), _unaligned(gen, 2, 96, 2, d)
    _close(flash_attention(q, k, v), attention_ref(q, k, v), TOL["flash"][torch.float32])
    cfg = SparseAttnConfig(block_size=32, local_blocks=2, sink_blocks=1, stride=2)
    _close(block_sparse_attention(q, k, v, cfg), block_sparse_ref(q, k, v, cfg),
           TOL["flash"][torch.float32])
    q1 = _unaligned(gen, 2, 1, 4, d)
    _close(decode_attention(q1, k, v, 90, window=50), decode_ref(q1, k, v, 90, window=50),
           TOL["decode"][torch.float32])


def test_attention_kernels_refuse_what_jax_refuses(gen):
    """Width 0 raises naming it, and the decode kernel takes caches of one
    shape (a v narrower than k fails in the JAX package too); nothing
    launches."""
    before = (flash_attention.launches, decode_attention.launches,
              block_sparse_attention.launches)
    q, v = _rn(gen, 1, 16, 2, 0), _rn(gen, 1, 16, 2, 8)
    with pytest.raises(ValueError, match="head width 0"):
        flash_attention(q, q, v)
    with pytest.raises(ValueError, match="head width 0"):
        block_sparse_attention(q, q, v, SparseAttnConfig(block_size=16, local_blocks=1,
                                                         sink_blocks=1, stride=2))
    with pytest.raises(ValueError, match="one shape"):
        decode_attention(_rn(gen, 1, 1, 2, 288), _rn(gen, 1, 8, 2, 288), _rn(gen, 1, 8, 2, 272), 4)
    assert (flash_attention.launches, decode_attention.launches,
            block_sparse_attention.launches) == before


# The split of a row past 256 over a thread block cluster (the plan's
# ``cluster``): ranks 3 (272, MLA's (288, 272); (260, 128) and (128, 384):
# ranks with no v columns, with no q/k dims), 4 (512), 5 with a rank that
# owns no v columns ((528, 512)), 8 (1024), past 8 (1040: 9, 2048: 16),
# ranks that loop over two slices (2080; 2080 with v 128; v 2304 past q/k
# 64: ranks with no q/k dims), and rows past 256 that are not whole chunks
# (274 in f32, 1001 in bf16: elements)
SPLIT_WIDTHS = [(260, 128), (128, 384), (1024, 1024), (272, 272), (288, 272), (512, 512),
                (528, 512), (1040, 1040), (2048, 2048), (2080, 2080), (2080, 128),
                (64, 2304), (274, 274), (1001, 1001)]


def _plain(q, k, v, allowed, scale):
    """The plain attention over ``allowed`` (Sq, Sk), f32 operands in f64
    (at 2048 dims the f32 plain version's own q·k sum is off by up to
    1e-5, half the kernel check's tolerance), bf16 ones in f32 → q's
    dtype."""
    b, sq, h, d = q.shape
    kh, wide = k.shape[2], torch.float64 if q.dtype == torch.float32 else torch.float32
    qg = q.to(wide).reshape(b, sq, kh, h // kh, d) * scale
    logits = torch.einsum("bsKgd,btKd->bKgst", qg, k.to(wide)).masked_fill(~allowed, -1e30)
    out = torch.einsum("bKgst,btKd->bsKgd", torch.softmax(logits, -1), v.to(wide))
    return out.reshape(b, sq, h, v.shape[3]).to(q.dtype)


def _sparse_allowed(sq, sk, cfg, q_offset):
    """The block-sparse kernels' (Sq, Sk) mask: a q block's valid kv blocks,
    causal inside them."""
    bs = cfg.block_size
    idx, valid = sparse_block_table(sq // bs, sk // bs, cfg, q_offset // bs)
    allowed = torch.zeros(sq, sk, dtype=torch.bool, device="cuda")
    for i in range(idx.shape[0]):
        for j in idx[i][valid[i]]:
            allowed[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = True
    qpos = torch.arange(sq, device="cuda")[:, None] + q_offset
    return allowed & (torch.arange(sk, device="cuda")[None, :] <= qpos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dk,dv", SPLIT_WIDTHS)
def test_prefill_attention_kernels_split(gen, dtype, dk, dv):
    """``flash_attn`` causal with GQA 2 and a window, non-causal with an
    explicit scale, and ``block_sparse_attn`` (block 32, q offset 64) on
    the split route against the plain arithmetic, one launch a call; the
    ranks add the partial S in one order whatever order they run in, so the
    same call twice gives the same bits."""
    plan = flash_ops.plan(dk, dv, dtype.itemsize)
    assert plan.cluster is not None and plan.cluster.ranks >= 3
    q, k = _rn(gen, 2, 160, 4, dk, dtype=dtype), _rn(gen, 2, 160, 2, dk, dtype=dtype)
    v = _rn(gen, 2, 160, 2, dv, dtype=dtype)
    tol = TOL["flash"][dtype]
    for kw in (dict(causal=True, window=70), dict(causal=False, scale=0.07)):
        before = flash_attention.launches
        out = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1 and out.shape == (2, 160, 4, dv)
        allowed = make_mask(160, 160, causal=kw["causal"], window=kw.get("window", 0),
                            device="cuda")
        _close(out, _plain(q, k, v, allowed, kw.get("scale", dk ** -0.5)), tol)
        assert torch.equal(flash_attention(q, k, v, **kw), out)
    cfg = SparseAttnConfig(block_size=32, local_blocks=2, sink_blocks=1, stride=2)
    kk, vv = _rn(gen, 2, 224, 2, dk, dtype=dtype), _rn(gen, 2, 224, 2, dv, dtype=dtype)
    before = block_sparse_attention.launches
    out = block_sparse_attention(q, kk, vv, cfg, q_offset=64)
    torch.cuda.synchronize()
    assert block_sparse_attention.launches == before + 1, plan
    _close(out, _plain(q, kk, vv, _sparse_allowed(160, 224, cfg, 64), dk ** -0.5), tol)
    assert torch.equal(block_sparse_attention(q, kk, vv, cfg, q_offset=64), out)


@pytest.mark.parametrize("ranks", [3, 5, 16])
def test_split_instances_fit(gen, ranks):
    """The f32 split instance rows past 256 run in: at least two blocks an
    SM, and clusters of up to 16 that the card can hold."""
    blocks, clusters, smem = flash_ops.split_occupancy(ranks)
    assert blocks >= 2 and clusters >= 1 and 0 < smem <= 227 * 1024


# gemma3-12b's heads of 240 (the 256 tile), the launcher's default d 64
# (heads of 16: the 32 tile) and its MLA's (32, 16)
ROW_WIDTHS = [(240, 240), (16, 16), (32, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dk,dv", ROW_WIDTHS)
@pytest.mark.parametrize("b,sq,h,kh,causal,window", [
    (2, 300, 16, 8, True, 0), (2, 300, 16, 8, True, 100), (1, 77, 4, 4, False, 0),
    # a grid that takes the 64-row q tile on a 132-SM card
    (2, 1280, 16, 8, True, 1024)])
def test_flash_attn_kernel_row_widths(gen, dtype, dk, dv, b, sq, h, kh, causal, window):
    """Row widths below the compiled tile's (zero-filled inside the kernel)
    against the plain version, with one launch a call."""
    q, k = _rn(gen, b, sq, h, dk, dtype=dtype), _rn(gen, b, sq, kh, dk, dtype=dtype)
    v = _rn(gen, b, sq, kh, dv, dtype=dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and out.shape == (b, sq, h, dv)
    _close(out, attention_ref(q, k, v, causal=causal, window=window), TOL["flash"][dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dk,dv", ROW_WIDTHS)
@pytest.mark.parametrize("sq,q_offset", [(1280, 0), (256, 512)])
def test_block_sparse_attn_kernel_row_widths(gen, dtype, dk, dv, sq, q_offset):
    """The block-sparse kernel at the row widths, gemma3-12b's pattern
    (block 128, local 4, sink 1, stride 8), GQA 2, against the plain
    version."""
    sk = sq + q_offset
    q = _rn(gen, 2, sq, 16, dk, dtype=dtype)
    k, v = _rn(gen, 2, sk, 8, dk, dtype=dtype), _rn(gen, 2, sk, 8, dv, dtype=dtype)
    before = block_sparse_attention.launches
    out = block_sparse_attention(q, k, v, SERVE_SPARSE, q_offset=q_offset)
    torch.cuda.synchronize()
    assert block_sparse_attention.launches == before + 1
    _close(out, block_sparse_ref(q, k, v, SERVE_SPARSE, q_offset=q_offset),
           TOL["flash"][dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [240, 16])
@pytest.mark.parametrize("sc,cache_len,window,sparse,lse", [
    (1024, 1024, 1024, False, False), (1024, 300, 1024, False, True),
    (1312, 1312, 0, False, False), (1312, 1312, 0, True, True), (1312, 1, 0, False, False)])
def test_decode_attn_kernel_row_widths(gen, dtype, d, sc, cache_len, window, sparse, lse):
    """The decode kernel at heads of 240 (the 256 layout: two chunks a lane
    in f32, 4 blocks an SM) and 16 (the 32 layout), gemma3-12b's GQA 2:
    its 1024-slot rings with the window, the global cache of 1312 plain and
    under the sparse mask, with and without the LSE."""
    cfg = SERVE_SPARSE if sparse else None
    q = _rn(gen, 2, 1, 16, d, dtype=dtype)
    kc, vc = _rn(gen, 2, sc, 8, d, dtype=dtype), _rn(gen, 2, sc, 8, d, dtype=dtype)
    before = decode_attention.launches
    got = decode_attention(q, kc, vc, cache_len, window=window, sparse=cfg, return_lse=lse)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = decode_ref(q, kc, vc, cache_len, window=window, sparse=cfg, return_lse=lse)
    if lse:
        (got, got_lse), (want, want_lse) = got, want
        torch.testing.assert_close(got_lse, want_lse, atol=1e-4, rtol=0)
    _close(got, want, TOL["decode"][dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sc,h,kh,d,cache_len,window,sparse", [
    (8, 1024, 12, 12, 64, 640, 640, False), (8, 192, 12, 12, 64, 170, 20, False),
    (8, 1024, 12, 12, 64, 1000, 0, True), (2, 64, 8, 4, 128, 1, 0, False),
    (8, 1500, 8, 8, 64, 1500, 0, False)])
def test_decode_attn_kernel_lse(gen, dtype, b, sc, h, kh, d, cache_len, window, sparse):
    """``return_lse``: the output has the bits of the call without it (one
    launch each), and the LSE is the plain version's within 1e-4."""
    cfg = SERVE_SPARSE if sparse else None
    q, kc, vc = (_rn(gen, b, 1, h, d, dtype=dtype), _rn(gen, b, sc, kh, d, dtype=dtype),
                 _rn(gen, b, sc, kh, d, dtype=dtype))
    before = decode_attention.launches
    out, lse = decode_attention(q, kc, vc, cache_len, window=window, sparse=cfg,
                                return_lse=True)
    plain = decode_attention(q, kc, vc, cache_len, window=window, sparse=cfg)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2 and torch.equal(out, plain)
    ref, ref_lse = decode_ref(q, kc, vc, cache_len, window=window, sparse=cfg,
                              return_lse=True)
    _close(out, ref, TOL["decode"][dtype])
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


def test_sparse_kv_decode_on_card_matches_cpu(gen):
    """The sparse-KV cache's card path (up to three flash-decode launches a
    step, merged by their LSEs) against the plain ``sparse_kv_decode`` on
    the card, at every position of a 1024-position sequence of SERVE's
    pattern (block 128, local 4, sink 1, stride 8)."""
    from repro_torch.kernels.decode_attn.ops import sparse_kv_attention
    from repro_torch.models import attention
    seq, b, h, d = 1024, 2, 12, 64
    _, _, ring, n_pers = attention.sparse_kv_layout(seq, SERVE_SPARSE)
    cache = {n: torch.zeros(b, sz, h, d, device="cuda") for n, sz in
             (("k_pers", n_pers), ("v_pers", n_pers), ("k_ring", ring), ("v_ring", ring))}
    for pos in range(seq):
        q, k, v = (_rn(gen, b, 1, h, d) for _ in range(3))
        attention.sparse_kv_write(cache, k, v, pos, SERVE_SPARSE, seq)
        if pos % 7 and pos != seq - 1:
            continue
        _close(sparse_kv_attention(q, cache, pos, SERVE_SPARSE, seq),
               attention.sparse_kv_decode(q, cache, pos, SERVE_SPARSE, seq),
               TOL["decode"][torch.float32])


def _unaligned(gen, *shape):
    """A contiguous f32 tensor whose data starts 4 bytes past a 16-byte
    boundary: the kernels then load through registers, not cp.async."""
    n = 1
    for x in shape:
        n *= x
    t = _rn(gen, n + 1)[1:].view(*shape)
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    return t


def test_attention_kernels_unaligned_f32(gen):
    q, k, v = _unaligned(gen, 2, 96, 8, 64), _unaligned(gen, 2, 96, 4, 64), _unaligned(gen, 2, 96, 4, 64)
    _close(flash_attention(q, k, v), attention_ref(q, k, v), TOL["flash"][torch.float32])
    cfg = SparseAttnConfig(block_size=32, local_blocks=2, sink_blocks=1, stride=2)
    _close(block_sparse_attention(q, k, v, cfg), block_sparse_ref(q, k, v, cfg),
           TOL["flash"][torch.float32])


@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize("m,k,n", [(2048, 2048, 8512), (4, 2048, 8512),
                                   (2048, 4096, 2048), (4, 4096, 2048)])
def test_lora_fused_kernel_mamba_shapes(gen, m, k, n, unaligned):
    """mamba2-1.3b's in_proj (N 8512, not a multiple of 64) and out_proj at
    prefill (M 2048) and decode (M 4) rows; ``unaligned``: every operand
    starts 4 bytes past a 16-byte boundary (the element-load paths)."""
    if unaligned:
        x, w = _unaligned(gen, m, k), _unaligned(gen, k, n).mul_(0.02)
        a, b = _unaligned(gen, k, 8).mul_(0.02), _unaligned(gen, 8, n).mul_(0.05)
    else:
        x, w = _rn(gen, m, k), _rn(gen, k, n, std=0.02)
        a, b = _rn(gen, k, 8, std=0.02), _rn(gen, 8, n, std=0.05)
    _close(lora_matmul(x, w, a, b, scale=2.0), lora_ref(x, w, a, b, scale=2.0),
           TOL["lora"][torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kh,d,cfg,q_offset", [
    (8, 896, 896, 12, 12, 64, SERVE_SPARSE, 0),
    (2, 256, 256, 8, 4, 64, SparseAttnConfig(block_size=32, local_blocks=2,
                                             sink_blocks=1, stride=4), 0),
    (2, 256, 256, 8, 2, 32, SparseAttnConfig(block_size=64, local_blocks=1,
                                             sink_blocks=2, stride=2), 0),
    (1, 128, 384, 4, 2, 128, SparseAttnConfig(block_size=16, local_blocks=2,
                                              sink_blocks=1, stride=4), 256),
    # q_offset > 0 at SERVE-SPARSE's pattern, and in the 64-row q tile
    (2, 256, 896, 12, 12, 64, SERVE_SPARSE, 640),
    (8, 256, 768, 12, 12, 64, SparseAttnConfig(block_size=64, local_blocks=2,
                                               sink_blocks=1, stride=4), 512),
    # grids that take the 64-row q tile on a 132-SM card: block 32 (always
    # the 32-row tile), block 48 and 96 (a q tile the block only partly
    # fills), block 64, and hd 128
    (8, 512, 512, 12, 12, 64, SparseAttnConfig(block_size=32, local_blocks=3,
                                               sink_blocks=1, stride=4), 0),
    (8, 480, 480, 12, 12, 64, SparseAttnConfig(block_size=48, local_blocks=2,
                                               sink_blocks=1, stride=2), 0),
    (4, 384, 384, 12, 4, 64, SparseAttnConfig(block_size=96, local_blocks=2,
                                              sink_blocks=1, stride=2), 0),
    (8, 512, 512, 12, 12, 64, SparseAttnConfig(block_size=64, local_blocks=2,
                                               sink_blocks=1, stride=4), 0),
    (8, 512, 512, 8, 8, 128, SERVE_SPARSE, 0),
])
def test_block_sparse_attn_kernel(gen, dtype, b, sq, sk, h, kh, d, cfg, q_offset):
    q = _rn(gen, b, sq, h, d, dtype=dtype)
    k, v = _rn(gen, b, sk, kh, d, dtype=dtype), _rn(gen, b, sk, kh, d, dtype=dtype)
    before = block_sparse_attention.launches
    out = block_sparse_attention(q, k, v, cfg, q_offset=q_offset)
    torch.cuda.synchronize()
    assert block_sparse_attention.launches == before + 1
    _close(out, block_sparse_ref(q, k, v, cfg, q_offset=q_offset), TOL["flash"][dtype])


def test_block_sparse_tables_upload_once(gen):
    q, kv = _rn(gen, 1, 256, 2, 32), _rn(gen, 1, 256, 1, 32)
    cfg = SparseAttnConfig(block_size=32, local_blocks=2, sink_blocks=1, stride=4)
    block_sparse_attention(q, kv, kv, cfg)
    first = bsa_ops.device_table(8, 8, cfg, 0, q.device)
    block_sparse_attention(q, kv, kv, cfg)
    assert bsa_ops.device_table(8, 8, cfg, 0, q.device)[0] is first[0]
    with pytest.raises(ValueError, match="multiples"):
        block_sparse_attention(q[:, :100].contiguous(), kv[:, :100].contiguous(),
                               kv[:, :100].contiguous(), cfg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_len", [1, 897, 960, 1024])
def test_decode_attn_kernel_sparse(gen, dtype, cache_len):
    q = _rn(gen, 8, 1, 12, 64, dtype=dtype)
    kc, vc = _rn(gen, 8, 1024, 12, 64, dtype=dtype), _rn(gen, 8, 1024, 12, 64, dtype=dtype)
    out = decode_attention(q, kc, vc, cache_len, sparse=SERVE_SPARSE)
    _close(out, decode_ref(q, kc, vc, cache_len, sparse=SERVE_SPARSE), TOL["decode"][dtype])


def test_decode_attn_kernel_sparse_gqa_small_blocks(gen):
    cfg = SparseAttnConfig(block_size=16, local_blocks=2, sink_blocks=1, stride=4)
    q = _rn(gen, 2, 1, 8, 32)
    kc, vc = _rn(gen, 2, 200, 2, 32), _rn(gen, 2, 200, 2, 32)
    for cache_len in (5, 83, 200):
        _close(decode_attention(q, kc, vc, cache_len, sparse=cfg),
               decode_ref(q, kc, vc, cache_len, sparse=cfg), 2e-5)


def _ssd_inputs(gen, b, s, h, p, n, dtype, h0=False, shared_bc=False):
    x = _rn(gen, b, s, h, p, dtype=dtype)
    dt = torch.nn.functional.softplus(_rn(gen, b, s, h))
    a = -torch.exp(_rn(gen, h, std=0.3))
    if shared_bc:   # the mixer's stride-0 broadcast of one group over the heads
        bm = _rn(gen, b, s, 1, n, std=0.5, dtype=dtype).expand(b, s, h, n)
        cm = _rn(gen, b, s, 1, n, std=0.5, dtype=dtype).expand(b, s, h, n)
    else:
        bm = _rn(gen, b, s, h, n, std=0.5, dtype=dtype)
        cm = _rn(gen, b, s, h, n, std=0.5, dtype=dtype)
    state = _rn(gen, b, h, p, n, std=0.5) if h0 else None
    return x, dt, a, bm, cm, state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk,h0,shared", [
    (4, 512, 64, 64, 128, 256, False, True),     # the mamba2-1.3b serve prefill
    (2, 300, 8, 64, 128, 256, True, True),       # tail and initial state
    (2, 128, 4, 16, 16, 32, False, False),
    (2, 100, 4, 32, 32, 64, True, False),
    (1, 80, 2, 64, 64, 16, False, False),
    (1, 2048, 8, 64, 128, 256, False, True),     # 8 chunks
    (1, 1000, 4, 64, 128, 64, True, False),      # 16 chunks, the last of 40
    (2, 300, 4, 64, 128, 100, True, True),       # a chunk not a multiple of 64
    (2, 50, 4, 32, 32, 256, True, True),         # S < chunk
    (2, 200, 3, 16, 16, 64, False, True),        # each (P, N) with B/C shared
    (2, 200, 3, 32, 32, 64, True, True),
    (2, 200, 3, 64, 64, 64, False, True),
    (2, 200, 3, 64, 128, 64, True, False),
    # (P, N) outside the compiled pairs, through the cover: padded in one
    # launch, split over head dims or over state blocks (y summed in f32)
    (2, 200, 3, 48, 96, 64, True, True),         # padded into (64, 128)
    (2, 300, 4, 128, 128, 100, True, True),      # two (64, 128) head-dim blocks
    (2, 200, 3, 16, 64, 64, True, False),        # four (16, 16) state blocks
    (2, 100, 2, 8, 8, 32, False, True),          # padded into (16, 16)
    (4, 512, 32, 64, 256, 256, True, True),      # two (64, 128) state blocks
])
def test_ssd_chunk_kernel(gen, dtype, b, s, h, p, n, chunk, h0, shared):
    args = _ssd_inputs(gen, b, s, h, p, n, dtype, h0=h0, shared_bc=shared)
    _, _, n_p, n_n = ssd_ops.cover(p, n, chunk=min(chunk, s), heads=h,
                                   groups=1 if shared else h)
    before = ssd_scan.launches
    y, hf = ssd_scan(*args[:5], chunk=chunk, h0=args[5])
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + n_p * n_n
    y_r, h_r = ssd_ref(*args[:5], chunk=chunk, h0=args[5])
    atol, rtol = TOL["ssd"][dtype]
    torch.testing.assert_close(y.float(), y_r.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(hf, h_r, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,chunk,h0", [(512, 256, False), (300, 100, True)])
def test_ssd_chunk_shared_and_per_head_agree(gen, dtype, s, chunk, h0):
    """B and C as the mixer's stride-0 broadcast (C·Bᵀ once per (batch,
    chunk)) and as per-head copies of the same values (C·Bᵀ per head) give
    the same result, and both match the plain version."""
    x, dt, a, bm, cm, state = _ssd_inputs(gen, 2, s, 8, 64, 128, dtype, h0=h0, shared_bc=True)
    assert ssd_ops.shared_cb(bm, cm) and not ssd_ops.shared_cb(bm.contiguous(), cm.contiguous())
    y1, h1 = ssd_scan(x, dt, a, bm, cm, chunk=chunk, h0=state)
    y2, h2 = ssd_scan(x, dt, a, bm.contiguous(), cm.contiguous(), chunk=chunk, h0=state)
    torch.testing.assert_close(y1.float(), y2.float(), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(h1, h2, atol=1e-6, rtol=1e-6)
    y_r, h_r = ssd_ref(x, dt, a, bm, cm, chunk=chunk, h0=state)
    atol, rtol = TOL["ssd"][dtype]
    torch.testing.assert_close(y1.float(), y_r.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(h1, h_r, atol=atol, rtol=rtol)


def test_ssd_chunk_repeatable_one_launch(gen):
    """Two calls on the same inputs give the same bits (no atomics; every
    sum in a fixed order), and each call counts one launch."""
    args = _ssd_inputs(gen, 4, 512, 64, 64, 128, torch.float32, h0=True, shared_bc=True)
    before = ssd_scan.launches
    y1, h1 = ssd_scan(*args[:5], chunk=256, h0=args[5])
    assert ssd_scan.launches == before + 1
    y2, h2 = ssd_scan(*args[:5], chunk=256, h0=args[5])
    assert ssd_scan.launches == before + 2
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def test_ssd_chunk_unaligned_operands(gen):
    """f32 x, B, C and h0 that are not 16-byte aligned (views one element
    into a buffer) are staged through registers, not cp.async."""
    b, s, h, p, n = 2, 200, 4, 64, 128
    args = list(_ssd_inputs(gen, b, s, h, p, n, torch.float32, h0=True))
    for i in (0, 3, 4, 5):
        buf = torch.empty(args[i].numel() + 1, device="cuda")
        buf[1:] = args[i].reshape(-1)
        args[i] = buf[1:].view(args[i].shape)
        assert args[i].data_ptr() % 16 != 0
    y, hf = ssd_scan(*args[:5], chunk=64, h0=args[5])
    y_r, h_r = ssd_ref(*args[:5], chunk=64, h0=args[5])
    atol, rtol = TOL["ssd"][torch.float32]
    torch.testing.assert_close(y, y_r, atol=atol, rtol=rtol)
    torch.testing.assert_close(hf, h_r, atol=atol, rtol=rtol)


_PLAN_SHAPES = [(4, 512, 64, 64, 128, 256, False, True), (1, 300, 2, 64, 128, 100, True, True),
                (2, 200, 3, 64, 128, 64, True, False), (2, 200, 3, 32, 32, 64, True, False),
                (2, 96, 2, 16, 16, 32, False, True)]


@pytest.mark.parametrize("b,s,h,p,n,chunk,h0,shared", _PLAN_SHAPES)
def test_ssd_chunk_every_plan(gen, b, s, h, p, n, chunk, h0, shared):
    """Each plan the rule takes matches the plain version: C·Bᵀ's tiles in
    the chunk states' launch at P 64, in a launch of their own below."""
    assert ssd_plan(b, s, h, p, n, chunk=chunk) == (p == 64)
    x, dt, a, bm, cm, state = _ssd_inputs(gen, b, s, h, p, n, torch.float32, h0=h0,
                                          shared_bc=shared)
    y, hf = ssd_scan(x, dt, a, bm, cm, chunk=chunk, h0=state)
    y_r, h_r = ssd_ref(x, dt, a, bm, cm, chunk=chunk, h0=state)
    atol, rtol = TOL["ssd"][torch.float32]
    torch.testing.assert_close(y, y_r, atol=atol, rtol=rtol)
    torch.testing.assert_close(hf, h_r, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_len,window", [(1, 0), (101, 0), (192, 0), (300, 0), (150, 64)])
def test_decode_attn_kernel(gen, dtype, cache_len, window):
    q = _rn(gen, 8, 1, 12, 64, dtype=dtype)
    kc, vc = _rn(gen, 8, 192, 12, 64, dtype=dtype), _rn(gen, 8, 192, 12, 64, dtype=dtype)
    out = decode_attention(q, kc, vc, cache_len, window=window)
    _close(out, decode_ref(q, kc, vc, cache_len, window=window), TOL["decode"][dtype])


def test_decode_attn_kernel_gqa(gen):
    q = _rn(gen, 2, 1, 8, 32)
    kc, vc = _rn(gen, 2, 256, 2, 32), _rn(gen, 2, 256, 2, 32)
    _close(decode_attention(q, kc, vc, 201), decode_ref(q, kc, vc, 201), 2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sc,h,kh,d,cache_len,window,split", [
    # B·H 1: the rule's largest cluster, 16, on any card of ≥ 4 SMs; cache_len
    # 1 leaves 15 ranks empty, 1000 and 37 do not divide among 16
    (1, 1024, 1, 1, 64, 1, 0, 16), (1, 1024, 1, 1, 64, 1000, 0, 16),
    (1, 1024, 1, 1, 64, 37, 0, 16), (1, 1024, 1, 1, 128, 1024, 0, 16),
    # the serving B·H 96 (split by the SM count)
    (8, 1024, 12, 12, 64, 1, 0, None), (8, 1024, 12, 12, 64, 777, 0, None),
    (8, 192, 12, 12, 64, 191, 0, None),
    # fewer than 2·32 positions at most and B·H 96 (a block for every SM of
    # fewer than 192 without a split): split 1
    (8, 48, 12, 12, 64, 48, 0, 1), (8, 2048, 12, 12, 64, 2000, 40, 1),
    # window with GQA, and each head width
    (2, 1024, 8, 2, 128, 1000, 100, None), (2, 512, 8, 4, 64, 400, 300, None),
    (4, 512, 8, 8, 32, 333, 0, None), (2, 512, 16, 16, 128, 512, 0, None),
])
def test_decode_attn_kernel_splits(gen, dtype, b, sc, h, kh, d, cache_len, window, split):
    """The split-KV kernel at the rule's smallest and largest clusters, with
    empty ranks and shares that do not divide evenly: held against the plain
    version; ``split`` (where not None) is the cluster the rule must take."""
    if split is not None:
        assert split_plan(b, sc, h, window=window) == split
    q = _rn(gen, b, 1, h, d, dtype=dtype)
    kc, vc = _rn(gen, b, sc, kh, d, dtype=dtype), _rn(gen, b, sc, kh, d, dtype=dtype)
    _close(decode_attention(q, kc, vc, cache_len, window=window),
           decode_ref(q, kc, vc, cache_len, window=window), TOL["decode"][dtype])


@pytest.mark.parametrize("sparse", [None, SERVE_SPARSE])
def test_decode_attn_kernel_repeatable_one_launch(gen, sparse):
    """Two calls on the same inputs give the same bits (the ranks merge in
    a fixed order), each call is one launch, and the split does not move
    with cache_len."""
    q = _rn(gen, 8, 1, 12, 64)
    kc, vc = _rn(gen, 8, 1024, 12, 64), _rn(gen, 8, 1024, 12, 64)
    before = decode_attention.launches
    first = decode_attention(q, kc, vc, 960, sparse=sparse)
    assert decode_attention.launches == before + 1
    second = decode_attention(q, kc, vc, 960, sparse=sparse)
    assert decode_attention.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert split_plan(8, 1024, 12, sparse=sparse) > 1


def test_decode_attn_kernel_unaligned(gen):
    """Caches 4 bytes past a 16-byte boundary: the element-load path."""
    q, kc, vc = _unaligned(gen, 2, 1, 8, 64), _unaligned(gen, 2, 300, 4, 64), _unaligned(gen, 2, 300, 4, 64)
    for cache_len, sparse in ((1, None), (257, None), (300, SparseAttnConfig(
            block_size=32, local_blocks=2, sink_blocks=1, stride=4))):
        _close(decode_attention(q, kc, vc, cache_len, sparse=sparse),
               decode_ref(q, kc, vc, cache_len, sparse=sparse), TOL["decode"][torch.float32])


@pytest.mark.parametrize("d", [240, 16])
def test_decode_attn_kernel_unaligned_row_widths(gen, d):
    """Caches 4 bytes past a 16-byte boundary at the row widths below
    their layout's (240 at 256, 16 at 32): the element-load path, whose
    chunks past the row read the row's first chunk."""
    q, kc, vc = _unaligned(gen, 2, 1, 8, d), _unaligned(gen, 2, 300, 4, d), _unaligned(gen, 2, 300, 4, d)
    for cache_len, window in ((1, 0), (257, 0), (300, 100)):
        _close(decode_attention(q, kc, vc, cache_len, window=window),
               decode_ref(q, kc, vc, cache_len, window=window), TOL["decode"][torch.float32])


@pytest.mark.parametrize("arch,prompt_len,impl", [("gpt2-small", 9, "auto"),
                                                  ("whisper-base", 32, "auto"),
                                                  ("deepseek-v2-236b", 32, "auto"),
                                                  ("deepseek-v2-236b", 32, "sparse"),
                                                  ("gpt2-small", 32, "sparse"),
                                                  ("mamba2-1.3b", 40, "auto"),
                                                  ("gemma3-12b", 70, "auto")])
def test_serving_on_card_matches_cpu(gen, arch, prompt_len, impl):
    """Reduced serving on the card (kernels) vs the CPU (plain): dense and
    block-sparse gpt2, mamba2 (its prompt ends inside a scan chunk),
    gemma3 (two ``local`` layers whose 64-slot rings wrap in prefill and
    decode), whisper (the encoder-decoder, its frames) and deepseek-v2 (MLA
    at (96, 64), dense and block-sparse)."""
    from repro_torch import trees
    from repro_torch.launch import serve
    args = serve.parse_args(["--arch", arch, "--reduced", "--batch", "2",
                             "--prompt-len", str(prompt_len), "--gen", "4",
                             "--lora-rank", "4"])
    model, params, lora, scale, prompts, _, frames = serve.build(args, impl=impl)
    lora = trees.map_with_path(lambda p, t: t if p.endswith("/mask") else
                               _rn(gen, *t.shape, std=0.05), lora)
    res = serve.generate(model, params, prompts, 4, lora=lora, lora_scale=scale,
                         frames=frames)
    from repro_torch.models.transformer import Model
    cpu = Model(model.cfg, device="cpu", impl=impl)
    p_cpu = trees.map_with_path(lambda _, t: t.cpu(), params)
    l_cpu = trees.map_with_path(lambda _, t: t.cpu(), lora)
    lg, cache = cpu.prefill(p_cpu, prompts.cpu(), prompt_len + 4, lora=l_cpu,
                            lora_scale=scale,
                            frames=None if frames is None else frames.cpu())
    torch.testing.assert_close(lg, res["logits"][0].cpu(), atol=1e-4, rtol=0)
    for t in range(4):
        lg, cache = cpu.decode_step(p_cpu, cache, res["tokens"][:, t:t + 1].cpu(),
                                    lora=l_cpu, lora_scale=scale)
        torch.testing.assert_close(lg, res["logits"][t + 1].cpu(), atol=1e-4, rtol=0)


def test_wrappers_refuse_grad_on_card(gen):
    """The serving-only CUDA entry points (decode, block-sparse) raise when
    an operand requires grad under grad mode (their kernels have no
    backward and would drop it) and run under torch.no_grad(); lora_matmul,
    flash_attention and ssd_scan go through their autograd Functions, so
    the gradients arrive."""
    x, w = _rn(gen, 4, 64), _rn(gen, 64, 32)
    a, b = _rn(gen, 64, 4).requires_grad_(), _rn(gen, 4, 32)
    q, q1 = _rn(gen, 2, 64, 4, 32).requires_grad_(), _rn(gen, 2, 1, 4, 32).requires_grad_()
    kv = _rn(gen, 2, 64, 4, 32)
    cfg = SparseAttnConfig(block_size=16, local_blocks=2, sink_blocks=1, stride=2)
    ssd = list(_ssd_inputs(gen, 1, 32, 2, 16, 16, torch.float32))
    ssd[0].requires_grad_()
    calls = {"decode_attention": lambda: decode_attention(q1, kv, kv, 10),
             "block_sparse_attention": lambda: block_sparse_attention(q, kv, kv, cfg)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel is forward-only"):
            call()
        with torch.no_grad():
            call()
    lora_matmul(x, w, a, b, scale=2.0).sum().backward()
    flash_attention(q, kv, kv, causal=False).sum().backward()
    ssd_scan(*ssd[:5], chunk=16)[0].sum().backward()
    torch.cuda.synchronize()
    assert a.grad is not None and bool(a.grad.abs().sum() > 0)
    assert q.grad is not None and bool(q.grad.abs().sum() > 0)
    assert ssd[0].grad is not None and bool(ssd[0].grad.abs().sum() > 0)


def _grads(fn, *ins):
    """(output, input gradients) of ``fn`` under a fixed random cotangent."""
    ins = [t.detach().clone().requires_grad_() for t in ins]
    out = fn(*ins)
    g = torch.randn(out.shape, generator=torch.Generator(device=out.device).manual_seed(1),
                    device=out.device)
    return out, torch.autograd.grad(out, ins, g)


@pytest.mark.parametrize("m,k,n,r", [(512, 128, 128, 8), (2048, 768, 768, 8),
                                     (77, 130, 200, 16), (2048, 768, 768, 64),
                                     (8, 768, 768, 64)])
def test_lora_function_grads_on_card(gen, m, k, n, r):
    """``LoraMatmul`` on the card (kernel forward, plain backward) against
    autograd of the plain version on the card: dx, dW, dA, dB."""
    x, w = _rn(gen, m, k), _rn(gen, k, n, std=0.05)
    a, b = _rn(gen, k, r, std=0.05), _rn(gen, r, n, std=0.05)
    before = lora_matmul.launches
    out, got = _grads(lambda *t: lora_matmul(*t, scale=2.0), x, w, a, b)
    assert lora_matmul.launches == before + 1
    ref, want = _grads(lambda *t: lora_ref(*t, scale=2.0), x, w, a, b)
    _close(out, ref, TOL["lora"][torch.float32])
    for g_, w_ in zip(got, want):
        _close(g_, w_, TOL["lora"][torch.float32])


def test_flash_function_grads_mla_widths_on_card(gen):
    """``FlashAttention`` at (96, 64) with the scale of q/k 80 (ARCH-ROUND's
    deepseek-v2 at d 256), q/k padded by a ``cat`` outside the Function:
    the unpadded inputs' gradients against autograd of the plain version."""
    q, k, v = _rn(gen, 4, 16, 4, 80), _rn(gen, 4, 16, 4, 80), _rn(gen, 4, 16, 4, 64)

    def call(fn):
        def f(q, k, v):
            pad = q.new_zeros(*q.shape[:3], 16)
            return fn(torch.cat([q, pad], -1), torch.cat([k, pad], -1), v, causal=True,
                      scale=80 ** -0.5)
        return f

    out, got = _grads(call(flash_attention), q, k, v)
    ref, want = _grads(call(attention_ref), q, k, v)
    _close(out, ref, TOL["flash"][torch.float32])
    for g_, w_ in zip(got, want):
        _close(g_, w_, TOL["flash"][torch.float32])


@pytest.mark.parametrize("dk,dv", [(288, 272), (528, 512), (34, 18)])
def test_flash_function_grads_any_width_on_card(gen, dk, dv):
    """``FlashAttention`` at MLA's pairs of the launcher's d 1088 and 2048
    (sliced) and d 72 (elements): the kernel's forward (one launch) and
    every input gradient against autograd of the plain version."""
    q, k, v = _rn(gen, 2, 40, 4, dk), _rn(gen, 2, 40, 4, dk), _rn(gen, 2, 40, 4, dv)
    before = flash_attention.launches
    out, got = _grads(lambda *t: flash_attention(*t, causal=True, scale=dk ** -0.5), q, k, v)
    assert flash_attention.launches == before + 1
    ref, want = _grads(lambda *t: attention_ref(*t, causal=True, scale=dk ** -0.5), q, k, v)
    _close(out, ref, TOL["flash"][torch.float32])
    for g_, w_ in zip(got, want):
        _close(g_, w_, TOL["flash"][torch.float32])


@pytest.mark.parametrize("b,s,h,kh,d,causal", [(8, 32, 4, 4, 32, False),
                                               (16, 128, 12, 12, 64, False),
                                               (2, 96, 8, 2, 64, True),
                                               # PFIT's policy (S 39) and gpt2's
                                               # PPO step (S 191, no tile multiple)
                                               (16, 39, 4, 4, 32, True),
                                               (8, 191, 12, 12, 64, True)])
def test_flash_function_grads_on_card(gen, b, s, h, kh, d, causal):
    """``FlashAttention`` on the card (kernel forward, softmax VJP by
    recomputation) against autograd of the plain version on the card."""
    q, k, v = _rn(gen, b, s, h, d), _rn(gen, b, s, kh, d), _rn(gen, b, s, kh, d)
    before = flash_attention.launches
    out, got = _grads(lambda *t: flash_attention(*t, causal=causal), q, k, v)
    assert flash_attention.launches == before + 1
    ref, want = _grads(lambda *t: attention_ref(*t, causal=causal), q, k, v)
    _close(out, ref, TOL["flash"][torch.float32])
    for g_, w_ in zip(got, want):
        _close(g_, w_, TOL["flash"][torch.float32])


@pytest.mark.parametrize("b,s,h,p,n,chunk,h0", [(3, 24, 32, 16, 16, 32, False),
                                                 (2, 100, 8, 64, 128, 32, True),
                                                 # through the cover
                                                 (2, 60, 4, 48, 96, 32, True),
                                                 (2, 60, 4, 128, 128, 32, False),
                                                 (2, 60, 4, 16, 64, 32, True),
                                                 (2, 60, 4, 8, 8, 32, False)])
def test_ssd_function_grads_on_card(gen, b, s, h, p, n, chunk, h0):
    """``SSDScan`` on the card (the kernel forward, the recomputed plain
    backward): every input gradient against autograd of ``ssd_ref`` on the
    card, at the arch round's jamba/mamba2 shape (d 256: 32 heads of 16,
    state 16) and a multi-chunk case with h0, B and C a stride-0 broadcast."""
    x, dt, a, bm, cm, hh = _ssd_inputs(gen, b, s, h, p, n, torch.float32, h0=h0,
                                       shared_bc=True)
    ins = [x, dt, a, bm[:, :, :1].contiguous(), cm[:, :, :1].contiguous()] + (
        [hh] if h0 else [])

    def run(fn):
        leaves = [t.detach().clone().requires_grad_() for t in ins]
        bc = [t.expand(b, s, h, n) for t in leaves[3:5]]
        y, hf = fn(*leaves[:3], *bc, leaves[5] if h0 else None)
        g = torch.Generator(device="cuda").manual_seed(1)
        loss = ((y * torch.randn(y.shape, generator=g, device="cuda")).sum()
                + (hf * torch.randn(hf.shape, generator=g, device="cuda")).sum())
        return torch.autograd.grad(loss, leaves)

    got = run(lambda *t: ssd_scan(*t[:5], chunk=chunk, h0=t[5]))
    want = run(lambda *t: ssd_ref(*t[:5], chunk=chunk, h0=t[5]))
    for gk, gp in zip(got, want):
        torch.testing.assert_close(gk, gp, atol=5e-4, rtol=1e-3)


def test_peft_step_on_card_matches_cpu(gen):
    """Two ``make_peft_step`` steps of the reduced RoBERTa on the card
    (both kernels, their Functions) against the same steps on the CPU (the
    plain versions): losses and trainables."""
    from repro_torch import trees
    from repro_torch.launch import train
    argv = ["--arch", "roberta-base", "--reduced", "--batch", "4", "--seq", "32",
            "--lora-rank", "8"]
    card = train.Trainer(train.parse_args(argv))
    cpu = train.Trainer(train.parse_args(argv + ["--device", "cpu"]))
    rng = __import__("numpy").random.RandomState(0)
    for _ in range(2):
        batch = card.batch(rng)
        before = (lora_matmul.launches, flash_attention.launches)
        lc = card.step(card.to_device(batch))
        assert (lora_matmul.launches - before[0], flash_attention.launches - before[1]) == (2, 1)
        lp = cpu.step(cpu.to_device(batch))
        torch.testing.assert_close(lc.cpu(), lp, atol=1e-4, rtol=1e-4)
    got = trees.flatten(card.trainable)
    for path, want in trees.flatten(cpu.trainable).items():
        torch.testing.assert_close(got[path].cpu(), want, atol=1e-4, rtol=0, msg=path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_len", [1, 17, 39, 40])
def test_decode_attn_kernel_hd32(gen, dtype, cache_len):
    """Head width 32 (PFIT's policy and reward models): B 16, 4 heads, a
    cache of 40, every length a rollout reads."""
    q = _rn(gen, 16, 1, 4, 32, dtype=dtype)
    kc, vc = _rn(gen, 16, 40, 4, 32, dtype=dtype), _rn(gen, 16, 40, 4, 32, dtype=dtype)
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, cache_len)
    assert decode_attention.launches == before + 1
    _close(out, decode_ref(q, kc, vc, cache_len), TOL["decode"][dtype])


def test_pfit_rollout_and_ppo_step_on_card_matches_cpu(gen):
    """A reduced GPT-2 policy (d 128, 2 layers, 4 heads of 32: PFIT's head
    width): a rollout through the serving kernels samples the CPU's tokens
    from the same noise, and one masked PPO step through causal
    ``FlashAttention`` matches the CPU's loss (1e-4) and parameters (1e-4,
    except where AdamW's first step cannot carry the gradient's own
    card-vs-CPU difference: there 2·lr, as ``chip_smoke.py``'s
    TRAIN-ROBERTA); masked-out parameters stay bit-equal."""
    from repro_torch import trees
    from repro_torch.configs import get_config
    from repro_torch.models import peft
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw
    from repro_torch.rlhf import ppo, rollout
    cfg = get_config("gpt2-small").reduced(d_model=128, repeats=2)
    prompts = torch.randint(6, 512, (4, 8), generator=torch.Generator().manual_seed(0))
    reward = torch.randn(4, generator=torch.Generator().manual_seed(1))
    lr, tol = 4e-4, 1e-4
    out = {}
    for dev in ("cuda", "cpu"):
        model = Model(cfg, device=dev)
        params = model.init(torch.Generator().manual_seed(0))
        params["value_head"] = torch.zeros(cfg.d_model, 1, device=dev)
        mask = trees.map_leaves(lambda a, b: a * b, peft.last_k_layers_mask(params, cfg, 1),
                                peft.head_sparsity_mask(params, cfg, 0.5, 0))
        noise = rollout.gumbel_stream(0, 3, 6, 4, cfg.vocab_size, dev)
        before = decode_attention.launches
        toks = rollout.generate(model, params, prompts.to(dev), 6, noise)
        if dev == "cuda":
            assert decode_attention.launches == before + 2 * 6
        opt = adamw(lr)
        prep, step = ppo.make_ppo_fns(model, opt, ppo.PPOConfig(), 8)
        # the step on the card's tokens on both sides
        toks_in = toks if dev == "cuda" else out["cuda"]["toks"].cpu()
        prepped = prep(params, params, toks_in, reward.to(dev))
        new, st, loss, _ = step(params, opt.init(params), toks_in, *prepped[:4], mask)
        flat = lambda t: {k: v.cpu() for k, v in trees.flatten(t).items()}  # noqa: E731
        out[dev] = dict(toks=toks, new=flat(new), mu=flat(st["mu"]), loss=float(loss),
                        init=flat(params), mask=flat(mask))
    card, cpu = out["cuda"], out["cpu"]
    assert torch.equal(card["toks"].cpu(), cpu["toks"])
    assert abs(card["loss"] - cpu["loss"]) <= tol * max(1.0, abs(cpu["loss"]))
    gain = 1 + lr / (4 * tol)
    for k, want in cpu["new"].items():
        d = (card["new"][k] - want).abs()
        g_card, g_cpu = card["mu"][k] / 0.1, cpu["mu"][k] / 0.1   # AdamW's first moment
        unsure = g_cpu.abs() < gain * (g_card - g_cpu).abs()
        assert float((d * ~unsure).max()) <= tol, k
        assert float((d * unsure).max()) <= 2 * lr, k
        off = torch.broadcast_to(cpu["mask"][k], want.shape) == 0
        assert torch.equal(card["new"][k][off], cpu["init"][k][off]), k


def test_robust_pftt_on_card_matches_cpu(gen):
    """A robust ``run_pftt`` (d 128: the kernels' head width 32; 3 clients,
    2 rounds) under
    ``tests/test_deadline.py``'s ``MIX`` fault plan and ``DL`` deadline on
    the card against the CPU from the same init: every round record equal
    (the host decides them), accuracies within 0.05 (``chip_smoke.py``'s
    TRAIN-PFTT tolerance)."""
    import numpy as np

    from repro_torch.core import pftt
    from repro_torch.wireless import DeadlineConfig, FaultPlan
    kw = dict(d_model=128, n_clients=3, rounds=2, local_steps=2, pretrain_steps=3,
              samples_per_client=40, batch=32, staleness_a=0.5, max_staleness=3,
              fault_plan=FaultPlan(dropout_p=0.25, straggle_p=0.3, max_straggle=2,
                                   crash_p=0.1, max_crash=1, snr_dip_p=0.2, corrupt_p=0.25,
                                   seed=5),
              deadline=DeadlineConfig(deadline_s=0.05, backoff_base_s=0.01, max_retries=3,
                                      min_quorum=2, compute_mean_s=0.005, seed=11))
    card = pftt.run_pftt(pftt.PFTTConfig(**kw))
    cpu = pftt.run_pftt(pftt.PFTTConfig(device="cpu", **kw))
    np.testing.assert_equal(card["round_records"], cpu["round_records"])
    assert card["staleness"] == cpu["staleness"]
    np.testing.assert_allclose(card["acc_per_round"], cpu["acc_per_round"], atol=0.05)


@pytest.mark.parametrize("name", ["int8", "int4", "sketch", "countsketch"])
def test_codec_roundtrip_on_card_matches_cpu(gen, name):
    """One client's upload (LoRA factors, a raw enable mask, a head partly
    masked, an embedding never uploaded) through ``roundtrip`` on the card
    against the CPU, on the same tensors with the default uniforms (a
    counter-based stream, so the same on both): bits within 1e-6 relative;
    under the quantizers the scales equal and the symbols one step apart at
    most, on ≤ 1e-6 of the elements; the sketches' decode within 1e-5 (the
    card's scatter-add order); the uniforms and hashes equal."""
    from repro_torch import trees
    from repro_torch.comms import codec, sketch

    shapes = {"lora/a": (2, 768, 8), "lora/b": (2, 8, 768), "lora/mask": (2, 1, 1),
              "head": (768, 4), "emb": (512, 768)}
    up = trees.unflatten({k: _rn(gen, *s, std=0.05) for k, s in shapes.items()})
    ref = trees.map_leaves(lambda v: v + _rn(gen, *v.shape, std=0.01), up)
    masks = trees.map_leaves(lambda v: torch.ones((1,) * v.dim(), device="cuda"), up)
    masks["head"] = (torch.rand(768, 1, generator=gen, device="cuda") > 0.5).float()
    masks["emb"] = torch.zeros(1, 1, device="cuda")
    c = codec.get_codec(name)
    out = {}
    for dev in ("cuda", "cpu"):
        rec = {}
        move = functools.partial(trees.map_leaves, lambda v: v.to(dev))
        dec, bits = codec.roundtrip(
            c, move(up), ref=move(ref), bit_weights=move(masks), record=rec,
            noise=lambda leaf, shape, dev=dev: codec.codec_uniforms(0, 1, 2, leaf, shape, dev))
        out[dev] = (trees.flatten(dec), float(bits), rec)
    (dc, bc, rc), (dp, bp, rp) = out["cuda"], out["cpu"]
    assert abs(bc - bp) <= 1e-6 * bp and bp > 0
    if name.startswith("int"):
        for k, enc in rp.items():
            assert torch.equal(rc[k]["scale"].cpu(), enc["scale"]), k
            d = (rc[k]["q"].cpu().int() - enc["q"].int()).abs()
            assert int(d.max()) <= 1 and int((d > 0).sum()) <= 1e-6 * d.numel(), k
    else:
        for k, v in dp.items():
            torch.testing.assert_close(dc[k].cpu(), v, atol=1e-5, rtol=0)
    assert torch.equal(codec.codec_uniforms(0, 1, 2, 3, (4096, 33), "cuda").cpu(),
                       codec.codec_uniforms(0, 1, 2, 3, (4096, 33), "cpu"))
    for a, b in zip(sketch.cs_hashes(3, 100000, 3, 7001, "cuda"),
                    sketch.cs_hashes(3, 100000, 3, 7001, "cpu")):
        assert torch.equal(a.cpu(), b)
