"""The hand-written kernels on the card against their plain versions.

Marked ``cuda``: they need an NVIDIA GPU with nvcc and skip elsewhere (the
decision is taken inside the fixture, never at import).  Run them on the
card with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerances are those of ``tests/test_kernels.py``.
"""
import pytest
import torch

from repro_torch.configs import SparseAttnConfig
from repro_torch.kernels.block_sparse_attn import ops as bsa_ops
from repro_torch.kernels.block_sparse_attn.ops import block_sparse_attention
from repro_torch.kernels.block_sparse_attn.ref import block_sparse_ref
from repro_torch.kernels.decode_attn.ops import decode_attention, split_plan
from repro_torch.kernels.decode_attn.ref import decode_ref
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.kernels.flash_attn.ref import attention_ref
from repro_torch.kernels.lora_fused.ops import lora_matmul
from repro_torch.kernels.lora_fused.ref import lora_ref
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk.ops import ssd_plan, ssd_scan
from repro_torch.kernels.ssd_chunk.ref import ssd_ref

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
                                     (4, 256, 20000, 8)])
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
])
def test_ssd_chunk_kernel(gen, dtype, b, s, h, p, n, chunk, h0, shared):
    args = _ssd_inputs(gen, b, s, h, p, n, dtype, h0=h0, shared_bc=shared)
    before = ssd_scan.launches
    y, hf = ssd_scan(*args[:5], chunk=chunk, h0=args[5])
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
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


@pytest.mark.parametrize("arch,prompt_len,impl", [("gpt2-small", 9, "auto"),
                                                  ("gpt2-small", 32, "sparse"),
                                                  ("mamba2-1.3b", 40, "auto")])
def test_serving_on_card_matches_cpu(gen, arch, prompt_len, impl):
    """Reduced serving on the card (kernels) vs the CPU (plain): dense and
    block-sparse gpt2, and mamba2 (its prompt ends inside a scan chunk)."""
    from repro_torch import trees
    from repro_torch.launch import serve
    args = serve.parse_args(["--arch", arch, "--reduced", "--batch", "2",
                             "--prompt-len", str(prompt_len), "--gen", "4",
                             "--lora-rank", "4"])
    model, params, lora, scale, prompts = serve.build(args, impl=impl)
    lora = trees.map_with_path(lambda p, t: t if p.endswith("/mask") else
                               _rn(gen, *t.shape, std=0.05), lora)
    res = serve.generate(model, params, prompts, 4, lora=lora, lora_scale=scale)
    from repro_torch.models.transformer import Model
    cpu = Model(model.cfg, device="cpu", impl=impl)
    p_cpu = trees.map_with_path(lambda _, t: t.cpu(), params)
    l_cpu = trees.map_with_path(lambda _, t: t.cpu(), lora)
    lg, cache = cpu.prefill(p_cpu, prompts.cpu(), prompt_len + 4, lora=l_cpu,
                            lora_scale=scale)
    torch.testing.assert_close(lg, res["logits"][0].cpu(), atol=1e-4, rtol=0)
    for t in range(4):
        lg, cache = cpu.decode_step(p_cpu, cache, res["tokens"][:, t:t + 1].cpu(),
                                    lora=l_cpu, lora_scale=scale)
        torch.testing.assert_close(lg, res["logits"][t + 1].cpu(), atol=1e-4, rtol=0)


def test_wrappers_refuse_grad_on_card(gen):
    """Each CUDA entry point raises when an operand requires grad under grad
    mode (the kernels are forward-only and would drop it), and runs under
    torch.no_grad()."""
    x, w = _rn(gen, 4, 64), _rn(gen, 64, 32)
    a, b = _rn(gen, 64, 4).requires_grad_(), _rn(gen, 4, 32)
    q, q1 = _rn(gen, 2, 64, 4, 32).requires_grad_(), _rn(gen, 2, 1, 4, 32).requires_grad_()
    kv = _rn(gen, 2, 64, 4, 32)
    cfg = SparseAttnConfig(block_size=16, local_blocks=2, sink_blocks=1, stride=2)
    ssd = list(_ssd_inputs(gen, 1, 32, 2, 16, 16, torch.float32))
    ssd[0].requires_grad_()
    calls = {"lora_matmul": lambda: lora_matmul(x, w, a, b, scale=2.0),
             "flash_attention": lambda: flash_attention(q, kv, kv),
             "decode_attention": lambda: decode_attention(q1, kv, kv, 10),
             "block_sparse_attention": lambda: block_sparse_attention(q, kv, kv, cfg),
             "ssd_scan": lambda: ssd_scan(*ssd[:5], chunk=16)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel is forward-only"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()
