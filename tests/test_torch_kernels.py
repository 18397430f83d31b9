"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's Pallas kernels in interpret mode, f32, inputs from numpy
seeds.  Tolerances are those of ``tests/test_kernels.py``: 1e-4 for the
LoRA product (a K-long f32 sum in another order), 2e-5 for attention.
The same wrappers on CUDA tensors launch the hand-written kernels; those
cases are in ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ops import decode_attention as j_decode
from repro.kernels.flash_attn.ops import flash_attention as j_flash
from repro.configs.base import SparseAttnConfig as JSparse
from repro.kernels.lora_fused.ops import lora_matmul as j_lora
from repro.models import attention as j_attn
from repro.models.attention import dense_attention as j_dense
from repro_torch.configs import SparseAttnConfig
from repro_torch.kernels.decode_attn.ops import decode_attention
from repro_torch.kernels.decode_attn.ref import decode_ref, decode_split_ref
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.kernels.flash_attn.ref import attention_ref
from repro_torch.kernels.lora_fused.ops import lora_matmul
from repro_torch.kernels.lora_fused.ref import lora_ref


def _randn(rng, *shape, std=1.0):
    return (rng.randn(*shape) * std).astype(np.float32)


def _qkv(seed, b, sq, sk, h, kh, d):
    rng = np.random.RandomState(seed)
    return _randn(rng, b, sq, h, d), _randn(rng, b, sk, kh, d), _randn(rng, b, sk, kh, d)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("m,k,n,r", [(128, 256, 384, 8), (64, 128, 128, 16),
                                     (77, 128, 96, 8), (8, 128, 128, 4),
                                     (17, 130, 70, 32), (300, 96, 200, 3),
                                     (512, 128, 192, 8)])
def test_lora_ref_matches_pallas_lora(m, k, n, r):
    rng = np.random.RandomState(4)
    x, w = _randn(rng, m, k), _randn(rng, k, n, std=0.05)
    a, b = _randn(rng, k, r, std=0.05), _randn(rng, r, n, std=0.05)
    ref = np.asarray(j_lora(jnp.asarray(x), jnp.asarray(w), jnp.asarray(a),
                            jnp.asarray(b), scale=2.0, interpret=True))
    out = lora_ref(*_t(x, w, a, b), scale=2.0)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
    # the wrapper on CPU tensors is the plain version, leading dims flattened
    wrapped = lora_matmul(*_t(x.reshape(1, m, k), w, a, b), scale=2.0)
    np.testing.assert_array_equal(wrapped.numpy()[0], out.numpy())


def test_lora_ref_rounds_xa_to_operand_type():
    """bf16: x·A is rounded to bf16 before the rank-r product, as the TPU
    kernel's ``xa.astype(b.dtype)``."""
    rng = np.random.RandomState(5)
    x, w, a, b = _t(_randn(rng, 8, 64), _randn(rng, 64, 32, std=0.05),
                    _randn(rng, 64, 4, std=0.05), _randn(rng, 4, 32, std=0.05))
    xb, wb, ab, bb = (t.bfloat16() for t in (x, w, a, b))
    out = lora_ref(xb, wb, ab, bb, scale=2.0)
    xa = (xb.float() @ ab.float()).bfloat16().float()
    want = (xb.float() @ wb.float() + 2.0 * (xa @ bb.float())).bfloat16()
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, want, atol=0, rtol=0)


@pytest.mark.parametrize("b,s,h,kh,d,bq,bk", [(2, 256, 8, 4, 64, 64, 64),
                                               (1, 128, 4, 4, 32, 128, 32)])
@pytest.mark.parametrize("window", [0, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_pallas_flash(b, s, h, kh, d, bq, bk, window, causal):
    q, k, v = _qkv(0, b, s, s, h, kh, d)
    ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window, bq=bq, bk=bk,
                             interpret=True))
    out = attention_ref(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
    wrapped = flash_attention(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_array_equal(wrapped.numpy(), out.numpy())


@pytest.mark.parametrize("sq,window", [(77, 0), (77, 24), (33, 0)])
def test_attention_ref_ragged_matches_dense(sq, window):
    """Prompt lengths that no Pallas block divides: held against the jnp
    model attention the JAX serving path calls."""
    q, k, v = _qkv(1, 2, sq, sq, 6, 2, 32)
    ref = np.asarray(j_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=window))
    out = flash_attention(*_t(q, k, v), causal=True, window=window)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("pos,window", [(0, 0), (100, 0), (255, 0), (200, 64)])
def test_decode_ref_matches_pallas_decode(pos, window):
    rng = np.random.RandomState(6)
    q, kc, vc = (_randn(rng, 2, 1, 8, 64), _randn(rng, 2, 256, 4, 64),
                 _randn(rng, 2, 256, 4, 64))
    ref = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                              pos, window=window, bk=64, interpret=True))
    # the port's convention: cache_len = pos + 1 valid positions
    out = decode_ref(*_t(q, kc, vc), pos + 1, window=window)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
    wrapped = decode_attention(*_t(q, kc, vc), pos + 1, window=window)
    np.testing.assert_array_equal(wrapped.numpy(), out.numpy())


SPLITS = (1, 2, 3, 4, 8, 16)
_PALLAS_DECODE = {}   # (pos, window) -> the JAX kernel's output, computed once


def _decode_inputs():
    rng = np.random.RandomState(6)
    return (_randn(rng, 2, 1, 8, 64), _randn(rng, 2, 256, 4, 64),
            _randn(rng, 2, 256, 4, 64))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("pos,window", [(0, 0), (100, 0), (255, 0), (200, 64), (7, 3)])
def test_decode_split_ref_matches_pallas_decode(split, pos, window):
    """The kernel's split-KV arithmetic (even contiguous shares of the
    positions read, each share's (m, l, acc), merged in rank order) against
    the JAX package's Pallas decode kernel in interpret mode.  pos 0 leaves
    every share but the last empty; window 3 reads fewer positions than
    most splits have shares."""
    q, kc, vc = _decode_inputs()
    if (pos, window) not in _PALLAS_DECODE:
        _PALLAS_DECODE[pos, window] = np.asarray(j_decode(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), pos, window=window,
            bk=64, interpret=True))
    out = decode_split_ref(*_t(q, kc, vc), pos + 1, split, window=window)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), _PALLAS_DECODE[pos, window], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("pattern", [dict(block_size=32, local_blocks=2, sink_blocks=1, stride=4),
                                     dict(block_size=64, local_blocks=1, sink_blocks=2, stride=2)])
@pytest.mark.parametrize("cache_len", [1, 33, 97, 130, 256])
def test_decode_split_ref_matches_jax_sparse_decode(split, pattern, cache_len):
    """The same arithmetic under the block-sparse position mask against the
    JAX package's model-level sparse decode (the patterns of
    test_torch_sparse.py)."""
    rng = np.random.RandomState(3)
    q, kc, vc = _randn(rng, 2, 1, 8, 32), _randn(rng, 2, 256, 2, 32), _randn(rng, 2, 256, 2, 32)
    want = j_attn.decode_attention(*map(jnp.asarray, (q, kc, vc)), cache_len,
                                   sparse=JSparse(**pattern))
    out = decode_split_ref(*_t(q, kc, vc), cache_len, split,
                           sparse=SparseAttnConfig(**pattern))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_cpu_wrappers_count_no_launch():
    from repro_torch.kernels.block_sparse_attn.ops import block_sparse_attention
    from repro_torch.kernels.ssd_chunk.ops import ssd_scan
    wrappers = (lora_matmul, flash_attention, decode_attention, block_sparse_attention,
                ssd_scan)
    before = [f.launches for f in wrappers]
    x = torch.randn(4, 16)
    lora_matmul(x, torch.randn(16, 8), torch.randn(16, 2), torch.randn(2, 8),
                scale=1.0)
    q = torch.randn(1, 4, 2, 32)
    flash_attention(q, q, q)
    decode_attention(q[:, :1], q, q, 3)
    decode_attention(q[:, :1], q, q, 3, sparse=SparseAttnConfig(block_size=2))
    block_sparse_attention(q, q, q, SparseAttnConfig(block_size=2))
    ssd_scan(q, torch.rand(1, 4, 2), -torch.rand(2), q, q, chunk=2)
    assert before == [f.launches for f in wrappers]


def test_build_names_each_source_and_needs_nvcc(monkeypatch):
    """Each CUDA source maps to its own content-hashed library, and a
    machine without nvcc gets a clear error instead of a kernel."""
    from repro_torch.kernels import _build
    names = {"lora_fused", "flash_attn", "decode_attn", "block_sparse_attn", "ssd_chunk"}
    assert set(_build.sources()) == names
    libs = {_build._target(p).name for p in _build.sources().values()}
    assert len(libs) == len(names) and all(n.endswith(".so") for n in libs)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_wrappers_reject_bad_operands():
    x, w, a, b = torch.randn(4, 16), torch.randn(16, 8), torch.randn(16, 2), torch.randn(2, 8)
    with pytest.raises(ValueError, match="shapes"):
        lora_matmul(x, w, a, torch.randn(3, 8), scale=1.0)
    with pytest.raises(TypeError, match="dtype"):
        lora_matmul(x.double(), w, a, b, scale=1.0)
    with pytest.raises(ValueError, match="rank"):   # any rank ≥ 1 runs, as in JAX
        lora_matmul(x, w, torch.randn(16, 0), torch.randn(0, 8), scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        lora_matmul(x, torch.randn(8, 16).T, a, b, scale=1.0)
    q = torch.randn(1, 4, 3, 32)
    with pytest.raises(ValueError, match="H % K"):
        flash_attention(q, torch.randn(1, 4, 2, 32), torch.randn(1, 4, 2, 32))
    with pytest.raises(ValueError, match="one query token"):
        decode_attention(q, q, q, 2)
    with pytest.raises(ValueError, match="cache_len"):
        decode_attention(q[:, :1], q, q, 0)


def test_forward_only_guard():
    """The CUDA branch of every wrapper refuses an operand that requires
    grad under grad mode, and is silent under no_grad or for detached
    operands (the kernels are forward-only)."""
    from repro_torch.kernels import _build
    x, w = torch.randn(4, 8, requires_grad=True), torch.randn(8, 3)
    with pytest.raises(RuntimeError, match="lora_matmul: the CUDA kernel is forward-only"):
        _build.forward_only("lora_matmul", x, w, None)
    with torch.no_grad():
        _build.forward_only("lora_matmul", x, w, None)
    _build.forward_only("lora_matmul", x.detach(), w, None)
    _build.forward_only("ssd_scan", w, None)


def test_lora_matmul_cpu_grads_match_jax():
    """On CPU tensors the wrapper is the plain, differentiable version: the
    gradients of x and of the factors equal ``jax.grad`` of the JAX
    package's jnp factored projection (tolerance of test_lora_factored.py)."""
    import jax

    from repro.models.peft import lora_proj
    rng = np.random.RandomState(7)
    x, w = _randn(rng, 2, 5, 48), _randn(rng, 48, 40, std=0.05)
    a, b = _randn(rng, 48, 4, std=0.05), _randn(rng, 4, 40, std=0.05)
    g = _randn(rng, 2, 5, 40)

    def j_loss(x, a, b):
        lf = {"a": a, "b": b, "mask": jnp.ones((), jnp.float32)}
        return jnp.sum(lora_proj(x, jnp.asarray(w), lf, scale=2.0) * jnp.asarray(g))

    want = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    xt, at, bt = (torch.from_numpy(t).requires_grad_() for t in (x, a, b))
    y = lora_matmul(xt, torch.from_numpy(w), at, bt, scale=2.0)
    (y * torch.from_numpy(g)).sum().backward()
    for got, ref in zip((xt.grad, at.grad, bt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
