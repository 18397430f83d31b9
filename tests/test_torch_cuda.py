"""The hand-written kernels on the card against their plain versions.

Marked ``cuda``: they need an NVIDIA GPU with nvcc and skip elsewhere (the
decision is taken inside the fixture, never at import).  Run them on the
card with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerances are those of ``tests/test_kernels.py``.
"""
import pytest
import torch

from repro_torch.kernels.decode_attn.ops import decode_attention
from repro_torch.kernels.decode_attn.ref import decode_ref
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.kernels.flash_attn.ref import attention_ref
from repro_torch.kernels.lora_fused.ops import lora_matmul
from repro_torch.kernels.lora_fused.ref import lora_ref

pytestmark = pytest.mark.cuda

TOL = {"lora": {torch.float32: 1e-4, torch.bfloat16: 3e-2},
       "flash": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
       "decode": {torch.float32: 2e-5, torch.bfloat16: 3e-2}}


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
                                     (77, 130, 200, 16)])
def test_lora_fused_kernel(gen, dtype, m, k, n, r):
    x, w = _rn(gen, m, k, dtype=dtype), _rn(gen, k, n, std=0.05, dtype=dtype)
    a, b = _rn(gen, k, r, std=0.05, dtype=dtype), _rn(gen, r, n, std=0.05, dtype=dtype)
    before = lora_matmul.launches
    out = lora_matmul(x, w, a, b, scale=2.0)
    torch.cuda.synchronize()
    assert lora_matmul.launches == before + 1
    _close(out, lora_ref(x, w, a, b, scale=2.0), TOL["lora"][dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,d,window", [(8, 128, 12, 12, 64, 0), (8, 77, 12, 12, 64, 0),
                                                (2, 256, 8, 4, 64, 96), (1, 33, 4, 1, 128, 0),
                                                (2, 200, 8, 2, 32, 0)])
def test_flash_attn_kernel(gen, dtype, b, s, h, kh, d, window):
    q = _rn(gen, b, s, h, d, dtype=dtype)
    k, v = _rn(gen, b, s, kh, d, dtype=dtype), _rn(gen, b, s, kh, d, dtype=dtype)
    out = flash_attention(q, k, v, causal=True, window=window)
    _close(out, attention_ref(q, k, v, causal=True, window=window), TOL["flash"][dtype])


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


def test_serving_on_card_matches_cpu(gen):
    """Reduced gpt2 serving on the card (kernels) vs the CPU (plain)."""
    from repro_torch import trees
    from repro_torch.launch import serve
    args = serve.parse_args(["--arch", "gpt2-small", "--reduced", "--batch", "2",
                             "--prompt-len", "9", "--gen", "4", "--lora-rank", "4"])
    model, params, lora, scale, prompts = serve.build(args)
    lora = trees.map_with_path(lambda p, t: t if p.endswith("/mask") else
                               _rn(gen, *t.shape, std=0.05), lora)
    res = serve.generate(model, params, prompts, 4, lora=lora, lora_scale=scale)
    from repro_torch.models.transformer import Model
    cpu = Model(model.cfg, device="cpu")
    p_cpu = trees.map_with_path(lambda _, t: t.cpu(), params)
    l_cpu = trees.map_with_path(lambda _, t: t.cpu(), lora)
    lg, cache = cpu.prefill(p_cpu, prompts.cpu(), 13, lora=l_cpu, lora_scale=scale)
    torch.testing.assert_close(lg, res["logits"][0].cpu(), atol=1e-4, rtol=0)
    for t in range(4):
        lg, cache = cpu.decode_step(p_cpu, cache, res["tokens"][:, t:t + 1].cpu(),
                                    lora=l_cpu, lora_scale=scale)
        torch.testing.assert_close(lg, res["logits"][t + 1].cpu(), atol=1e-4, rtol=0)
