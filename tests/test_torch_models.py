"""The port's model modules against the JAX package's, module by module, in
f32 on the CPU with numpy-seeded inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attn
from repro.models import mlp as j_mlp
from repro.models import norms as j_norms
from repro.models import peft as j_peft
from repro_torch.models import attention, mlp, norms, peft


def _rand(seed, *shapes, std=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * std).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_norms_match_jax(kind):
    x, scale, bias = _rand(0, (3, 5, 64), (64,), (64,))
    params = {"scale": scale, "bias": bias}
    want = j_norms.apply_norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
                              kind, 1e-5)
    got = norms.apply_norm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in params.items()},
                           kind, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_mlp_with_factors_matches_jax(act):
    x, wu, wd, wg, a, b = _rand(1, (2, 6, 32), (32, 48), (48, 32), (32, 48), (32, 4), (4, 48),
                                std=0.2)
    params = {"wu": wu, "wd": wd, "wg": wg}
    lora = {"wu": {"a": a, "b": b, "mask": np.ones((1, 1), np.float32)}}
    want = j_mlp.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}, act,
                     lora={"wu": {k: jnp.asarray(v) for k, v in lora["wu"].items()}}, scale=2.0)
    got = mlp.mlp(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in params.items()}, act,
                  lora={"wu": {k: torch.from_numpy(v) for k, v in lora["wu"].items()}}, scale=2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_lora_proj_and_adapter_match_jax():
    x, w, a, b, wd, wu = _rand(2, (4, 3, 32), (32, 24), (32, 8), (8, 24), (32, 16), (16, 32),
                               std=0.3)
    mask = np.zeros((1, 1), np.float32)   # a disabled layer: the factor path is masked out
    for m in (np.ones((1, 1), np.float32), mask):
        jl = {"a": jnp.asarray(a), "b": jnp.asarray(b), "mask": jnp.asarray(m)}
        tl = {"a": torch.from_numpy(a), "b": torch.from_numpy(b), "mask": torch.from_numpy(m)}
        want = j_peft.lora_proj(jnp.asarray(x), jnp.asarray(w), jl, scale=2.0, backend="pallas")
        got = peft.lora_proj(torch.from_numpy(x), torch.from_numpy(w), tl, scale=2.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    ap = {"wd": wd, "wu": wu}
    want = j_peft.adapter_fwd(jnp.asarray(x), {k: jnp.asarray(v) for k, v in ap.items()})
    got = peft.adapter_fwd(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in ap.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0), (False, 0, 0),
                                                    (True, 5, 0), (True, 0, 3)])
def test_dense_attention_and_mask_match_jax(causal, window, q_offset):
    q, k, v = _rand(3, (2, 7, 4, 16), (2, 10, 2, 16), (2, 10, 2, 16))
    np.testing.assert_array_equal(
        attention.make_mask(7, 10, causal=causal, window=window, q_offset=q_offset).numpy(),
        np.asarray(j_attn.make_mask(7, 10, causal=causal, window=window, q_offset=q_offset)))
    want = j_attn.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, window=window, q_offset=q_offset)
    got = attention.dense_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                    window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("cache_len,window", [(1, 0), (7, 0), (12, 0), (9, 4)])
def test_decode_attention_matches_jax(cache_len, window):
    q, kc, vc = _rand(4, (2, 1, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16))
    want = j_attn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                   cache_len, window=window)
    got = attention.decode_attention(*map(torch.from_numpy, (q, kc, vc)), cache_len,
                                     window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_decode_attention_unported_modes_raise():
    """Ring (window) caches are ported now (the sparse mask is covered by
    ``tests/test_torch_sparse.py``): a ring of Sc slots reads every slot
    below min(cache_len, Sc), as the JAX package's, before and after it
    wraps."""
    q, kc, vc = _rand(5, (2, 1, 4, 16), (2, 8, 2, 16), (2, 8, 2, 16))
    for cache_len in (3, 8, 13):
        want = j_attn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                       cache_len, window=8, ring=True)
        got = attention.decode_attention(*map(torch.from_numpy, (q, kc, vc)), cache_len,
                                         window=8, ring=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
