"""The port's block-sparse attention path (the paper's sparse-attention
device) against the JAX package's, in f32 on the CPU with numpy-seeded
inputs: the static block table, the plain block-sparse attention against
the JAX model function and the Pallas kernel (interpret mode), the sparse
decode mask, and reduced gpt2-small served with ``impl="sparse"``.
Tolerances: 2e-5 for attention (``tests/test_kernels.py``), 1e-4 for the
model's logits and caches (``test_mixer_factored.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import trees as jtrees
from repro.configs import get_config as jget_config
from repro.configs.base import SparseAttnConfig as JSparse
from repro.kernels.block_sparse_attn.ops import block_sparse_attention as j_bsa_kernel
from repro.models import Model as JModel
from repro.models import attention as j_attn
from repro.models import peft as jpeft
from repro_torch import bridge
from repro_torch.configs import SparseAttnConfig, get_config
from repro_torch.kernels.block_sparse_attn.ops import block_sparse_attention
from repro_torch.kernels.decode_attn.ops import decode_attention as decode_wrapper
from repro_torch.models import attention
from repro_torch.models.transformer import Model

PATTERNS = [dict(block_size=32, local_blocks=2, sink_blocks=1, stride=4),
            dict(block_size=64, local_blocks=1, sink_blocks=2, stride=2)]
ATOL = 1e-4
PROMPT, N_DECODE = 80, 4     # 5 blocks of 16 in the reduced pattern


def _rand(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("pattern", PATTERNS + [dict(block_size=16, local_blocks=2,
                                                     sink_blocks=1, stride=4)])
@pytest.mark.parametrize("nq,nk,offset", [(8, 8, 0), (7, 7, 0), (3, 12, 9), (20, 20, 0)])
def test_sparse_block_table_matches_jax(pattern, nq, nk, offset):
    idx, valid = attention.sparse_block_table(nq, nk, SparseAttnConfig(**pattern), offset)
    j_idx, j_valid = j_attn.sparse_block_table(nq, nk, JSparse(**pattern), offset)
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_array_equal(valid, j_valid)
    assert idx.dtype == np.int32 and valid.dtype == bool


@pytest.mark.parametrize("pattern", PATTERNS)
def test_block_sparse_matches_jax_function_and_pallas_kernel(pattern):
    q, k, v = _rand(1, (2, 256, 8, 64), (2, 256, 4, 64), (2, 256, 4, 64))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_model = np.asarray(j_attn.block_sparse_attention(jq, jk, jv, JSparse(**pattern)))
    want_kernel = np.asarray(j_bsa_kernel(jq, jk, jv, JSparse(**pattern)))
    cfg = SparseAttnConfig(**pattern)
    got = attention.block_sparse_attention(*map(torch.from_numpy, (q, k, v)), cfg).numpy()
    np.testing.assert_allclose(got, want_model, atol=2e-5)
    np.testing.assert_allclose(got, want_kernel, atol=2e-5)
    # the wrapper on CPU tensors is the plain version and launches nothing
    before = block_sparse_attention.launches
    wrapped = block_sparse_attention(*map(torch.from_numpy, (q, k, v)), cfg)
    np.testing.assert_array_equal(wrapped.numpy(), got)
    assert block_sparse_attention.launches == before


def test_block_sparse_q_offset_matches_jax():
    """Queries that start at block 4 of the keys (a chunk of a longer
    prompt), GQA 4:1."""
    q, k, v = _rand(2, (1, 64, 4, 32), (1, 128, 1, 32), (1, 128, 1, 32))
    pattern = dict(block_size=16, local_blocks=2, sink_blocks=1, stride=4)
    want = j_attn.block_sparse_attention(*map(jnp.asarray, (q, k, v)), JSparse(**pattern),
                                         q_offset=64)
    got = block_sparse_attention(*map(torch.from_numpy, (q, k, v)),
                                 SparseAttnConfig(**pattern), q_offset=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_block_sparse_rejects_ragged_lengths():
    cfg = SparseAttnConfig(block_size=16)
    q = torch.zeros(1, 40, 2, 32)
    with pytest.raises(ValueError, match="multiples of the block"):
        block_sparse_attention(q, q, q, cfg)
    q = torch.zeros(1, 32, 2, 32)
    with pytest.raises(ValueError, match="q_offset"):
        block_sparse_attention(q, q, q, cfg, q_offset=8)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("cache_len", [1, 33, 97, 130, 256])
def test_sparse_decode_mask_matches_jax(pattern, cache_len):
    q, kc, vc = _rand(3, (2, 1, 8, 32), (2, 256, 2, 32), (2, 256, 2, 32))
    want = j_attn.decode_attention(*map(jnp.asarray, (q, kc, vc)), cache_len,
                                   sparse=JSparse(**pattern))
    got = decode_wrapper(*map(torch.from_numpy, (q, kc, vc)), cache_len,
                         sparse=SparseAttnConfig(**pattern))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_sparse_position_mask_drops_inactive_blocks():
    """At cache_len 1024 with the serving pattern (block 128, local 4, sink
    1, stride 8) only blocks 0 and 4..7 are read."""
    cfg = SparseAttnConfig(block_size=128, local_blocks=4, sink_blocks=1, stride=8)
    mask = attention.sparse_position_mask(torch.arange(1024), 1024, cfg)
    blocks = sorted({int(p) // 128 for p in torch.nonzero(mask)[:, 0]})
    assert blocks == [0, 4, 5, 6, 7]


@pytest.fixture(scope="module")
def sparse_setup():
    jcfg = jget_config("gpt2-small").reduced(d_model=128, repeats=2)
    cfg = get_config("gpt2-small").reduced(d_model=128, repeats=2)
    jmodel = JModel(jcfg, impl="sparse", opts={"lora_backend": "pallas"})
    key = jax.random.PRNGKey(0)
    jparams = jmodel.init(key, max_seq=PROMPT + N_DECODE)
    pc = jpeft.PEFTConfig(lora_rank=4, lora_alpha=8.0)
    jlora0 = jpeft.init_lora(key, jparams, pc)
    rng = np.random.RandomState(1)   # nonzero B so the rank-r path does work
    flat_l = {k: (np.asarray(v) if k.endswith("/mask")
                  else (rng.randn(*v.shape) * 0.05).astype(np.float32))
              for k, v in jtrees.flatten(jlora0).items()}
    jlora = jtrees.map_with_path(lambda p, v: jnp.asarray(flat_l[p]), jlora0)
    flat_p = {k: np.asarray(v) for k, v in jtrees.flatten(jparams).items()}
    prompts = np.random.RandomState(2).randint(6, jcfg.vocab_size, size=(2, PROMPT))
    scale = jpeft.lora_scale(pc)
    jlg, jcache = jmodel.prefill(jparams, jnp.asarray(prompts), cache_len=PROMPT + N_DECODE,
                                 lora=jlora, lora_scale=scale)
    steps = [(jlg, jcache)]
    for _ in range(N_DECODE):
        tok = np.asarray(jnp.argmax(jlg, -1))[:, None].astype(np.int32)
        jlg, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok), lora=jlora,
                                         lora_scale=scale)
        steps.append((jlg, jcache))
    return dict(cfg=cfg, params=bridge.params_from_numpy(flat_p, cfg),
                lora=bridge.lora_from_numpy(flat_l, cfg), prompts=prompts, scale=scale,
                steps=[(np.asarray(lg), [{n: np.asarray(t) for n, t in e.items()}
                                         for e in c["stages"][0]]) for lg, c in steps])


def _check_step(lg, cache, want):
    jlg, jentries = want
    np.testing.assert_allclose(lg.numpy(), jlg, atol=ATOL)
    for e, je in zip(cache["stages"][0], jentries):
        for name in ("k", "v"):
            np.testing.assert_allclose(e[name].numpy(), je[name], atol=ATOL)


def test_sparse_serving_matches_jax(sparse_setup):
    """Reduced gpt2-small, impl="sparse": prefill through block-sparse
    attention and 4 decode steps under the sparse mask, logits and caches."""
    s = sparse_setup
    model = Model(s["cfg"], device="cpu", impl="sparse")
    lg, cache = model.prefill(s["params"], torch.from_numpy(s["prompts"]),
                              PROMPT + N_DECODE, lora=s["lora"], lora_scale=s["scale"])
    _check_step(lg, cache, s["steps"][0])
    for t in range(N_DECODE):
        tok = torch.from_numpy(s["steps"][t][0].argmax(-1)[:, None])
        lg, cache = model.decode_step(s["params"], cache, tok, lora=s["lora"],
                                      lora_scale=s["scale"])
        _check_step(lg, cache, s["steps"][t + 1])


def test_sparse_impl_differs_from_dense_and_per_call_override(sparse_setup):
    """The pattern really drops keys at this length (blocks 1 and 2 are not
    read by block 4), and ``impl=`` on a call overrides the model's."""
    s = sparse_setup
    toks = torch.from_numpy(s["prompts"])
    dense = Model(s["cfg"], device="cpu")
    lg_dense, _ = dense.prefill(s["params"], toks, PROMPT, lora=s["lora"],
                                lora_scale=s["scale"])
    lg_sparse, _ = dense.prefill(s["params"], toks, PROMPT, impl="sparse",
                                 lora=s["lora"], lora_scale=s["scale"])
    np.testing.assert_allclose(lg_sparse.numpy(), s["steps"][0][0], atol=ATOL)
    assert (lg_sparse - lg_dense).abs().max() > 1e-3
    with pytest.raises(ValueError, match="impl"):
        Model(s["cfg"], device="cpu", impl="ring")
    with pytest.raises(ValueError, match="multiples of the block"):
        dense.prefill(s["params"], toks[:, :70], PROMPT, impl="sparse")
