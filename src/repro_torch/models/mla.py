"""Multi-head Latent Attention (DeepSeek-V2): the port of
``repro.models.mla``.

Sequence mode (training, prefill) forms per-head k and v from the
compressed latent and runs the attention kernels: ``flash_attention``, or
under the block-sparse impl ``block_sparse_attention``.  q and k are nope +
rope wide and v is ``v_head_dim`` wide (192 and 128 at deepseek-v2's
published widths), with the scale (nope + rope)^-1/2; the kernels run
any such pair as ``kernels.flash_attn.ops.plan`` says: (80, 64) at the
reduced d-256 config in the (96, 64) tile, zero-filled inside the kernel;
(34, 18) at d 72 element by element; (288, 272) at d 1088 split over a
thread block cluster.

Decode uses the *absorbed* formulation: q is projected into the kv_lora
latent space and attention runs against the compressed cache (c_kv,
k_rope) — MLA's small KV cache — in f32 einsums and a softmax.  The JAX
package leaves this step to XLA (no Pallas kernel), and on the card it
stays plain torch: cuBLAS batched products over the heads and a softmax
(a hand-written MLA decode kernel is queued in ROADMAP queue 2).

Every projection runs ``peft.lora_proj`` with the factor side channel, so
``lora_fused`` runs wherever a weight carries factors.  The one exception
is absorbed decode: it contracts q and the context against ``wkv_b``
itself, so ``wkv_b``'s factors merge into that latent-space weight
(``peft.effective_weight``, kv_lora_rank × heads·(nope + v), never a
d_model² delta; ``dense_merge_count`` does not move).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.kernels.block_sparse_attn.ops import block_sparse_attention
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.models.attention import NEG_INF, sparse_position_mask
from repro_torch.models.norms import rmsnorm
from repro_torch.models.peft import effective_weight, lora_proj
from repro_torch.models.rope import rotate


def _lf(lora, key):
    """One leaf's factor dict from the mixer side channel (None-safe)."""
    return None if lora is None else lora.get(key)


def init_mla(normal, d_model: int, n_heads: int, cfg: MLAConfig, dtype, device,
             lead=()):
    """The JAX package's MLA leaves, ``lead`` (the repeat axis) first:
    ``normal(shape, std)`` draws a weight, the two norm scales are zeros."""
    qk = cfg.nope_head_dim + cfg.rope_head_dim
    zeros = lambda n: torch.zeros(*lead, n, dtype=dtype, device=device)  # noqa: E731
    return {
        "wq_a": normal((*lead, d_model, cfg.q_lora_rank), d_model ** -0.5),
        "q_norm": {"scale": zeros(cfg.q_lora_rank)},
        "wq_b": normal((*lead, cfg.q_lora_rank, n_heads * qk), cfg.q_lora_rank ** -0.5),
        "wkv_a": normal((*lead, d_model, cfg.kv_lora_rank + cfg.rope_head_dim),
                        d_model ** -0.5),
        "kv_norm": {"scale": zeros(cfg.kv_lora_rank)},
        "wkv_b": normal((*lead, cfg.kv_lora_rank,
                         n_heads * (cfg.nope_head_dim + cfg.v_head_dim)),
                        cfg.kv_lora_rank ** -0.5),
        "wo": normal((*lead, n_heads * cfg.v_head_dim, d_model),
                     (n_heads * cfg.v_head_dim) ** -0.5),
    }


def _project_q(x, p, cfg: MLAConfig, n_heads: int, rot, eps, lora=None,
               scale: float = 1.0):
    """→ q_nope (B, S, H, nope), q_pe (B, S, H, rope) rotated by ``rot``
    (the (cos, sin) table of the positions at the rope width)."""
    b, s, _ = x.shape
    cq = rmsnorm(lora_proj(x, p["wq_a"], _lf(lora, "wq_a"), scale=scale),
                 p["q_norm"]["scale"], eps)
    q = lora_proj(cq, p["wq_b"], _lf(lora, "wq_b"), scale=scale).reshape(
        b, s, n_heads, cfg.nope_head_dim + cfg.rope_head_dim)
    return q[..., :cfg.nope_head_dim], rotate(q[..., cfg.nope_head_dim:], *rot)


def _compress_kv(x, p, cfg: MLAConfig, rot, eps, lora=None, scale: float = 1.0):
    """→ c_kv (B, S, kv_lora_rank) normed, k_pe (B, S, rope) rotated."""
    kv_a = lora_proj(x, p["wkv_a"], _lf(lora, "wkv_a"), scale=scale)
    c_kv = rmsnorm(kv_a[..., :cfg.kv_lora_rank], p["kv_norm"]["scale"], eps)
    k_pe = rotate(kv_a[..., None, cfg.kv_lora_rank:], *rot)
    return c_kv, k_pe[..., 0, :]


def mla_seq(x, p, cfg: MLAConfig, n_heads: int, rot, eps: float, *,
            causal: bool = True, sparse=None, lora=None, scale: float = 1.0):
    """Full-sequence MLA (training, prefill) → (y, (c_kv, k_pe)).  ``sparse``
    (a ``SparseAttnConfig``): the block-sparse kernel (causal) instead of
    the flash kernel."""
    b, s, _ = x.shape
    nope, rope, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    q_nope, q_pe = _project_q(x, p, cfg, n_heads, rot, eps, lora=lora, scale=scale)
    c_kv, k_pe = _compress_kv(x, p, cfg, rot, eps, lora=lora, scale=scale)
    kv = lora_proj(c_kv, p["wkv_b"], _lf(lora, "wkv_b"), scale=scale).reshape(
        b, s, n_heads, nope + dv)
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([kv[..., :nope], k_pe[:, :, None].expand(b, s, n_heads, rope)], -1)
    v = kv[..., nope:].contiguous()
    att_scale = (nope + rope) ** -0.5
    if sparse is not None:
        y = block_sparse_attention(q, k, v, sparse, scale=att_scale)
    else:
        y = flash_attention(q, k, v, causal=causal, scale=att_scale)
    y = lora_proj(y.reshape(b, s, n_heads * dv), p["wo"], _lf(lora, "wo"), scale=scale)
    return y, (c_kv, k_pe)


def absorbed_attention(q_nope, q_pe, wkv_b, ckv_cache, kpe_cache, cache_len: int,
                       cfg: MLAConfig, *, sparse=None):
    """The absorbed step of MLA decode, in f32: q_nope (B, H, nope) folded
    into the latent space through ``wkv_b``'s k half (wkv_b (r, H, nope +
    v), factors already merged), logits against the latent cache plus the
    rope part, softmax over slots < ``cache_len`` (with ``sparse``, those of
    active blocks), the context folded back through the v half → (B, H, v).
    Plain torch on every device: batched products and a softmax."""
    nope, rope = cfg.nope_head_dim, cfg.rope_head_dim
    hi = min(cache_len, ckv_cache.shape[1])      # slots past it are masked anyway
    ckv = ckv_cache[:, :hi].float()
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope.float(), wkv_b[..., :nope])
    logits = (torch.einsum("bhr,btr->bht", q_abs, ckv)
              + torch.einsum("bhp,btp->bht", q_pe.float(),
                             kpe_cache[:, :hi].float())) * (nope + rope) ** -0.5
    if sparse is not None:
        slot = torch.arange(hi, device=ckv.device)
        logits = logits.masked_fill(~sparse_position_mask(slot, cache_len, sparse),
                                    NEG_INF)
    ctx = torch.einsum("bht,btr->bhr", torch.softmax(logits, dim=-1), ckv)
    return torch.einsum("bhr,rhv->bhv", ctx, wkv_b[..., nope:])


def mla_decode(x, p, cfg: MLAConfig, n_heads: int, rot, eps: float, ckv_cache,
               kpe_cache, cache_len: int, *, sparse=None, lora=None,
               scale: float = 1.0):
    """Absorbed-MLA decode of the token at position ``cache_len`` − 1 (host
    int), whose (c_kv, k_pe) the caller has written.  x: (B, 1, d); caches
    (B, Sc, kv_lora_rank) / (B, Sc, rope).  Slots ≤ the position are read
    (with ``sparse``, those of the pattern's active blocks) by
    ``absorbed_attention``; q/o projections stay factored, ``wkv_b``'s
    factors merge into the latent weight (module docstring)."""
    b = x.shape[0]
    q_nope, q_pe = _project_q(x, p, cfg, n_heads, rot, eps, lora=lora, scale=scale)
    wkv_b = effective_weight(p["wkv_b"], _lf(lora, "wkv_b"), scale).reshape(
        cfg.kv_lora_rank, n_heads, cfg.nope_head_dim + cfg.v_head_dim).float()
    v_out = absorbed_attention(q_nope[:, 0], q_pe[:, 0], wkv_b, ckv_cache, kpe_cache,
                               cache_len, cfg, sparse=sparse)
    return lora_proj(v_out.reshape(b, 1, n_heads * cfg.v_head_dim).to(x.dtype), p["wo"],
                     _lf(lora, "wo"), scale=scale)
