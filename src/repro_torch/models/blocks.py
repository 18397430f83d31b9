"""Layer application: full-sequence forward and single-token decode.

A layer is (mixer, ff) with pre-norm residual structure:

    x = x + mixer(norm1(x))
    x = x + ff(norm2(x))            [if ff != none]

This port has the ``attn`` mixer (dense GQA decoders: gpt2, the llamas,
gemma3's global layers, internvl2, dbrx, jamba's attention layers), the
``local`` mixer (gemma3's sliding-window layers), the ``enc`` mixer (the
RoBERTa encoder: the same projections, non-causal, no cache) and the
``mamba`` mixer (Mamba-2), with the ``mlp`` or ``moe`` ff or none, and
PFTT's universal adapter after the ff where the layer has one.  Rotary
configs rotate q and k inside ``_qkv`` (the cache holds the rotated k).
Prefill and encoder attention run the hand-written flash kernel (with the
config's window on a ``local`` layer), or (``attn`` layers) under
``impl="sparse"`` with a ``cfg.sparse_attn`` pattern the block-sparse
kernel; decode attention runs the flash-decode kernel, with the sparse
position mask under ``impl="sparse"``.  A ``local`` layer's decode cache is
a ring of min(cache_len, window) slots: the token at position p goes to
slot p mod Sc, and every slot below min(p + 1, Sc) is read — all of them
lie in the window, and softmax does not depend on slot order, so the
decode kernel reads the ring as a plain cache of that length.  The mamba
mixer's scan runs the SSD chunk kernel.  Projections with LoRA factors run
the fused LoRA kernel (``peft.lora_proj``); an MoE layer merges any ff
factors into its experts first (``peft.merge_factors``), as the JAX
package does.  The ``mla`` and ``dec`` mixers are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LayerKind, ModelConfig
from repro_torch.kernels.block_sparse_attn.ops import block_sparse_attention
from repro_torch.kernels.decode_attn.ops import decode_attention
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.models import ssm
from repro_torch.models.mlp import mlp
from repro_torch.models.moe import moe_ffn
from repro_torch.models.norms import apply_norm
from repro_torch.models.peft import adapter_fwd, lora_proj, merge_factors
from repro_torch.models.rope import rotate

IMPLS = ("auto", "dense", "chunked", "sparse")
_LATER = {
    "dec": "the arch zoo's fourteenth slice (whisper's cross-attention decoder)",
    "mla": "the arch zoo's fourteenth slice (deepseek-v2's MLA with absorbed decode)",
}


def check_kind(kind: LayerKind) -> None:
    """Raise for layer kinds the port has not ported yet."""
    for part in (kind.mixer, kind.ff):
        if part in _LATER:
            raise NotImplementedError(
                f"layer kind {kind.tag}: '{part}' is ported with {_LATER[part]}")
    if kind.mixer not in ("attn", "local", "enc", "mamba"):
        raise NotImplementedError(f"layer kind {kind.tag} is not ported")


def _sparse(cfg: ModelConfig, impl: str):
    """The block-sparse pattern the attention layers use, or None (every
    other ``impl`` computes exact attention)."""
    return cfg.sparse_attn if impl == "sparse" else None


def _sub(lora, *keys):
    """Navigate a LoRA side-channel subtree; None anywhere → None."""
    for k in keys:
        if lora is None:
            return None
        lora = lora.get(k)
    return lora


def _qkv(xn, mp, cfg: ModelConfig, mf, scale: float, rot):
    """q (B,S,H,hd), k/v (B,S,K,hd); ``rot``, the (cos, sin) table of the
    step's positions (``rope.rope_cos_sin``), rotates q and k (None: no
    rotary positions)."""
    b, s, _ = xn.shape
    h, k_, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = lora_proj(xn, mp["wq"], _sub(mf, "wq"), scale=scale).reshape(b, s, h, hd)
    k = lora_proj(xn, mp["wk"], _sub(mf, "wk"), scale=scale).reshape(b, s, k_, hd)
    v = lora_proj(xn, mp["wv"], _sub(mf, "wv"), scale=scale).reshape(b, s, k_, hd)
    if rot is not None:
        q, k = rotate(q, *rot), rotate(k, *rot)
    return q, k, v


def _ff_and_adapter(x, lp, kind: LayerKind, cfg: ModelConfig, lora, scale):
    """The ff sublayer and the adapter → (x, MoE balance loss or None)."""
    aux = None
    if kind.ff != "none":
        xn2 = apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps)
        if kind.ff == "mlp":
            x = x + mlp(xn2, lp["ff"], cfg.act, lora=_sub(lora, "ff"), scale=scale)
        else:
            y, aux = moe_ffn(xn2, merge_factors(lp["ff"], _sub(lora, "ff"), scale),
                             cfg.moe, cfg.act)
            x = x + y
    if "adapter" in lp:  # PFTT universal adapter (bottleneck + residual)
        x = adapter_fwd(x, lp["adapter"])
    return x, aux


def apply_layer_seq(x, lp, kind: LayerKind, cfg: ModelConfig, rot=None, *,
                    impl: str = "auto", lora=None, lora_scale: float = 1.0):
    """x: (B, S, d) → (x, cache entry, aux), ``rot`` the rotary (cos, sin)
    table of its positions or None: the layer output, the state that seeds
    a decode cache — the prompt's
    {"k", "v"} for attention, the final SSM state and conv inputs
    {"h", "conv"} for mamba, None for an encoder layer — and an MoE layer's
    balance loss (None for any other ff).  ``lp``/``lora`` are one layer's
    (unstacked) params and factor subtree."""
    check_kind(kind)
    xn = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
    mf = _sub(lora, "mixer")
    if kind.mixer == "mamba":
        y, (h, conv) = ssm.mamba_seq(xn, lp["mixer"], cfg.ssm, cfg.d_model,
                                     cfg.norm_eps, lora=mf, scale=lora_scale)
        x = x + y
        entry = {"h": h, "conv": conv}
    else:
        q, k, v = _qkv(xn, lp["mixer"], cfg, mf, lora_scale, rot)
        sparse = _sparse(cfg, impl) if kind.mixer == "attn" else None
        if sparse is not None:
            y = block_sparse_attention(q, k, v, sparse)
        else:
            y = flash_attention(q, k, v, causal=kind.mixer != "enc",
                                window=cfg.window if kind.mixer == "local" else 0)
        b, s = y.shape[:2]
        x = x + lora_proj(y.reshape(b, s, -1), lp["mixer"]["wo"], _sub(mf, "wo"),
                          scale=lora_scale)
        entry = None if kind.mixer == "enc" else {"k": k, "v": v}
    x, aux = _ff_and_adapter(x, lp, kind, cfg, lora, lora_scale)
    return x, entry, aux


def apply_layer_decode(x, lp, kind: LayerKind, cache, pos: int,
                       cfg: ModelConfig, rot=None, *, impl: str = "auto", lora=None,
                       lora_scale: float = 1.0):
    """x: (B, 1, d), the token at position ``pos`` (host int), ``rot`` the
    rotary (cos, sin) table of that position or None.  Updates this
    layer's ``cache`` entry IN PLACE — attention writes the token's k/v at
    slot min(pos, Sc-1) (a ``local`` ring at pos mod Sc), mamba overwrites
    its state and conv inputs — where the JAX package returns new buffers,
    and returns x."""
    check_kind(kind)
    xn = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
    mf = _sub(lora, "mixer")
    if kind.mixer == "mamba":
        y, (h, conv) = ssm.mamba_decode(xn, lp["mixer"], cfg.ssm, cfg.d_model,
                                        cfg.norm_eps, cache["h"], cache["conv"],
                                        lora=mf, scale=lora_scale)
        cache["h"].copy_(h)
        cache["conv"].copy_(conv)
        x = x + y
    else:
        q, k, v = _qkv(xn, lp["mixer"], cfg, mf, lora_scale, rot)
        kc, vc = cache["k"], cache["v"]
        sc = kc.shape[1]
        if kind.mixer == "local":       # ring: every slot read lies in the window
            slot, cache_len, sparse = pos % sc, min(pos + 1, sc), None
        else:
            slot, cache_len, sparse = min(pos, sc - 1), pos + 1, _sparse(cfg, impl)
        kc[:, slot] = k[:, 0]
        vc[:, slot] = v[:, 0]
        y = decode_attention(q, kc, vc, cache_len, sparse=sparse)
        x = x + lora_proj(y.reshape(x.shape[0], 1, -1), lp["mixer"]["wo"],
                          _sub(mf, "wo"), scale=lora_scale)
    return _ff_and_adapter(x, lp, kind, cfg, lora, lora_scale)[0]


def layer_cache_shape(cfg: ModelConfig, kind: LayerKind, batch: int,
                      cache_len: int, dtype):
    """Cache entry of one layer as {name: (shape, dtype)} (no leading repeat
    axis).  The SSM state is f32 whatever the model dtype; a ``local``
    layer's ring holds min(cache_len, window) positions."""
    check_kind(kind)
    if kind.mixer == "mamba":
        s = cfg.ssm
        conv_dim = cfg.d_inner + 2 * s.n_groups * s.state
        return {"h": ((batch, cfg.ssm_heads, s.headdim, s.state), torch.float32),
                "conv": ((batch, s.conv_width - 1, conv_dim), dtype)}
    if kind.mixer == "local" and cfg.window:
        cache_len = min(cache_len, cfg.window)
    shp = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
    return {"k": (shp, dtype), "v": (shp, dtype)}
