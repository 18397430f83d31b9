"""Layer application: full-sequence forward and single-token decode.

A layer is (mixer, ff) with pre-norm residual structure:

    x = x + mixer(norm1(x))
    x = x + ff(norm2(x))

This slice ports the ``attn`` mixer with the ``mlp`` ff (the dense decoder
of gpt2).  Prefill attention runs the hand-written flash kernel and decode
attention the flash-decode kernel; projections with LoRA factors run the
fused LoRA kernel (``peft.lora_proj``).
"""
from __future__ import annotations

from repro_torch.configs.base import LayerKind, ModelConfig
from repro_torch.kernels.decode_attn.ops import decode_attention
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.models.mlp import mlp
from repro_torch.models.norms import apply_norm
from repro_torch.models.peft import adapter_fwd, lora_proj

_LATER = {
    "enc": "the PFTT training slice (roberta encoder)",
    "local": "the arch-zoo slice",
    "dec": "the arch-zoo slice (whisper)",
    "mla": "the arch-zoo slice (deepseek MLA)",
    "mamba": "the arch-zoo slice (mamba/jamba)",
    "moe": "the arch-zoo slice (MoE)",
}


def check_kind(kind: LayerKind) -> None:
    """Raise for layer kinds this slice has not ported yet."""
    for part in (kind.mixer, kind.ff):
        if part in _LATER:
            raise NotImplementedError(
                f"layer kind {kind.tag}: '{part}' is ported with {_LATER[part]}")
    if kind.mixer != "attn" or kind.ff not in ("mlp", "none"):
        raise NotImplementedError(f"layer kind {kind.tag} is not ported")


def _sub(lora, *keys):
    """Navigate a LoRA side-channel subtree; None anywhere → None."""
    for k in keys:
        if lora is None:
            return None
        lora = lora.get(k)
    return lora


def _qkv(xn, mp, cfg: ModelConfig, mf, scale: float):
    b, s, _ = xn.shape
    h, k_, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = lora_proj(xn, mp["wq"], _sub(mf, "wq"), scale=scale).reshape(b, s, h, hd)
    k = lora_proj(xn, mp["wk"], _sub(mf, "wk"), scale=scale).reshape(b, s, k_, hd)
    v = lora_proj(xn, mp["wv"], _sub(mf, "wv"), scale=scale).reshape(b, s, k_, hd)
    return q, k, v


def _ff_and_adapter(x, lp, kind: LayerKind, cfg: ModelConfig, lora, scale):
    if kind.ff == "mlp":
        xn2 = apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps)
        x = x + mlp(xn2, lp["ff"], cfg.act, lora=_sub(lora, "ff"), scale=scale)
    if "adapter" in lp:  # PFTT universal adapter (bottleneck + residual)
        x = adapter_fwd(x, lp["adapter"])
    return x


def apply_layer_seq(x, lp, kind: LayerKind, cfg: ModelConfig, *, lora=None,
                    lora_scale: float = 1.0):
    """x: (B, S, d) → (x, {"k", "v"}): the layer output and the prompt's
    keys and values to seed a decode cache.  ``lp``/``lora`` are one layer's
    (unstacked) params and factor subtree."""
    check_kind(kind)
    xn = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
    mf = _sub(lora, "mixer")
    q, k, v = _qkv(xn, lp["mixer"], cfg, mf, lora_scale)
    y = flash_attention(q, k, v, causal=True, window=0)
    b, s = y.shape[:2]
    x = x + lora_proj(y.reshape(b, s, -1), lp["mixer"]["wo"], _sub(mf, "wo"),
                      scale=lora_scale)
    x = _ff_and_adapter(x, lp, kind, cfg, lora, lora_scale)
    return x, {"k": k, "v": v}


def apply_layer_decode(x, lp, kind: LayerKind, cache, pos: int,
                       cfg: ModelConfig, *, lora=None, lora_scale: float = 1.0):
    """x: (B, 1, d), the token at position ``pos`` (host int).  Writes its
    k/v into ``cache`` IN PLACE at slot min(pos, Sc-1) — the port updates
    the cache buffers instead of returning new ones — and returns x."""
    check_kind(kind)
    xn = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
    mf = _sub(lora, "mixer")
    q, k, v = _qkv(xn, lp["mixer"], cfg, mf, lora_scale)
    kc, vc = cache["k"], cache["v"]
    slot = min(pos, kc.shape[1] - 1)
    kc[:, slot] = k[:, 0]
    vc[:, slot] = v[:, 0]
    y = decode_attention(q, kc, vc, pos + 1)
    x = x + lora_proj(y.reshape(x.shape[0], 1, -1), lp["mixer"]["wo"],
                      _sub(mf, "wo"), scale=lora_scale)
    return _ff_and_adapter(x, lp, kind, cfg, lora, lora_scale)


def layer_cache_shape(cfg: ModelConfig, kind: LayerKind, batch: int,
                      cache_len: int):
    """Cache entry shapes of one layer (no leading repeat axis)."""
    check_kind(kind)
    shp = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
    return {"k": shp, "v": shp}
