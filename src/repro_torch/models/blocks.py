"""Layer application: full-sequence forward and single-token decode.

A layer is (mixer, ff) with pre-norm residual structure:

    x = x + mixer(norm1(x))          [dec adds a cross-attention sublayer]
    x = x + ff(norm2(x))             [if ff != none]

The port has every mixer of the JAX package: ``attn`` (dense GQA decoders:
gpt2, the llamas, gemma3's global layers, internvl2, dbrx, jamba's
attention layers), ``local`` (gemma3's sliding-window layers), ``enc`` (the
RoBERTa and whisper encoders: the same projections, non-causal, no cache),
``dec`` (whisper's decoder: causal self-attention, then cross-attention of
the decoder stream on the encoder's memory), ``mla`` (deepseek-v2's
multi-head latent attention, ``models/mla.py``), ``mamba`` (Mamba-2) and
``none`` (no mixer: the layer is its ff, its cache entry empty), with the
``mlp`` or ``moe`` ff or none, and PFTT's universal adapter after
the ff where the layer has one.  Rotary configs rotate q and k inside
``_qkv`` (the cache holds the rotated k; MLA rotates its rope part).
Prefill and encoder attention run the hand-written flash kernel (with the
config's window on a ``local`` layer; non-causal with Sq ≠ Sk for the
cross-attention), or (``attn``, ``dec`` and ``mla`` layers) under
``impl="sparse"`` with a ``cfg.sparse_attn`` pattern the block-sparse
kernel; decode attention runs the flash-decode kernel, with the sparse
position mask under ``impl="sparse"`` (also for the ``sparse_gather_decode``
option, which reads the same positions).  A ``local`` layer's decode cache
is a ring of min(cache_len, window) slots: the token at position p goes to
slot p mod Sc, and every slot below min(p + 1, Sc) is read — all of them lie
in the window, and softmax does not depend on slot order, so the decode
kernel reads the ring as a plain cache of that length.  An ``attn`` layer's
sparse-KV cache (the ``sparse_kv_seq`` option: a persistent region and a
ring, ``models.attention.sparse_kv_layout``) is read by up to three
flash-decode launches merged by their log-sum-exp.  MLA's absorbed decode
stays plain torch (``models/mla.py``).  The mamba mixer's scan runs the SSD
chunk kernel.  Projections with LoRA factors run the fused LoRA kernel
(``peft.lora_proj``); an MoE layer merges any ff factors into its experts
first (``peft.merge_factors``), as the JAX package does.

Under a (data, model) mesh both functions take ``tp``, the layer's plan
(``models.parallel.LayerTP``): ``lp`` and ``lora`` arrive in its layout,
attention and the MLP run on this rank's heads and columns, MoE on its
experts (``moe_a2a``: the all-to-all variant), mamba's ``mamba_sp`` option
on this rank's sequence block in training; a decode step writes the token
on the rank that owns its slot and merges the ranks' segments
(``parallel.decode_segment``), and a cache it has no plan for (mamba, MLA,
the sparse-KV layout) is gathered whole, stepped, and cut back.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LayerKind, ModelConfig
from repro_torch.kernels.block_sparse_attn.ops import block_sparse_attention
from repro_torch.kernels.decode_attn.ops import decode_attention, sparse_kv_attention
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.models import mla, ssm
from repro_torch.models.attention import sparse_kv_layout, sparse_kv_write
from repro_torch.models.mlp import mlp
from repro_torch.models.moe import moe_ffn, moe_ffn_a2a
from repro_torch.models.norms import apply_norm
from repro_torch.models.parallel import ATTN_TP, decode_segment, segment_write
from repro_torch.models.peft import adapter_fwd, has_factors, lora_proj, merge_factors
from repro_torch.models.rope import rotate
from repro_torch.sharding import (Spec, all_reduce, copy_to, gather, reduce_from,
                                  shard_leaf, unshard_leaf)

IMPLS = ("auto", "dense", "chunked", "sparse")
def rope_width(cfg: ModelConfig) -> int:
    """The width the rotary table of a step is made for: MLA's rope part,
    else the head."""
    return cfg.mla.rope_head_dim if cfg.mla is not None else cfg.hd


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


def _heads(cfg: ModelConfig, tp):
    """(query heads, kv heads) this rank computes."""
    m = 1 if tp is None or not tp.attn else tp.mc.model_size
    return cfg.n_heads // m, cfg.n_kv_heads // m


def _qkv(xn, mp, cfg: ModelConfig, mf, scale: float, rot, heads=None):
    """q (B,S,H,hd), k/v (B,S,K,hd); ``rot``, the (cos, sin) table of the
    step's positions (``rope.rope_cos_sin``), rotates q and k (None: no
    rotary positions); ``heads``: (H, K) this rank computes."""
    b, s, _ = xn.shape
    (h, k_), hd = heads or (cfg.n_heads, cfg.n_kv_heads), cfg.hd
    q = lora_proj(xn, mp["wq"], _sub(mf, "wq"), scale=scale).reshape(b, s, h, hd)
    k = lora_proj(xn, mp["wk"], _sub(mf, "wk"), scale=scale).reshape(b, s, k_, hd)
    v = lora_proj(xn, mp["wv"], _sub(mf, "wv"), scale=scale).reshape(b, s, k_, hd)
    if rot is not None:
        q, k = rotate(q, *rot), rotate(k, *rot)
    return q, k, v


def _ff_and_adapter(x, lp, kind: LayerKind, cfg: ModelConfig, lora, scale, tp=None):
    """The ff sublayer and the adapter → (x, MoE balance loss or None)."""
    aux = None
    if kind.ff != "none":
        xn2 = apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps)
        if kind.ff == "mlp":
            x = x + mlp(xn2, lp["ff"], cfg.act, lora=_sub(lora, "ff"), scale=scale,
                        mc=tp.mc if tp is not None and tp.mlp else None)
        else:
            ffn = moe_ffn_a2a if tp is not None and tp.moe_a2a else moe_ffn
            y, aux = ffn(xn2, merge_factors(lp["ff"], _sub(lora, "ff"), scale),
                         cfg.moe, cfg.act, tp=tp)
            x = x + y
    if "adapter" in lp:  # PFTT universal adapter (bottleneck + residual)
        x = adapter_fwd(x, lp["adapter"])
    return x, aux


def apply_layer_seq(x, lp, kind: LayerKind, cfg: ModelConfig, rot=None, *,
                    impl: str = "auto", lora=None, lora_scale: float = 1.0,
                    memory=None, tp=None, collect: bool = False):
    """x: (B, S, d) → (x, cache entry, aux), ``rot`` the rotary (cos, sin)
    table of its positions or None, ``memory`` (B, S_enc, d) the encoder's
    output for a ``dec`` layer: the layer output, the state that seeds a
    decode cache — the prompt's {"k", "v"} for attention (a ``dec`` layer
    adds the memory's cross {"xk", "xv"}), {"ckv", "kpe"} for MLA, the
    final SSM state and conv inputs {"h", "conv"} for mamba, None for an
    encoder layer — and an MoE layer's balance loss (None for any other
    ff).  ``lp``/``lora`` are one layer's (unstacked) params and factor
    subtree.  ``tp``: the layer's plan under a mesh (``collect``: the
    cache entry gets every head, for a prefill)."""
    if kind.mixer == "none":            # no mixer: the layer is its ff
        x, aux = _ff_and_adapter(x, lp, kind, cfg, lora, lora_scale, tp)
        return x, {}, aux
    xn = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
    mf = _sub(lora, "mixer")
    if kind.mixer == "mamba" and tp is not None and tp.mamba_sp and tp.train \
            and not has_factors(mf):
        # sequence-parallel SSD (its body takes raw weights, as the JAX
        # package's: a layer with factors takes the plain mixer below)
        x = x + ssm.mamba_seq_sp(xn, lp["mixer"], cfg.ssm, cfg.d_model, cfg.norm_eps,
                                 tp.mc)
        entry = None
    elif kind.mixer == "mamba":
        y, (h, conv) = ssm.mamba_seq(xn, lp["mixer"], cfg.ssm, cfg.d_model,
                                     cfg.norm_eps, lora=mf, scale=lora_scale)
        x = x + y
        entry = {"h": h, "conv": conv}
    elif kind.mixer == "mla":
        y, (ckv, kpe) = mla.mla_seq(xn, lp["mixer"], cfg.mla, cfg.n_heads, rot,
                                    cfg.norm_eps, sparse=_sparse(cfg, impl), lora=mf,
                                    scale=lora_scale)
        x = x + y
        entry = {"ckv": ckv, "kpe": kpe}
    else:
        par = tp is not None and tp.attn
        xin = copy_to(xn, tp.mc, tp.model) if par else xn
        q, k, v = _qkv(xin, lp["mixer"], cfg, mf, lora_scale, rot, _heads(cfg, tp))
        sparse = _sparse(cfg, impl) if kind.mixer in ("attn", "dec") else None
        if sparse is not None:
            y = block_sparse_attention(q, k, v, sparse)
        else:
            y = flash_attention(q, k, v, causal=kind.mixer != "enc",
                                window=cfg.window if kind.mixer == "local" else 0)
        b, s = y.shape[:2]
        o = lora_proj(y.reshape(b, s, -1), lp["mixer"]["wo"], _sub(mf, "wo"),
                      scale=lora_scale)
        x = x + (reduce_from(o, tp.mc, tp.model) if par else o)
        if par and collect:                 # a prefill's cache holds every head
            k, v = (gather(t, tp.mc, tp.model, 2, sum_grad=False) for t in (k, v))
        entry = None if kind.mixer == "enc" else {"k": k, "v": v}
        if kind.mixer == "dec":
            x, entry["xk"], entry["xv"] = _cross_seq(x, lp, cfg, memory,
                                                     _sub(lora, "cross"), lora_scale)
    x, aux = _ff_and_adapter(x, lp, kind, cfg, lora, lora_scale, tp)
    return x, entry, aux


def _cross_seq(x, lp, cfg: ModelConfig, memory, cf, scale):
    """A ``dec`` layer's cross-attention sublayer over the whole stream:
    ``norm_x``, q from x, k/v from the encoder's memory, non-causal
    attention (Sq ≠ Sk) → (x, xk, xv)."""
    b, s, _ = x.shape
    cp = lp["cross"]
    xn = apply_norm(x, lp["norm_x"], cfg.norm, cfg.norm_eps)
    qx = lora_proj(xn, cp["wq"], _sub(cf, "wq"), scale=scale).reshape(
        b, s, cfg.n_heads, cfg.hd)
    shp = (memory.shape[0], memory.shape[1], cfg.n_kv_heads, cfg.hd)
    kx = lora_proj(memory, cp["wk"], _sub(cf, "wk"), scale=scale).reshape(shp)
    vx = lora_proj(memory, cp["wv"], _sub(cf, "wv"), scale=scale).reshape(shp)
    yx = flash_attention(qx, kx, vx, causal=False)
    x = x + lora_proj(yx.reshape(b, s, -1), cp["wo"], _sub(cf, "wo"), scale=scale)
    return x, kx, vx


def apply_layer_decode(x, lp, kind: LayerKind, cache, pos: int,
                       cfg: ModelConfig, rot=None, *, impl: str = "auto", lora=None,
                       lora_scale: float = 1.0, opts=None, tp=None):
    """x: (B, 1, d), the token at position ``pos`` (host int), ``rot`` the
    rotary (cos, sin) table of that position or None, ``opts`` the model's
    options.  Updates this layer's ``cache`` entry IN PLACE — attention
    writes the token's k/v at slot min(pos, Sc-1) (a ``local`` ring at pos
    mod Sc; a sparse-KV cache at its persistent slot and ring slot), MLA
    its (c_kv, k_pe) at min(pos, Sc-1), mamba overwrites its state and conv
    inputs — where the JAX package returns new buffers, and returns x.
    ``tp``: the layer's plan under a mesh, with its cache entry's specs."""
    if kind.mixer == "none":
        return _ff_and_adapter(x, lp, kind, cfg, lora, lora_scale, tp)[0]
    if tp is not None:
        x = _mixer_decode_tp(x, lp, kind, cache, pos, cfg, rot, impl=impl, lora=lora,
                             lora_scale=lora_scale, opts=opts, tp=tp)
        return _ff_and_adapter(x, lp, kind, cfg, lora, lora_scale, tp)[0]
    x = _mixer_decode(x, lp, kind, cache, pos, cfg, rot, impl=impl, lora=lora,
                      lora_scale=lora_scale, opts=opts)
    return _ff_and_adapter(x, lp, kind, cfg, lora, lora_scale)[0]


def _mixer_decode(x, lp, kind: LayerKind, cache, pos: int, cfg: ModelConfig, rot, *,
                  impl, lora, lora_scale, opts):
    """The mixer sublayer of ``apply_layer_decode`` → x."""
    opts = opts or {}
    xn = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
    mf = _sub(lora, "mixer")
    b = x.shape[0]
    if kind.mixer == "mamba":
        y, (h, conv) = ssm.mamba_decode(xn, lp["mixer"], cfg.ssm, cfg.d_model,
                                        cfg.norm_eps, cache["h"], cache["conv"],
                                        lora=mf, scale=lora_scale)
        cache["h"].copy_(h)
        cache["conv"].copy_(conv)
        x = x + y
    elif kind.mixer == "mla":
        c_kv, k_pe = mla._compress_kv(xn, lp["mixer"], cfg.mla, rot, cfg.norm_eps,
                                      lora=mf, scale=lora_scale)
        slot = min(pos, cache["ckv"].shape[1] - 1)
        cache["ckv"][:, slot] = c_kv[:, 0]
        cache["kpe"][:, slot] = k_pe[:, 0]
        x = x + mla.mla_decode(xn, lp["mixer"], cfg.mla, cfg.n_heads, rot, cfg.norm_eps,
                               cache["ckv"], cache["kpe"], pos + 1,
                               sparse=_sparse(cfg, impl), lora=mf, scale=lora_scale)
    else:
        q, k, v = _qkv(xn, lp["mixer"], cfg, mf, lora_scale, rot)
        if "k_pers" in cache:           # sparse-KV cache (attn layers)
            seq = opts["sparse_kv_seq"]
            sparse_kv_write(cache, k, v, pos, cfg.sparse_attn, seq)
            y = sparse_kv_attention(q, cache, pos, cfg.sparse_attn, seq)
        else:
            kc, vc = cache["k"], cache["v"]
            sc = kc.shape[1]
            if kind.mixer == "local":   # ring: every slot read lies in the window
                slot, cache_len, sparse = pos % sc, min(pos + 1, sc), None
            else:
                slot, cache_len, sparse = min(pos, sc - 1), pos + 1, _sparse(cfg, impl)
            kc[:, slot] = k[:, 0]
            vc[:, slot] = v[:, 0]
            y = decode_attention(q, kc, vc, cache_len, sparse=sparse)
        x = x + lora_proj(y.reshape(b, 1, -1), lp["mixer"]["wo"], _sub(mf, "wo"),
                          scale=lora_scale)
        if kind.mixer == "dec":
            cf, cp = _sub(lora, "cross"), lp["cross"]
            xn2 = apply_norm(x, lp["norm_x"], cfg.norm, cfg.norm_eps)
            qx = lora_proj(xn2, cp["wq"], _sub(cf, "wq"), scale=lora_scale).reshape(
                b, 1, cfg.n_heads, cfg.hd)
            yx = decode_attention(qx, cache["xk"], cache["xv"], cache["xk"].shape[1])
            x = x + lora_proj(yx.reshape(b, 1, -1), cp["wo"], _sub(cf, "wo"),
                              scale=lora_scale)
    return x


def _mixer_decode_tp(x, lp, kind: LayerKind, cache, pos: int, cfg: ModelConfig, rot, *,
                     impl, lora, lora_scale, opts, tp):
    """The mixer of a decode step under a mesh.  Attention with a plain
    cache: q and the new k/v get every head (gathered over the model axis
    when the plan splits heads), the token is written on the rank owning
    its slot, each rank reads its sequence segment for every head and the
    segments merge by their log-sum-exp; the rank keeps its heads for the
    row-parallel ``wo``.  Any other cache is gathered whole (the batch
    dimension stays this rank's rows), stepped by the single-device code
    with the whole weights, and cut back."""
    mc, specs = tp.mc, tp.cache_specs
    if not (kind.mixer in ATTN_TP and "k" in cache):
        nob = {n: Spec(*((None,) + tuple(sp)[1:])) for n, sp in specs.items()}
        whole = {n: unshard_leaf(t, nob[n], mc) for n, t in cache.items()}
        x = _mixer_decode(x, lp, kind, whole, pos, cfg, rot, impl=impl, lora=lora,
                          lora_scale=lora_scale, opts=opts)
        for n, t in cache.items():
            t.copy_(shard_leaf(whole[n], nob[n], mc))
        return x
    xn = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
    mf = _sub(lora, "mixer")
    b = x.shape[0]
    q, k, v = _qkv(xn, lp["mixer"], cfg, mf, lora_scale, rot, _heads(cfg, tp))
    if tp.attn:
        q, k, v = (gather(t, mc, tp.model, 2, sum_grad=False) for t in (q, k, v))
    kc, vc = cache["k"], cache["v"]
    seq = specs["k"][1]
    sc = kc.shape[1] * mc.extent(seq)
    if kind.mixer == "local":           # ring: every slot read lies in the window
        slot, n_read, sparse = pos % sc, min(pos + 1, sc), None
    else:
        slot, n_read, sparse = min(pos, sc - 1), pos + 1, _sparse(cfg, impl)
    segment_write(kc, k, slot, mc, seq)
    segment_write(vc, v, slot, mc, seq)
    y = decode_segment(q, kc, vc, n_read, mc, seq, sparse=sparse)
    if tp.attn:                         # this rank's heads for the row-parallel wo
        h_loc = cfg.n_heads // mc.model_size
        y = y[:, :, mc.coord(tp.model) * h_loc:(mc.coord(tp.model) + 1) * h_loc]
    o = lora_proj(y.reshape(b, 1, -1).contiguous(), lp["mixer"]["wo"], _sub(mf, "wo"),
                  scale=lora_scale)
    x = x + (all_reduce(o, mc, tp.model) if tp.attn else o)
    if kind.mixer == "dec":
        cf, cp = _sub(lora, "cross"), lp["cross"]
        xn2 = apply_norm(x, lp["norm_x"], cfg.norm, cfg.norm_eps)
        qx = lora_proj(xn2, cp["wq"], _sub(cf, "wq"), scale=lora_scale).reshape(
            b, 1, cfg.n_heads, cfg.hd)
        seqx = specs["xk"][1]
        yx = decode_segment(qx, cache["xk"], cache["xv"],
                            cache["xk"].shape[1] * mc.extent(seqx), mc, seqx)
        x = x + lora_proj(yx.reshape(b, 1, -1), cp["wo"], _sub(cf, "wo"),
                          scale=lora_scale)
    return x


def layer_cache_shape(cfg: ModelConfig, kind: LayerKind, batch: int,
                      cache_len: int, dtype, sparse_kv: bool = False):
    """Cache entry of one layer as {name: (shape, dtype)} (no leading repeat
    axis).  The SSM state is f32 whatever the model dtype; a ``local``
    layer's ring holds min(cache_len, window) positions; with ``sparse_kv``
    an ``attn`` layer of a config with a sparse pattern holds the sparse-KV
    layout of a ``cache_len``-position sequence; a ``dec`` layer also holds
    the encoder memory's cross k/v; a ``none`` layer holds nothing."""
    if kind.mixer == "none":
        return {}
    kk, hd = cfg.n_kv_heads, cfg.hd
    if kind.mixer == "mamba":
        s = cfg.ssm
        conv_dim = cfg.d_inner + 2 * s.n_groups * s.state
        return {"h": ((batch, cfg.ssm_heads, s.headdim, s.state), torch.float32),
                "conv": ((batch, s.conv_width - 1, conv_dim), dtype)}
    if kind.mixer == "mla":
        m = cfg.mla
        return {"ckv": ((batch, cache_len, m.kv_lora_rank), dtype),
                "kpe": ((batch, cache_len, m.rope_head_dim), dtype)}
    if sparse_kv and kind.mixer == "attn" and cfg.sparse_attn is not None:
        _, _, ring, n_pers = sparse_kv_layout(cache_len, cfg.sparse_attn)
        return {"k_pers": ((batch, n_pers, kk, hd), dtype),
                "v_pers": ((batch, n_pers, kk, hd), dtype),
                "k_ring": ((batch, ring, kk, hd), dtype),
                "v_ring": ((batch, ring, kk, hd), dtype)}
    if kind.mixer == "local" and cfg.window:
        cache_len = min(cache_len, cfg.window)
    shp = (batch, cache_len, kk, hd)
    entry = {"k": (shp, dtype), "v": (shp, dtype)}
    if kind.mixer == "dec":
        cross = (batch, cfg.encoder_seq, kk, hd)
        entry.update(xk=(cross, dtype), xv=(cross, dtype))
    return entry


def layer_param_count(cfg: ModelConfig, kind: LayerKind, active_only: bool = False) -> int:
    """The analytic parameter count of one layer (the JAX package's
    accounting): norms, the mixer's projections, the ff (top-k experts
    under ``active_only``)."""
    d = cfg.d_model
    n = d                                                        # norm1
    if kind.mixer in ("attn", "local", "enc", "dec"):
        n += d * cfg.n_heads * cfg.hd * 2 + d * cfg.n_kv_heads * cfg.hd * 2
        if kind.mixer == "dec":
            n += d * cfg.n_heads * cfg.hd * 2 + d * cfg.n_kv_heads * cfg.hd * 2 + d
    elif kind.mixer == "mla":
        m = cfg.mla
        qk = m.nope_head_dim + m.rope_head_dim
        n += (d * m.q_lora_rank + m.q_lora_rank
              + m.q_lora_rank * cfg.n_heads * qk
              + d * (m.kv_lora_rank + m.rope_head_dim) + m.kv_lora_rank
              + m.kv_lora_rank * cfg.n_heads * (m.nope_head_dim + m.v_head_dim)
              + cfg.n_heads * m.v_head_dim * d)
    elif kind.mixer == "mamba":
        s = cfg.ssm
        d_in, h = cfg.d_inner, cfg.ssm_heads
        conv_dim = d_in + 2 * s.n_groups * s.state
        proj_out = 2 * d_in + 2 * s.n_groups * s.state + h
        n += d * proj_out + s.conv_width * conv_dim + conv_dim + 3 * h + d_in + d_in * d
    mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    if kind.ff == "mlp":
        n += d + mult * d * cfg.d_ff
    elif kind.ff == "moe":
        m = cfg.moe
        e = m.top_k if active_only else m.n_experts
        n += d + d * m.n_experts + e * mult * d * m.d_ff
        if m.n_shared_experts:
            n += mult * d * (m.n_shared_experts * m.d_ff)
    return n
