"""Model: the stack runner over stage patterns (decoders, encoders and the
encoder-decoder).

The port of ``repro.models.transformer.Model`` for every family the JAX
package configures — dense GQA decoders with learned or rotary positions
(gpt2, the llamas, deepseek-67b), gemma3's sliding-window ``local`` layers,
the VLM (internvl2: projected patch embeddings before the text), MoE
(dbrx), MLA with fine-grained MoE (deepseek-v2), the attention + Mamba +
MoE hybrid (jamba), attention-free Mamba-2, the encoder-only RoBERTa and
the encoder-decoder whisper: token embeddings (plus learned positions where
the config has them), stages of repeated layer patterns (parameters stacked
on a leading repeat axis, walked by a Python loop where the JAX package
``lax.scan``s), the final norm and the (tied) LM head, and for an encoder
the classifier head.  An encoder-decoder runs its ``stream="encoder"``
stages first over the post-conv ``frames`` (plus ``enc_pos``, then
``enc_norm``: the memory), then its decoder stages, whose ``dec`` layers
cross-attend to the memory; its encoder stages hold no decode cache (None in
their place).  Parameters are plain nested dicts of tensors in the JAX
layout, so ``bridge`` moves them between the two packages unchanged.

Entry points:

* ``lm_loss``     — chunked cross-entropy over the masked positions (MLM
                    pretraining, full and PEFT fine-tuning; a VLM's loss
                    covers its text positions only)
* ``cls_loss``    — the encoder classifier's loss and accuracy (PFTT)
* ``prefill``     — full prompt → last-token logits and a decode cache
* ``decode_step`` — one token against the cache (updated in place)

Both losses add ``AUX_WEIGHT · aux``, the sum of the MoE layers' balance
losses, as the JAX package does; a model without MoE layers adds nothing.

``opts`` takes the JAX package's option names:

* ``sparse_gather_decode`` — under ``impl="sparse"`` the decode reads only
  the pattern's active blocks; the decode kernel's sparse mask already
  reads exactly those positions, so the flag changes no launch;
* ``sparse_kv_seq`` (int) — ``init_cache`` gives ``attn`` layers the
  sparse-KV layout of that many positions (a persistent region and a ring,
  ``models.attention.sparse_kv_layout``); ``prefill`` keeps plain caches,
  as the JAX package's does;
* ``causal_skip`` — accepted: the flash kernel never loads a kv tile above
  the causal diagonal, so causal attention skips them always;
* ``mamba_sp`` and ``moe_a2a`` (sequence- and expert-parallel) need the
  (data, model) tensor-parallel mesh and raise (ROADMAP queue 1 item 8's
  last part; the client-sharded mesh of ``repro_torch.sharding`` does not
  shard a model).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, trees
from repro_torch.configs.base import ModelConfig
from repro_torch.models import mla, moe, ssm
from repro_torch.models.blocks import (IMPLS, apply_layer_decode,
                                       apply_layer_seq, check_kind,
                                       layer_cache_shape, rope_width)
from repro_torch.models.norms import apply_norm
from repro_torch.models.rope import rope_cos_sin

AUX_WEIGHT = 0.01
OPTS = ("sparse_gather_decode", "sparse_kv_seq", "causal_skip")
MESH_OPTS = ("mamba_sp", "moe_a2a")


def _at(tree, r: int):
    """One repeat's slice of a stacked (sub)tree (views, no copies)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    return tree[r]


class Model:
    """``impl`` picks the attention core as in the JAX package: "sparse"
    runs the config's block-sparse pattern (prefill and decode), every other
    value exact attention.  ``forward``, ``prefill`` and ``decode_step``
    take an ``impl`` that overrides it for one call.  ``opts``: the module
    docstring's options.  ``remat``: when gradients are recorded (training),
    each repeat of a stage runs under ``torch.utils.checkpoint`` (the JAX
    package's ``jax.checkpoint`` of the layer-scan body): its activations
    are recomputed in the backward, the kernels' forwards and MoE's routing
    included, which changes neither the loss nor a gradient."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None,
                 impl: str = "auto", opts: Optional[dict] = None, remat: bool = False):
        for stage in cfg.stages:
            for kind in stage.pattern:
                check_kind(kind)
        self._check_impl(impl)
        opts = dict(opts or {})
        mesh = [k for k in opts if k in MESH_OPTS and opts[k]]
        if mesh:
            raise NotImplementedError(
                f"Model opts {mesh} need the (data, model) tensor-parallel mesh: "
                "ROADMAP queue 1 item 8's last part")
        unknown = sorted(set(opts) - set(OPTS) - set(MESH_OPTS))
        if unknown:
            raise ValueError(f"unknown Model opts {unknown}; known: {OPTS + MESH_OPTS}")
        self.cfg = cfg
        self.dtype = dtype
        self.impl = impl
        self.remat = remat
        self.opts = opts
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator, max_seq: int = 0) -> Dict[str, Any]:
        """Random parameters at the JAX package's shapes and scales, drawn
        on the CPU from ``generator`` and moved to the model's device."""
        cfg = self.cfg

        def normal(shape, std):
            return (torch.randn(*shape, generator=generator) * std).to(
                device=self.device, dtype=self.dtype)

        def norm(dim):
            one = torch.ones if cfg.norm == "ln" else torch.zeros
            p = {"scale": one(dim, device=self.device, dtype=self.dtype)}
            if cfg.norm == "ln":
                p["bias"] = torch.zeros(dim, device=self.device, dtype=self.dtype)
            return p

        def stacked_norm(r, dim):
            return {k: v.expand(r, dim).clone() for k, v in norm(dim).items()}

        d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd

        def attn_proj(r):
            return {"wq": normal((r, d, h * hd), d ** -0.5),
                    "wk": normal((r, d, kh * hd), d ** -0.5),
                    "wv": normal((r, d, kh * hd), d ** -0.5),
                    "wo": normal((r, h * hd, d), (h * hd) ** -0.5)}

        params: Dict[str, Any] = {
            "embed": normal((cfg.vocab_size, d), 0.02),
            "final_norm": norm(d),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = normal((d, cfg.vocab_size), 0.02)
        if cfg.pos == "learned":
            params["pos_embed"] = normal((max(cfg.max_position, max_seq, 1024), d), 0.02)
        if cfg.n_prefix_tokens:
            params["projector"] = normal((cfg.prefix_dim, d), cfg.prefix_dim ** -0.5)
        if cfg.encoder_seq:
            params["enc_pos"] = normal((cfg.encoder_seq, d), 0.02)
            params["enc_norm"] = norm(d)
        if cfg.n_classes:
            params["cls_head"] = normal((d, cfg.n_classes), 0.02)
        stages = []
        for stage in cfg.stages:
            r = stage.repeats
            layers = []
            for kind in stage.pattern:
                lp = {"norm1": stacked_norm(r, d)}
                if kind.mixer == "mamba":
                    lp["mixer"] = ssm.init_mamba(normal, d, cfg.ssm, self.dtype,
                                                 self.device, lead=(r,))
                elif kind.mixer == "mla":
                    lp["mixer"] = mla.init_mla(normal, d, h, cfg.mla, self.dtype,
                                               self.device, lead=(r,))
                else:
                    lp["mixer"] = attn_proj(r)
                    if kind.mixer == "dec":
                        lp["cross"] = attn_proj(r)
                        lp["norm_x"] = stacked_norm(r, d)
                if kind.ff == "mlp":
                    lp["norm2"] = stacked_norm(r, d)
                    lp["ff"] = {"wu": normal((r, d, cfg.d_ff), d ** -0.5),
                                "wd": normal((r, cfg.d_ff, d), cfg.d_ff ** -0.5)}
                    if cfg.act in ("swiglu", "geglu"):
                        lp["ff"]["wg"] = normal((r, d, cfg.d_ff), d ** -0.5)
                elif kind.ff == "moe":
                    lp["norm2"] = stacked_norm(r, d)
                    lp["ff"] = moe.init_moe(normal, d, cfg.moe, cfg.act, lead=(r,))
                layers.append(lp)
            stages.append({"layers": layers})
        params["stages"] = stages
        return params

    # -------------------------------------------------------------- plumbing
    def _embed_tokens(self, params, tokens, positions):
        x = params["embed"][tokens].to(self.dtype)
        if self.cfg.embed_scale:
            x = x * self.cfg.d_model ** 0.5
        if self.cfg.pos == "learned":
            x = x + params["pos_embed"][positions].to(self.dtype)
        return x

    def _rot(self, positions):
        """The rotary (cos, sin) table of ``positions`` that every layer of
        a step shares, or None (learned positions, attention-free)."""
        cfg = self.cfg
        if cfg.pos != "rope" or cfg.attention_free:
            return None
        return rope_cos_sin(positions, rope_width(cfg), cfg.rope_theta)

    @staticmethod
    def _check_impl(impl):
        if impl not in IMPLS:
            raise ValueError(f"impl {impl!r} not in {IMPLS}")

    @staticmethod
    def _lora_stage(lora, si):
        return None if lora is None else lora["stages"][si]

    @staticmethod
    def _check_lora(lora):
        """Factors reach only layer-stack projections; factors mirroring any
        other leaf (lm_head, embed, …) would be silently ignored — fail
        loudly instead (the merged oracle ``peft.apply_lora`` takes them)."""
        if lora is None:
            return
        stray = [p for p in trees.flatten(lora) if not p.startswith("stages/")]
        if stray:
            raise ValueError(
                "factored LoRA execution only supports factors on stage layer "
                f"weights; found factors at {sorted(set(stray))} — merge these "
                "with peft.apply_lora instead")

    # -------------------------------------------------------------- forward
    def forward(self, params, tokens, *, frames=None, patches=None,
                impl: Optional[str] = None, collect_cache: bool = False, lora=None,
                lora_scale: float = 1.0):
        """tokens (B, S) → (hidden (B, P + S, d), caches), positions from 0;
        a VLM's ``patches`` (B, P, prefix_dim) are projected into the first
        P positions; an encoder-decoder's ``frames`` (B, S_enc, d) are its
        encoder's input.  With ``collect_cache`` (decoders only)
        caches[si][pi] holds each layer's cache entry stacked over the
        repeats — {"k", "v"} (repeats, B, P + S, K, hd) for attention (a
        ``dec`` layer adds {"xk", "xv"} (repeats, B, S_enc, K, hd)),
        {"ckv", "kpe"} for MLA, {"h", "conv"} for mamba — and an encoder
        stage's caches[si] is None; otherwise caches is None."""
        hidden, _, caches = self._run(params, tokens, frames=frames, patches=patches,
                                      impl=impl, collect_cache=collect_cache, lora=lora,
                                      lora_scale=lora_scale)
        return hidden, caches

    def _stages(self, params, lora, x, rot, impl, lora_scale, *, stream=None,
                memory=None, collect_cache=False):
        """Run the stages (of one ``stream``, or all) over x → (x, aux,
        caches: a list per stage, None for a stage not run)."""
        cfg = self.cfg
        aux = None
        caches = []
        # rematerialization in training: a repeat's activations are dropped
        # after its forward and recomputed in the backward
        remat = self.remat and torch.is_grad_enabled() and not collect_cache
        for si, stage in enumerate(cfg.stages):
            if stream is not None and stage.stream != stream:
                caches.append(None)
                continue
            sp, lsp = params["stages"][si], self._lora_stage(lora, si)
            got = [{} for _ in stage.pattern]

            def repeat(x, aux, r, stage=stage, sp=sp, lsp=lsp, got=got):
                """One repeat of the stage's layer pattern."""
                for pi, kind in enumerate(stage.pattern):
                    lf = None if lsp is None else _at(lsp["layers"][pi], r)
                    x, c, a = apply_layer_seq(x, _at(sp["layers"][pi], r), kind, cfg,
                                              rot, impl=impl, lora=lf,
                                              lora_scale=lora_scale, memory=memory)
                    if a is not None:
                        aux = a if aux is None else aux + a
                    if collect_cache:
                        for name, t in c.items():
                            got[pi].setdefault(name, []).append(t)
                return x, aux

            for r in range(stage.repeats):
                if remat:
                    x, aux = checkpoint(repeat, x, aux, r, use_reentrant=False)
                else:
                    x, aux = repeat(x, aux, r)
            caches.append([{n: torch.stack(t) for n, t in e.items()} for e in got]
                          if collect_cache else None)
        return x, aux, caches

    def _encode(self, params, frames, impl, lora, lora_scale):
        """The encoder-decoder's memory: its encoder stages over the
        post-conv ``frames`` (B, S_enc, d) plus ``enc_pos``, then
        ``enc_norm`` (an encoder stage's balance loss is dropped, as the
        JAX package drops it)."""
        cfg = self.cfg
        if frames is None or tuple(frames.shape[1:]) != (cfg.encoder_seq, cfg.d_model):
            raise ValueError(f"{cfg.name} takes frames (B, {cfg.encoder_seq}, "
                             f"{cfg.d_model})")
        x = frames.to(self.dtype) + params["enc_pos"].to(self.dtype)[None]
        x, _, _ = self._stages(params, lora, x, None, impl, lora_scale,
                               stream="encoder")
        return apply_norm(x, params["enc_norm"], cfg.norm, cfg.norm_eps)

    def _run(self, params, tokens, *, frames=None, patches=None, impl=None,
             collect_cache=False, lora=None, lora_scale=1.0):
        """``forward`` → (hidden, aux, caches); aux is the MoE layers' summed
        balance loss, None without MoE layers."""
        cfg = self.cfg
        impl = impl or self.impl
        self._check_impl(impl)
        self._check_lora(lora)
        if collect_cache:
            self._check_decoder()
        n_pre = cfg.n_prefix_tokens
        if n_pre and (patches is None or patches.shape[1] != n_pre):
            raise ValueError(f"{cfg.name} takes patches (B, {n_pre}, {cfg.prefix_dim})")
        memory = None
        if cfg.is_encoder_decoder:
            memory = self._encode(params, frames, impl, lora, lora_scale)
        positions = torch.arange(n_pre + tokens.shape[1], device=tokens.device)
        x = self._embed_tokens(params, tokens, positions[n_pre:])
        if n_pre:
            x = torch.cat([patches.to(self.dtype) @ params["projector"], x], 1)
        x, aux, caches = self._stages(
            params, lora, x, self._rot(positions), impl, lora_scale,
            stream="decoder" if cfg.is_encoder_decoder else None, memory=memory,
            collect_cache=collect_cache)
        x = apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
        return x, aux, (caches if collect_cache else None)

    @staticmethod
    def _with_aux(loss, aux):
        return loss if aux is None else loss + AUX_WEIGHT * aux

    def _check_decoder(self):
        if self.cfg.is_encoder_only:
            raise ValueError(f"{self.cfg.name} is an encoder: it has no decode "
                             "cache")

    def _lm_head(self, params):
        return params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]

    # ----------------------------------------------------------------- loss
    def lm_loss(self, params, batch, *, impl: Optional[str] = None,
                chunk: int = 512, lora=None, lora_scale: float = 1.0):
        """Cross-entropy over the positions where ``batch["mask"]`` is set,
        the logits formed ``chunk`` positions at a time (never the whole
        (B, S, vocab) at once; one chunk when S is not a multiple).  A VLM's
        batch carries ``patches``, an encoder-decoder's ``frames``."""
        hidden, aux, _ = self._run(params, batch["tokens"], frames=batch.get("frames"),
                                   patches=batch.get("patches"), impl=impl, lora=lora,
                                   lora_scale=lora_scale)
        hidden = hidden[:, self.cfg.n_prefix_tokens:]    # text positions only
        labels, mask = batch["labels"], batch["mask"]
        s = hidden.shape[1]
        head = self._lm_head(params)
        chunk = min(chunk, s)
        if s % chunk:
            chunk = s
        tot = cnt = 0.0
        for c0 in range(0, s, chunk):
            logits = (hidden[:, c0:c0 + chunk] @ head).float()
            logz = torch.logsumexp(logits, dim=-1)
            ll = logits.gather(-1, labels[:, c0:c0 + chunk, None].long())[..., 0]
            m = mask[:, c0:c0 + chunk].float()
            tot = tot + ((logz - ll) * m).sum()
            cnt = cnt + m.sum()
        return self._with_aux(tot / torch.clamp(cnt, min=1.0), aux)

    def cls_loss(self, params, batch, *, impl: Optional[str] = None,
                 lora=None, lora_scale: float = 1.0):
        """Encoder classifier (PFTT) on the first position → (loss, accuracy).
        An optional ``batch["valid"]`` (B,) sample weight (the padded rows of
        a ragged cohort, ``core.cohort.HostBatchStacker``) makes both the
        weighted means over the real rows."""
        hidden, aux, _ = self._run(params, batch["tokens"], impl=impl, lora=lora,
                                   lora_scale=lora_scale)
        logits = (hidden[:, 0] @ params["cls_head"]).float()
        label = batch["label"].long()
        logz = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, label[:, None])[:, 0]
        correct = (logits.argmax(-1) == label).float()
        w = batch.get("valid")
        if w is None:
            return self._with_aux((logz - ll).mean(), aux), correct.mean()
        wsum = torch.clamp(w.sum(), min=1.0)
        return (self._with_aux(((logz - ll) * w).sum() / wsum, aux),
                (correct * w).sum() / wsum)

    def logits(self, params, hidden):
        return (hidden @ self._lm_head(params)).float()

    # ---------------------------------------------------------------- cache
    def init_cache(self, batch: int, cache_len: int, dtype=None, *,
                   sparse_kv: Optional[bool] = None):
        """{"pos": host int, "stages": [[entry per pattern position]]}, each
        entry stacked over the repeats: {"k", "v"} (repeats, B, Sc, K, hd)
        for attention (Sc = min(cache_len, window) for a ``local`` ring; a
        ``dec`` layer adds the cross {"xk", "xv"}; with the ``sparse_kv_seq``
        option an ``attn`` layer holds the sparse-KV layout of ``cache_len``
        positions instead), {"ckv", "kpe"} for MLA, {"h" f32, "conv"} for
        mamba; an encoder stage's place holds None.  A VLM's prefix takes
        cache positions too.  ``sparse_kv`` overrides the option (prefill
        builds plain caches)."""
        self._check_decoder()
        dtype = dtype or self.dtype
        if sparse_kv is None:
            sparse_kv = bool(self.opts.get("sparse_kv_seq"))
        return {"pos": 0, "stages": [
            None if self.cfg.is_encoder_decoder and stage.stream != "decoder" else
            [{n: torch.zeros((stage.repeats,) + shp, dtype=dt, device=self.device)
              for n, (shp, dt) in layer_cache_shape(self.cfg, kind, batch, cache_len,
                                                    dtype, sparse_kv).items()}
             for kind in stage.pattern]
            for stage in self.cfg.stages]}

    # -------------------------------------------------------------- prefill
    def prefill(self, params, tokens, cache_len: int, *, frames=None, patches=None,
                impl: Optional[str] = None, lora=None, lora_scale: float = 1.0):
        """Run the prompt (after a VLM's ``patches``; an encoder-decoder's
        ``frames`` through its encoder); return (last-token logits (B,
        vocab) f32, cache) with the cache's ``pos`` at the prompt's end, the
        prefix included.  A ``local`` ring keeps the prompt's last Sc
        positions, position p at slot p mod Sc; a ``dec`` layer's cross
        k/v are kept whole."""
        s_prompt = self.cfg.n_prefix_tokens + tokens.shape[1]
        if s_prompt > cache_len:
            raise ValueError(f"prompt length {s_prompt} (prefix included) > "
                             f"cache_len {cache_len}")
        hidden, caches = self.forward(params, tokens, frames=frames, patches=patches,
                                      impl=impl, collect_cache=True, lora=lora,
                                      lora_scale=lora_scale)
        cache = self.init_cache(tokens.shape[0], cache_len, sparse_kv=False)
        for entries, got in zip(cache["stages"], caches):
            if entries is None:
                continue
            for entry, raw in zip(entries, got):
                for name, buf in entry.items():
                    if name in ("h", "conv", "xk", "xv"):   # whole, not per position
                        buf.copy_(raw[name])
                        continue
                    sc = buf.shape[2]
                    if s_prompt <= sc:
                        buf[:, :, :s_prompt] = raw[name]
                    else:                       # ring: the last sc positions
                        slots = torch.arange(s_prompt - sc, s_prompt,
                                             device=buf.device) % sc
                        buf[:, :, slots] = raw[name][:, :, -sc:]
        cache["pos"] = s_prompt
        return self.logits(params, hidden[:, -1]), cache

    # ---------------------------------------------------------------- decode
    def decode_step(self, params, cache, tokens, *, impl: Optional[str] = None,
                    lora=None, lora_scale: float = 1.0):
        """tokens (B, 1) → (logits (B, vocab) f32, cache).  The cache's
        buffers are updated in place and its host ``pos`` advanced."""
        cfg = self.cfg
        impl = impl or self.impl
        self._check_impl(impl)
        self._check_lora(lora)
        self._check_decoder()
        pos = cache["pos"]
        positions = torch.full_like(tokens, pos)
        x = self._embed_tokens(params, tokens, positions)
        rot = self._rot(positions[0])
        for si, stage in enumerate(cfg.stages):
            if cache["stages"][si] is None:      # an encoder stage
                continue
            sp, lsp = params["stages"][si], self._lora_stage(lora, si)
            for r in range(stage.repeats):
                for pi, kind in enumerate(stage.pattern):
                    lf = None if lsp is None else _at(lsp["layers"][pi], r)
                    x = apply_layer_decode(x, _at(sp["layers"][pi], r), kind,
                                           _at(cache["stages"][si][pi], r), pos,
                                           cfg, rot, impl=impl, lora=lf,
                                           lora_scale=lora_scale, opts=self.opts)
        x = apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
        cache["pos"] = pos + 1
        return self.logits(params, x[:, 0]), cache
