"""Model: the stack runner over stage patterns (decoders and the encoder).

The port of ``repro.models.transformer.Model`` for the families ported so
far — dense GQA decoders with learned or rotary positions (gpt2, the
llamas, deepseek-67b), gemma3's sliding-window ``local`` layers, the VLM
(internvl2: projected patch embeddings before the text), MoE (dbrx), the
attention + Mamba + MoE hybrid (jamba), attention-free Mamba-2 and the
encoder-only RoBERTa: token embeddings (plus learned positions where the
config has them), stages of repeated layer patterns (parameters stacked on
a leading repeat axis, walked by a Python loop where the JAX package
``lax.scan``s), the final norm and the (tied) LM head, and for an encoder
the classifier head.  Parameters are plain nested dicts of tensors in the
JAX layout, so ``bridge`` moves them between the two packages unchanged.
MLA (deepseek-v2) and encoder-decoder stacks (whisper) are refused by name.

Entry points:

* ``lm_loss``     — chunked cross-entropy over the masked positions (MLM
                    pretraining, full and PEFT fine-tuning; a VLM's loss
                    covers its text positions only)
* ``cls_loss``    — the encoder classifier's loss and accuracy (PFTT)
* ``prefill``     — full prompt → last-token logits and a decode cache
* ``decode_step`` — one token against the cache (updated in place)

Both losses add ``AUX_WEIGHT · aux``, the sum of the MoE layers' balance
losses, as the JAX package does; a model without MoE layers adds nothing.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device, trees
from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe, ssm
from repro_torch.models.blocks import (IMPLS, apply_layer_decode,
                                       apply_layer_seq, check_kind,
                                       layer_cache_shape)
from repro_torch.models.norms import apply_norm
from repro_torch.models.rope import rope_cos_sin

AUX_WEIGHT = 0.01


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
    take an ``impl`` that overrides it for one call."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None,
                 impl: str = "auto"):
        if cfg.is_encoder_decoder:
            raise NotImplementedError(
                f"{cfg.name}: encoder-decoder stacks are ported with the arch "
                "zoo's fourteenth slice (whisper)")
        for stage in cfg.stages:
            for kind in stage.pattern:
                check_kind(kind)
        self._check_impl(impl)
        self.cfg = cfg
        self.dtype = dtype
        self.impl = impl
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
                else:
                    lp["mixer"] = {
                        "wq": normal((r, d, h * hd), d ** -0.5),
                        "wk": normal((r, d, kh * hd), d ** -0.5),
                        "wv": normal((r, d, kh * hd), d ** -0.5),
                        "wo": normal((r, h * hd, d), (h * hd) ** -0.5),
                    }
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
        return rope_cos_sin(positions, cfg.hd, cfg.rope_theta)

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
    def forward(self, params, tokens, *, patches=None, impl: Optional[str] = None,
                collect_cache: bool = False, lora=None, lora_scale: float = 1.0):
        """tokens (B, S) → (hidden (B, P + S, d), caches), positions from 0;
        a VLM's ``patches`` (B, P, prefix_dim) are projected into the first
        P positions.  With ``collect_cache`` (decoders only) caches[si][pi]
        holds each layer's cache entry stacked over the repeats — {"k",
        "v"} (repeats, B, P + S, K, hd) for attention, {"h", "conv"} for
        mamba; otherwise it is None."""
        hidden, _, caches = self._run(params, tokens, patches=patches, impl=impl,
                                      collect_cache=collect_cache, lora=lora,
                                      lora_scale=lora_scale)
        return hidden, caches

    def _run(self, params, tokens, *, patches=None, impl=None,
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
        positions = torch.arange(n_pre + tokens.shape[1], device=tokens.device)
        x = self._embed_tokens(params, tokens, positions[n_pre:])
        if n_pre:
            x = torch.cat([patches.to(self.dtype) @ params["projector"], x], 1)
        rot = self._rot(positions)
        aux = None
        caches = [] if collect_cache else None
        for si, stage in enumerate(cfg.stages):
            sp, lsp = params["stages"][si], self._lora_stage(lora, si)
            got = [{} for _ in stage.pattern]
            for r in range(stage.repeats):
                for pi, kind in enumerate(stage.pattern):
                    lf = None if lsp is None else _at(lsp["layers"][pi], r)
                    x, c, a = apply_layer_seq(x, _at(sp["layers"][pi], r), kind, cfg,
                                              rot, impl=impl, lora=lf,
                                              lora_scale=lora_scale)
                    if a is not None:
                        aux = a if aux is None else aux + a
                    if collect_cache:
                        for name, t in c.items():
                            got[pi].setdefault(name, []).append(t)
            if collect_cache:
                caches.append([{n: torch.stack(t) for n, t in e.items()} for e in got])
        x = apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
        return x, aux, caches

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
        (B, S, vocab) at once; one chunk when S is not a multiple)."""
        hidden, aux, _ = self._run(params, batch["tokens"], patches=batch.get("patches"),
                                   impl=impl, lora=lora, lora_scale=lora_scale)
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
    def init_cache(self, batch: int, cache_len: int, dtype=None):
        """{"pos": host int, "stages": [[entry per pattern position]]}, each
        entry stacked over the repeats: {"k", "v"} (repeats, B, Sc, K, hd)
        for attention (Sc = min(cache_len, window) for a ``local`` ring),
        {"h" f32, "conv"} for mamba.  A VLM's prefix takes cache positions
        too."""
        self._check_decoder()
        dtype = dtype or self.dtype
        return {"pos": 0, "stages": [
            [{n: torch.zeros((stage.repeats,) + shp, dtype=dt, device=self.device)
              for n, (shp, dt) in layer_cache_shape(self.cfg, kind, batch,
                                                    cache_len, dtype).items()}
             for kind in stage.pattern]
            for stage in self.cfg.stages]}

    # -------------------------------------------------------------- prefill
    def prefill(self, params, tokens, cache_len: int, *, patches=None,
                impl: Optional[str] = None, lora=None, lora_scale: float = 1.0):
        """Run the prompt (after a VLM's ``patches``); return (last-token
        logits (B, vocab) f32, cache) with the cache's ``pos`` at the prompt's
        end, the prefix included.  A ``local`` ring keeps the prompt's last
        Sc positions, position p at slot p mod Sc."""
        s_prompt = self.cfg.n_prefix_tokens + tokens.shape[1]
        if s_prompt > cache_len:
            raise ValueError(f"prompt length {s_prompt} (prefix included) > "
                             f"cache_len {cache_len}")
        hidden, caches = self.forward(params, tokens, patches=patches, impl=impl,
                                      collect_cache=True, lora=lora,
                                      lora_scale=lora_scale)
        cache = self.init_cache(tokens.shape[0], cache_len)
        for entries, got in zip(cache["stages"], caches):
            for entry, raw in zip(entries, got):
                for name, buf in entry.items():
                    if name in ("h", "conv"):   # whole states, not per position
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
            sp, lsp = params["stages"][si], self._lora_stage(lora, si)
            for r in range(stage.repeats):
                for pi, kind in enumerate(stage.pattern):
                    lf = None if lsp is None else _at(lsp["layers"][pi], r)
                    x = apply_layer_decode(x, _at(sp["layers"][pi], r), kind,
                                           _at(cache["stages"][si][pi], r), pos,
                                           cfg, rot, impl=impl, lora=lf,
                                           lora_scale=lora_scale)
        x = apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
        cache["pos"] = pos + 1
        return self.logits(params, x[:, 0]), cache
