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
* ``mamba_sp`` — under a mesh, training runs the mamba mixers
  sequence-parallel (``ssm.mamba_seq_sp``);
* ``moe_a2a`` — under a mesh, the MoE layers route by all-to-all
  (``moe.moe_ffn_a2a``).  Without a mesh (or a model axis) both fall back
  to the single-device mixers, as the JAX package's do.

Under a (data, model) mesh (``Model(cfg, meshctx=...)``, a
``sharding.MeshCtx``) the parameters are this rank's blocks under
``sharding.param_specs`` (``shard`` cuts them from the whole tree,
``unshard`` joins them; ``init`` always draws the whole tree).  The entry
points take the whole batch and return whole results: each rank runs its
batch rows (those of its data coordinate when the batch divides the data
axes, all of them otherwise), the layers run their plans
(``models.parallel``), the embedding and the LM head are vocab-parallel
where the vocab divides the model axis (the cross-entropy's max and sum of
exponentials reduced over it), and a loss's numerator and denominator are
summed over the data ranks apart (the MoE balance loss is the mean of the
data shards', JAX's ``pmean``).  The decode cache is laid out by
``sharding.cache_specs`` (``init_cache``/``prefill`` return this rank's
blocks; its ``specs`` and whole ``batch`` ride in the cache dict).  The
JAX package's sequence-sharded layer boundary changes no number and is not
done: activations between layers are replicated over the model axis.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, trees
from repro_torch.configs.base import ModelConfig
from repro_torch.models import mla, moe, ssm
from repro_torch.models.blocks import (IMPLS, apply_layer_decode, apply_layer_seq,
                                       layer_cache_shape, rope_width)
from repro_torch.models.norms import apply_norm
from repro_torch.models.parallel import (layer_plan, layer_view, plan_factors,
                                         view_leaf, vocab_embed, vocab_xent)
from repro_torch.models.rope import rope_cos_sin
from repro_torch.sharding import (MeshCtx, Spec, all_reduce, cache_specs, gather,
                                  local_shape, param_specs, reduce_from, shard_leaf,
                                  shard_tree, spec_axes, unshard_tree)

AUX_WEIGHT = 0.01
OPTS = ("sparse_gather_decode", "sparse_kv_seq", "causal_skip", "mamba_sp", "moe_a2a")


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
    included, which changes neither the loss nor a gradient.  ``meshctx``:
    the (data, model) mesh (the module docstring), ``policy`` the
    ``param_specs`` policy ``shard`` cuts by."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None,
                 impl: str = "auto", opts: Optional[dict] = None, remat: bool = False,
                 meshctx: Optional[MeshCtx] = None, policy: str = "fsdp"):
        self._check_impl(impl)
        opts = dict(opts or {})
        unknown = sorted(set(opts) - set(OPTS))
        if unknown:
            raise ValueError(f"unknown Model opts {unknown}; known: {OPTS}")
        self.cfg = cfg
        self.dtype = dtype
        self.impl = impl
        self.remat = remat
        self.opts = opts
        self.device = resolve_device(device)
        self.mc = meshctx
        self.policy = policy
        self.specs: Dict[str, Spec] = {}     # path → spec of the blocks ``shard`` cut
        self._layer_specs: Dict[tuple, dict] = {}

    # ------------------------------------------------------------------ init
    def init(self, generator: Optional[torch.Generator], max_seq: int = 0) -> Dict[str, Any]:
        """Random parameters at the JAX package's shapes and scales, drawn
        from ``generator`` on its device (the CPU, or the card for a CUDA
        generator) and moved to the model's device; the whole tree, also
        under a mesh (``shard`` cuts it).  ``generator`` None: ``meta``
        tensors (shapes only)."""
        cfg = self.cfg
        dev = self.device if generator is not None else torch.device("meta")

        def normal(shape, std):
            if generator is None:
                return torch.empty(shape, dtype=self.dtype, device=dev)
            return (torch.randn(*shape, generator=generator, device=generator.device)
                    * std).to(device=dev, dtype=self.dtype)

        def norm(dim):
            one = torch.ones if cfg.norm == "ln" else torch.zeros
            p = {"scale": one(dim, device=dev, dtype=self.dtype)}
            if cfg.norm == "ln":
                p["bias"] = torch.zeros(dim, device=dev, dtype=self.dtype)
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
                if kind.mixer == "none":
                    pass
                elif kind.mixer == "mamba":
                    lp["mixer"] = ssm.init_mamba(normal, d, cfg.ssm, self.dtype,
                                                 dev, lead=(r,))
                elif kind.mixer == "mla":
                    lp["mixer"] = mla.init_mla(normal, d, h, cfg.mla, self.dtype,
                                               dev, lead=(r,))
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

    # ---------------------------------------------------------------- mesh
    def shard(self, tree):
        """A whole parameter tree → this rank's blocks under
        ``param_specs(meshctx, tree, cfg, self.policy)``; the model keeps
        the specs (by path) to run on them."""
        specs = trees.flatten(param_specs(self.mc, tree, self.cfg, self.policy))
        self.specs.update(specs)
        self._layer_specs.clear()
        return shard_tree(tree, specs, self.mc)

    def unshard(self, tree):
        """This rank's blocks → the whole tree, on every rank."""
        return unshard_tree(tree, self.specs, self.mc)

    def sync_grads(self, grads):
        """The gradients of this rank's blocks → their sums over the data
        ranks: a leaf whose spec holds no batch axis (norm scales, the
        router, adapters, LoRA factors, and every leaf of a tree this model
        did not shard) is summed over the data axes, all of them in one
        all_reduce a dtype; an FSDP leaf already is (its gather's
        backward).  The identity without a mesh or data axis."""
        mc = self.mc
        if mc is None or mc.data_size <= 1:
            return grads
        batch = set(mc.batch_axes)
        flat = trees.flatten(grads)
        todo = [p for p, g in flat.items() if g is not None and not any(
            batch & set(spec_axes(e)) for e in self.specs.get(p, ()))]
        out = dict(flat)
        for dt in {flat[p].dtype for p in todo}:
            ps = [p for p in todo if flat[p].dtype == dt]
            buf = all_reduce(torch.cat([flat[p].reshape(-1) for p in ps]), mc, mc.batch_axes)
            off = 0
            for p in ps:
                out[p] = buf[off:off + flat[p].numel()].reshape(flat[p].shape)
                off += flat[p].numel()
        return trees.map_with_path(lambda p, g: out[p], grads)

    def _view(self, params, name: str, keep: bool = False):
        """A top-level leaf (or norm dict) in the compute's layout: whole,
        or with its model dimension this rank's (``keep``)."""
        x = params[name]
        if self.mc is None:
            return x
        if isinstance(x, dict):
            return {k: view_leaf(v, self.specs.get(f"{name}/{k}"), self.mc)
                    for k, v in x.items()}
        return view_leaf(x, self.specs.get(name), self.mc, keep)

    def _vocab(self, name: str) -> bool:
        """Whether ``name`` (embed, lm_head) is split over the model axis
        along its vocab dimension."""
        spec = self.specs.get(name) if self.mc is not None else None
        return spec is not None and spec[0 if name == "embed" else -1] == self.mc.model_axis

    def _rows(self, batch: int) -> bool:
        """Whether each rank runs its data coordinate's rows of a batch."""
        d = self.mc.data_size if self.mc is not None else 1
        return d > 1 and batch % d == 0

    def _local(self, t, rows: bool):
        if t is None or not rows:
            return t
        return shard_leaf(t, Spec(self.mc.batch_axes, *([None] * (t.dim() - 1))), self.mc)

    def _whole_rows(self, t, rows: bool):
        return gather(t, self.mc, self.mc.batch_axes, 0, sum_grad=False) if rows else t

    def _layer(self, sp, lsp, si: int, pi: int, kind, r: int, **flags):
        """One repeat's layer params and factors (in its plan's layout under
        a mesh) and its plan (None without a mesh)."""
        lp = _at(sp["layers"][pi], r)
        lf = None if lsp is None else _at(lsp["layers"][pi], r)
        if self.mc is None:
            return lp, lf, None
        rel = self._layer_specs.get((si, pi))
        if rel is None:
            pre = f"stages/{si}/layers/{pi}/"
            rel = {p[len(pre):]: Spec(*tuple(sp_)[1:]) for p, sp_ in self.specs.items()
                   if p.startswith(pre)}
            self._layer_specs[(si, pi)] = rel
        plan = layer_plan(self.mc, self.cfg, kind, rel,
                          mamba_sp=bool(self.opts.get("mamba_sp")),
                          moe_a2a=bool(self.opts.get("moe_a2a")), **flags)
        return layer_view(lp, rel, plan), plan_factors(lf, plan), plan

    # -------------------------------------------------------------- plumbing
    def _embed_tokens(self, params, tokens, positions):
        if self._vocab("embed"):
            x = vocab_embed(self._view(params, "embed", keep=True), tokens,
                            self.mc).to(self.dtype)
        else:
            x = self._view(params, "embed")[tokens].to(self.dtype)
        if self.cfg.embed_scale:
            x = x * self.cfg.d_model ** 0.5
        if self.cfg.pos == "learned":
            x = x + self._view(params, "pos_embed")[positions].to(self.dtype)
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
                memory=None, collect_cache=False, rows=False, train=False):
        """Run the stages (of one ``stream``, or all) over x → (x, aux,
        caches: a list per stage, None for a stage not run).  Under a mesh
        each layer's view (its FSDP gathers) is taken inside the repeat, so
        remat takes it again in the backward."""
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

            def repeat(x, aux, r, stage=stage, sp=sp, lsp=lsp, got=got, si=si):
                """One repeat of the stage's layer pattern."""
                for pi, kind in enumerate(stage.pattern):
                    lp, lf, tp = self._layer(sp, lsp, si, pi, kind, r, rows=rows,
                                             train=train)
                    x, c, a = apply_layer_seq(x, lp, kind, cfg, rot, impl=impl, lora=lf,
                                              lora_scale=lora_scale, memory=memory,
                                              tp=tp, collect=collect_cache)
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

    def _encode(self, params, frames, impl, lora, lora_scale, rows=False, train=False):
        """The encoder-decoder's memory: its encoder stages over the
        post-conv ``frames`` (B, S_enc, d) plus ``enc_pos``, then
        ``enc_norm`` (an encoder stage's balance loss is dropped, as the
        JAX package drops it)."""
        cfg = self.cfg
        if frames is None or tuple(frames.shape[1:]) != (cfg.encoder_seq, cfg.d_model):
            raise ValueError(f"{cfg.name} takes frames (B, {cfg.encoder_seq}, "
                             f"{cfg.d_model})")
        x = frames.to(self.dtype) + self._view(params, "enc_pos").to(self.dtype)[None]
        x, _, _ = self._stages(params, lora, x, None, impl, lora_scale,
                               stream="encoder", rows=rows, train=train)
        return apply_norm(x, self._view(params, "enc_norm"), cfg.norm, cfg.norm_eps)

    def _run(self, params, tokens, *, frames=None, patches=None, impl=None,
             collect_cache=False, lora=None, lora_scale=1.0, train=False):
        """``forward`` → (hidden, aux, caches); aux is the MoE layers' summed
        balance loss, None without MoE layers.  Under a mesh the inputs are
        the whole batch and the outputs this rank's rows."""
        cfg = self.cfg
        rows = self._rows(tokens.shape[0])
        tokens, frames, patches = (self._local(t, rows) for t in (tokens, frames, patches))
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
            memory = self._encode(params, frames, impl, lora, lora_scale, rows, train)
        positions = torch.arange(n_pre + tokens.shape[1], device=tokens.device)
        x = self._embed_tokens(params, tokens, positions[n_pre:])
        if n_pre:
            x = torch.cat([patches.to(self.dtype) @ self._view(params, "projector"), x], 1)
        x, aux, caches = self._stages(
            params, lora, x, self._rot(positions), impl, lora_scale,
            stream="decoder" if cfg.is_encoder_decoder else None, memory=memory,
            collect_cache=collect_cache, rows=rows, train=train)
        x = apply_norm(x, self._view(params, "final_norm"), cfg.norm, cfg.norm_eps)
        return x, aux, (caches if collect_cache else None)

    @staticmethod
    def _with_aux(loss, aux):
        return loss if aux is None else loss + AUX_WEIGHT * aux

    def _check_decoder(self):
        if self.cfg.is_encoder_only:
            raise ValueError(f"{self.cfg.name} is an encoder: it has no decode "
                             "cache")

    def _lm_head(self, params):
        """(head (d, V or this rank's V/M columns), vocab-parallel?)."""
        name = "embed" if self.cfg.tie_embeddings else "lm_head"
        vocab = self._vocab(name)
        head = self._view(params, name, keep=vocab)
        return (head.T if name == "embed" else head), vocab

    def _mesh_mean(self, tot, cnt, aux):
        """A loss over the data ranks: its numerator this rank's, its
        denominator summed over them (a mean of means is wrong where masks
        differ), plus the balance loss averaged over them; the value summed
        over the data ranks, the backward this rank's share."""
        mc = self.mc
        loss = tot / torch.clamp(all_reduce(cnt, mc, mc.batch_axes), min=1.0)
        if aux is not None:
            loss = loss + AUX_WEIGHT * (aux / mc.data_size)
        return reduce_from(loss, mc, mc.batch_axes)

    # ----------------------------------------------------------------- loss
    def lm_loss(self, params, batch, *, impl: Optional[str] = None,
                chunk: int = 512, lora=None, lora_scale: float = 1.0):
        """Cross-entropy over the positions where ``batch["mask"]`` is set,
        the logits formed ``chunk`` positions at a time (never the whole
        (B, S, vocab) at once; one chunk when S is not a multiple).  A VLM's
        batch carries ``patches``, an encoder-decoder's ``frames``."""
        hidden, aux, _ = self._run(params, batch["tokens"], frames=batch.get("frames"),
                                   patches=batch.get("patches"), impl=impl, lora=lora,
                                   lora_scale=lora_scale, train=True)
        hidden = hidden[:, self.cfg.n_prefix_tokens:]    # text positions only
        rows = self._rows(batch["labels"].shape[0])
        labels, mask = self._local(batch["labels"], rows), self._local(batch["mask"], rows)
        s = hidden.shape[1]
        head, vocab = self._lm_head(params)
        chunk = min(chunk, s)
        if s % chunk:
            chunk = s
        tot = cnt = 0.0
        for c0 in range(0, s, chunk):
            lab = labels[:, c0:c0 + chunk]
            if vocab:
                terms = vocab_xent(hidden[:, c0:c0 + chunk], head, lab, self.mc)
            else:
                logits = (hidden[:, c0:c0 + chunk] @ head).float()
                logz = torch.logsumexp(logits, dim=-1)
                terms = logz - logits.gather(-1, lab[..., None].long())[..., 0]
            m = mask[:, c0:c0 + chunk].float()
            tot = tot + (terms * m).sum()
            cnt = cnt + m.sum()
        if self.mc is not None:
            return self._mesh_mean(tot, cnt, aux)
        return self._with_aux(tot / torch.clamp(cnt, min=1.0), aux)

    def cls_loss(self, params, batch, *, impl: Optional[str] = None,
                 lora=None, lora_scale: float = 1.0):
        """Encoder classifier (PFTT) on the first position → (loss, accuracy).
        An optional ``batch["valid"]`` (B,) sample weight (the padded rows of
        a ragged cohort, ``core.cohort.HostBatchStacker``) makes both the
        weighted means over the real rows."""
        hidden, aux, _ = self._run(params, batch["tokens"], impl=impl, lora=lora,
                                   lora_scale=lora_scale, train=True)
        logits = (hidden[:, 0] @ self._view(params, "cls_head")).float()
        rows = self._rows(batch["label"].shape[0])
        label = self._local(batch["label"], rows).long()
        logz = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, label[:, None])[:, 0]
        correct = (logits.argmax(-1) == label).float()
        w = self._local(batch.get("valid"), rows)
        if self.mc is not None:
            w = torch.ones_like(ll) if w is None else w.float()
            acc = all_reduce((correct * w).sum(), self.mc, self.mc.batch_axes)
            n = torch.clamp(all_reduce(w.sum(), self.mc, self.mc.batch_axes), min=1.0)
            return self._mesh_mean(((logz - ll) * w).sum(), w.sum(), aux), acc / n
        if w is None:
            return self._with_aux((logz - ll).mean(), aux), correct.mean()
        wsum = torch.clamp(w.sum(), min=1.0)
        return (self._with_aux(((logz - ll) * w).sum() / wsum, aux),
                (correct * w).sum() / wsum)

    def logits(self, params, hidden):
        """hidden (…, d) → f32 logits over the whole vocab (gathered over
        the model axis when the head is vocab-parallel)."""
        head, vocab = self._lm_head(params)
        out = (hidden @ head).float()
        return gather(out, self.mc, self.mc.model_axis, -1, sum_grad=False) if vocab else out

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
        builds plain caches).  Under a mesh: this rank's blocks of the
        cache of the whole ``batch`` (``sharding.cache_specs``), with
        ``specs`` and ``batch`` in the dict."""
        self._check_decoder()
        if self.mc is None:
            return self._alloc_cache(batch, cache_len, dtype, sparse_kv, self.device)
        meta = self._alloc_cache(batch, cache_len, dtype, sparse_kv, torch.device("meta"))
        specs = self._cache_specs(meta, batch)
        stages = trees.map_with_path(
            lambda p, t: torch.zeros(local_shape(t.shape, specs["stages/" + p], self.mc),
                                     dtype=t.dtype, device=self.device), meta["stages"])
        return {"pos": 0, "stages": stages, "specs": specs, "batch": batch}

    def _alloc_cache(self, batch, cache_len, dtype, sparse_kv, device):
        dtype = dtype or self.dtype
        if sparse_kv is None:
            sparse_kv = bool(self.opts.get("sparse_kv_seq"))
        return {"pos": 0, "stages": [
            None if self.cfg.is_encoder_decoder and stage.stream != "decoder" else
            [{n: torch.zeros((stage.repeats,) + shp, dtype=dt, device=device)
              for n, (shp, dt) in layer_cache_shape(self.cfg, kind, batch, cache_len,
                                                    dtype, sparse_kv).items()}
             for kind in stage.pattern]
            for stage in self.cfg.stages]}

    def _cache_specs(self, cache, batch: int) -> Dict[str, Spec]:
        """{"stages/si/pi/name": spec} of a cache of the whole ``batch``."""
        shapes = trees.map_leaves(
            lambda t: torch.empty((t.shape[0], batch) + tuple(t.shape[2:]), device="meta"),
            {"stages": cache["stages"]})
        return trees.flatten(cache_specs(self.mc, shapes, batch=batch))

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
        self._check_decoder()
        cache = self._alloc_cache(hidden.shape[0], cache_len, None, False, self.device)
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
        logits = self.logits(params, hidden[:, -1])
        if self.mc is None:
            return logits, cache
        # this rank's rows hold every position and head: cut its blocks
        b = tokens.shape[0]
        specs = self._cache_specs(cache, b)
        cache["stages"] = trees.map_with_path(
            lambda p, t: shard_leaf(t, Spec(*((None, None) + tuple(specs["stages/" + p])[2:])),
                                    self.mc), cache["stages"])
        cache.update(specs=specs, batch=b)
        return self._whole_rows(logits, self._rows(b)), cache

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
        rows = self.mc is not None and self._rows(cache["batch"])
        tokens = self._local(tokens, rows)
        positions = torch.full_like(tokens, pos)
        x = self._embed_tokens(params, tokens, positions)
        rot = self._rot(positions[0])
        for si, stage in enumerate(cfg.stages):
            if cache["stages"][si] is None:      # an encoder stage
                continue
            sp, lsp = params["stages"][si], self._lora_stage(lora, si)
            for r in range(stage.repeats):
                for pi, kind in enumerate(stage.pattern):
                    entry = _at(cache["stages"][si][pi], r)
                    flags = {}
                    if self.mc is not None:
                        flags = dict(rows=rows, sparse_kv="k_pers" in entry, cache_specs={
                            n: Spec(*tuple(cache["specs"][f"stages/{si}/{pi}/{n}"])[1:])
                            for n in entry})
                    lp, lf, tp = self._layer(sp, lsp, si, pi, kind, r, **flags)
                    x = apply_layer_decode(x, lp, kind, entry, pos, cfg, rot, impl=impl,
                                           lora=lf, lora_scale=lora_scale, opts=self.opts,
                                           tp=tp)
        x = apply_norm(x, self._view(params, "final_norm"), cfg.norm, cfg.norm_eps)
        cache["pos"] = pos + 1
        logits = self.logits(params, x[:, 0])
        return (logits if self.mc is None else self._whole_rows(logits, rows)), cache
