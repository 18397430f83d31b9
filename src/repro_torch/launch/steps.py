"""Step builders, the port of ``repro.launch.steps``: the programs a
launcher runs.

* ``train_step``    — full fine-tuning: ``lm_loss`` → gradients of every
  leaf → AdamW (weight decay 0.01)
* ``peft_step``     — PFTT's local step: only the adapters and the LoRA
  factors get gradients; the base is frozen.  The factors go through the
  forward unmerged, so every targeted projection runs the ``lora_fused``
  kernel (its autograd Function on the card).
* ``prefill_step``  — the prompt forward and the decode cache
* ``serve_step``    — one decode token against the cache
* ``fl_round_step`` — one PFTT round as one program: the adapters are
  shared (no client axis) and the LoRA is per client (a leading client
  axis, never reduced); the loss is the mean of the clients' losses, so
  the adapters' gradient is the clients' mean (the server's aggregation)
  and each client's factors get their own.

Each training step is ``(state…, batch) → (new state…, loss)`` with the
state as trees of tensors; gradients come from ``optim.value_and_grad``.
Under a (data, model) mesh (a model built with ``meshctx``) the state is
this rank's blocks, the batch the whole one (each rank runs its rows), and
``model.sync_grads`` sums over the data ranks the gradients of leaves
replicated over them before AdamW, which then updates the local blocks:
each model rank holds the full gradient of what it stores.
``make_peft_step`` and ``make_fl_round_step`` take the JAX package's
``factored`` switch: False merges the factors into the weights before the
loss (``peft.apply_lora``, the merged oracle: plain matmuls, no
``lora_fused`` launch).  ``make_input_batch_shapes`` (alias ``input_specs``)
gives a batch's shapes as ``meta`` tensors, which hold no storage.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import trees
from repro_torch.models import peft as peft_mod
from repro_torch.optim import adamw, value_and_grad


def make_input_batch_shapes(cfg, shape, dtype=torch.bfloat16):
    """Stand-ins (``meta`` tensors) for one global batch of ``shape``
    (``configs.InputShape``): a VLM's text is ``seq_len`` less its prefix,
    beside the ``patches``; an encoder-decoder adds its ``frames``."""
    b, s = shape.global_batch, shape.seq_len

    def meta(dims, dt):
        return torch.empty(dims, dtype=dt, device="meta")

    if cfg.n_prefix_tokens:
        s = s - cfg.n_prefix_tokens
    batch = {"tokens": meta((b, s), torch.int32),
             "labels": meta((b, s), torch.int32),
             "mask": meta((b, s), dtype)}
    if cfg.n_prefix_tokens:
        batch["patches"] = meta((b, cfg.n_prefix_tokens, cfg.prefix_dim), dtype)
    elif cfg.is_encoder_decoder:
        batch["frames"] = meta((b, cfg.encoder_seq, cfg.d_model), dtype)
    return batch


def input_specs(cfg, shape, dtype=torch.bfloat16):
    """Alias of ``make_input_batch_shapes`` (the JAX package's name)."""
    return make_input_batch_shapes(cfg, shape, dtype)


def make_train_step(model, lr: float = 1e-4, impl: Optional[str] = None):
    opt = adamw(lr, weight_decay=0.01)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(
            lambda p: model.lm_loss(p, batch, impl=impl), params)
        updates, opt_state = opt.update(model.sync_grads(grads), opt_state, params)
        return trees.tree_add(params, updates), opt_state, loss

    return train_step, opt


def _lora_loss(model, peft_cfg: peft_mod.PEFTConfig, impl, factored: bool):
    """``loss(params, lora, batch)``: the factors threaded unmerged, or
    (``factored=False``) merged into ``params`` first."""
    scale = peft_mod.lora_scale(peft_cfg)

    def loss(params, lora, batch):
        if factored:
            return model.lm_loss(params, batch, impl=impl, lora=lora, lora_scale=scale)
        return model.lm_loss(peft_mod.apply_lora(params, lora, peft_cfg), batch, impl=impl)

    return loss


def make_peft_loss(model, peft_cfg: peft_mod.PEFTConfig, impl: Optional[str] = None,
                   factored: bool = True):
    """``loss(trainable, frozen, batch)`` of the PEFT step, trainable =
    {"adapters": subtree merged into ``frozen``, "lora": factor tree}."""
    loss = _lora_loss(model, peft_cfg, impl, factored)
    return lambda trainable, frozen, batch: loss(
        trees.merge(frozen, trainable["adapters"]), trainable["lora"], batch)


def make_peft_step(model, peft_cfg: peft_mod.PEFTConfig, lr: float = 1e-3,
                   impl: Optional[str] = None, factored: bool = True):
    """Paper-faithful PFTT local step over trainable = {adapters, lora}:
    ``peft_step(trainable, frozen, opt_state, batch)``; ``factored=False``
    the merged oracle."""
    opt = adamw(lr)
    loss_fn = make_peft_loss(model, peft_cfg, impl=impl, factored=factored)

    def peft_step(trainable, frozen, opt_state, batch):
        loss, grads = value_and_grad(
            lambda t: loss_fn(t, frozen, batch), trainable)
        updates, opt_state = opt.update(model.sync_grads(grads), opt_state, trainable)
        return trees.tree_add(trainable, updates), opt_state, loss

    return peft_step, opt


def make_prefill_step(model, cache_len: int, impl: Optional[str] = None,
                      lora_scale: float = 1.0):
    """``prefill_step(params, batch, lora=None)`` → (last-token logits,
    cache): the optional LoRA tree rides the factored path through the
    prompt (never merged); a batch's ``frames``/``patches`` go to the
    encoder and the prefix."""
    def prefill_step(params, batch, lora=None):
        return model.prefill(params, batch["tokens"], cache_len,
                             frames=batch.get("frames"), patches=batch.get("patches"),
                             impl=impl, lora=lora, lora_scale=lora_scale)
    return prefill_step


def make_serve_step(model, impl: Optional[str] = None, lora_scale: float = 1.0):
    """``serve_step(params, cache, tokens, lora=None)`` → (logits, cache):
    one factored decode step, the client's LoRA kept rank-r."""
    def serve_step(params, cache, tokens, lora=None):
        return model.decode_step(params, cache, tokens, impl=impl, lora=lora,
                                 lora_scale=lora_scale)
    return serve_step


def make_fl_round_step(model, peft_cfg: peft_mod.PEFTConfig, n_clients: int,
                       lr: float = 1e-3, impl: Optional[str] = None, factored: bool = True):
    """One federated PFTT round as one step: ``fl_round_step(trainable,
    frozen, opt_state, batch)`` with trainable = {"adapters": the shared
    subtree (no client axis), "lora": the per-client factors (leading
    ``n_clients`` axis)} and batch leaves with a leading client axis.  The
    loss is the mean of the clients' losses, each client's forward run in
    turn (a loop, not ``torch.func.vmap``: the kernels' CUDA ops have no
    vmap rule), so the adapters' gradient is the mean of the clients' and
    each client's factors get only their own.  ``factored=False`` merges
    each client's factors into its own copy of the weights (the oracle)."""
    opt = adamw(lr)
    client_loss = _lora_loss(model, peft_cfg, impl, factored)

    def fl_round_step(trainable, frozen, opt_state, batch):
        def loss_fn(t):
            full = trees.merge(frozen, t["adapters"])
            losses = [client_loss(full, trees.map_leaves(lambda x, c=ci: x[c], t["lora"]),
                                  {k: v[ci] for k, v in batch.items()})
                      for ci in range(n_clients)]
            return torch.stack(losses).mean()
        loss, grads = value_and_grad(loss_fn, trainable)
        updates, opt_state = opt.update(model.sync_grads(grads), opt_state, trainable)
        return trees.tree_add(trainable, updates), opt_state, loss

    return fl_round_step, opt
