"""Training step builders: the port of ``repro.launch.steps``'s
``make_train_step`` and ``make_peft_step``.

* ``train_step`` — full fine-tuning: ``lm_loss`` → gradients of every
  leaf → AdamW (weight decay 0.01)
* ``peft_step``  — PFTT's local step: only the adapters and the LoRA
  factors get gradients; the base is frozen.  The factors go through the
  forward unmerged, so every targeted projection runs the ``lora_fused``
  kernel (its autograd Function on the card).

Each step is ``(state…, batch) → (new state…, loss)`` with the state as
trees of tensors; gradients come from ``optim.value_and_grad``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch import trees
from repro_torch.models import peft as peft_mod
from repro_torch.optim import adamw, value_and_grad


def make_train_step(model, lr: float = 1e-4, impl: Optional[str] = None):
    opt = adamw(lr, weight_decay=0.01)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(
            lambda p: model.lm_loss(p, batch, impl=impl), params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return trees.tree_add(params, updates), opt_state, loss

    return train_step, opt


def make_peft_loss(model, peft_cfg: peft_mod.PEFTConfig, impl: Optional[str] = None):
    """``loss(trainable, frozen, batch)`` of the PEFT step, trainable =
    {"adapters": subtree merged into ``frozen``, "lora": factor tree}."""
    scale = peft_mod.lora_scale(peft_cfg)

    def loss(trainable, frozen, batch):
        full = trees.merge(frozen, trainable["adapters"])
        return model.lm_loss(full, batch, impl=impl, lora=trainable["lora"],
                             lora_scale=scale)

    return loss


def make_peft_step(model, peft_cfg: peft_mod.PEFTConfig, lr: float = 1e-3,
                   impl: Optional[str] = None):
    """Paper-faithful PFTT local step over trainable = {adapters, lora}:
    ``peft_step(trainable, frozen, opt_state, batch)``."""
    opt = adamw(lr)
    loss_fn = make_peft_loss(model, peft_cfg, impl=impl)

    def peft_step(trainable, frozen, opt_state, batch):
        loss, grads = value_and_grad(
            lambda t: loss_fn(t, frozen, batch), trainable)
        updates, opt_state = opt.update(grads, opt_state, trainable)
        return trees.tree_add(trainable, updates), opt_state, loss

    return peft_step, opt
