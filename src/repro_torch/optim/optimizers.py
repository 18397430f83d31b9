"""Optimizers over trees of tensors: the port of ``repro.optim.optimizers``.

The same (init, update) convention and state trees as the JAX package::

    opt = adamw(lr_schedule, weight_decay=0.01)
    state = opt.init(params)                 # {"mu", "nu", "step"}
    updates, state = opt.update(grads, state, params)
    params = tree_add(params, updates)       # updates already include -lr

Moments are f32 whatever the parameter dtype.  A gradient leaf may be
``None`` (a leaf the loss does not reach, such as a LoRA enable mask under
its stop-gradient): it counts as zeros, as ``jax.grad`` returns them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import trees


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def value_and_grad(loss_fn: Callable, tree, *, has_aux: bool = False):
    """``jax.value_and_grad`` over a tree of tensors: ``loss_fn`` gets a
    tree of detached leaves that require grad; returns (detached loss,
    gradient tree of the same structure).  A leaf the loss does not reach
    gets ``None``, which the optimizers read as zeros.  With ``has_aux``
    ``loss_fn`` returns (loss, aux) and the result is ((loss, aux), grads),
    the aux detached."""
    flat = trees.flatten(tree)
    req = {p: v.detach().requires_grad_() for p, v in flat.items()}
    out = loss_fn(trees.map_with_path(lambda p, _: req[p], tree))
    loss, aux = out if has_aux else (out, None)
    grads = dict(zip(req, torch.autograd.grad(loss, list(req.values()),
                                              allow_unused=True)))
    grads = trees.map_with_path(lambda p, _: grads[p], tree)
    if has_aux:
        return (loss.detach(), trees.map_leaves(torch.Tensor.detach, aux)), grads
    return loss.detach(), grads


def _grads_like(grads, params):
    """``None`` gradient leaves → zeros of the parameter's shape (f32)."""
    return trees.map_leaves(
        lambda p, g: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if g is None else g, params, grads)


def global_norm(tree):
    sq = [g.float().square().sum() for g in trees.flatten(tree).values()]
    return torch.stack(sq).sum().sqrt()


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return trees.map_leaves(lambda g: g * scale.to(g.dtype), tree), norm


def _as_schedule(lr):
    return lr if callable(lr) else (lambda step: lr)


def adamw(lr, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0,
          update_mask: Optional[Callable[[str], bool]] = None) -> Optimizer:
    """AdamW with f32 moments and bias correction.  ``update_mask(path)``
    False → the leaf's update is zero (LoRA enable masks, frozen leaves);
    its moments still follow its gradient, as in the JAX package."""
    lr_fn = _as_schedule(lr)

    def init(params):
        zeros = trees.map_leaves(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            params)
        return {"mu": zeros, "nu": trees.map_leaves(torch.clone, zeros),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=_device(params))}

    def update(grads, state, params):
        grads = _grads_like(grads, params)
        step = state["step"] + 1
        lr_t = lr_fn(step)
        mu = trees.map_leaves(lambda m, g: b1 * m + (1 - b1) * g.float(),
                              state["mu"], grads)
        nu = trees.map_leaves(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                              state["nu"], grads)
        stepf = step.float()
        mu_hat_scale = 1.0 / (1 - b1 ** stepf)
        nu_hat_scale = 1.0 / (1 - b2 ** stepf)

        def upd(m, v, p):
            u = -(lr_t * (m * mu_hat_scale / (torch.sqrt(v * nu_hat_scale) + eps)
                          + weight_decay * p.float()))
            return u.to(p.dtype)

        updates = trees.map_leaves(upd, mu, nu, params)
        if update_mask is not None:
            updates = trees.map_with_path(
                lambda path, u: u if update_mask(path) else torch.zeros_like(u),
                updates)
        return updates, {"mu": mu, "nu": nu, "step": step}

    return Optimizer(init=init, update=update)


def sgd(lr, *, momentum: float = 0.0) -> Optimizer:
    lr_fn = _as_schedule(lr)

    def init(params):
        st = {"step": torch.zeros((), dtype=torch.int32, device=_device(params))}
        if momentum:
            st["m"] = trees.map_leaves(
                lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                params)
        return st

    def update(grads, state, params):
        grads = _grads_like(grads, params)
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if not momentum:
            return (trees.map_leaves(lambda g, p: (-lr_t * g.float()).to(p.dtype),
                                     grads, params), {"step": step})
        m = trees.map_leaves(lambda mm, g: momentum * mm + g.float(),
                             state["m"], grads)
        updates = trees.map_leaves(lambda mm, p: (-lr_t * mm).to(p.dtype), m, params)
        return updates, {"m": m, "step": step}

    return Optimizer(init=init, update=update)


def _device(tree):
    leaves = list(trees.flatten(tree).values())
    return leaves[0].device if leaves else None
