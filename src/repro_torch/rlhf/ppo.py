"""PPO for LM fine-tuning (paper §IV-C Step 3: update the unfrozen part of
the local LLM with PPO against the personalized reward): the port of
``repro.rlhf.ppo``.

Clipped PPO with GAE, a value head over the hidden states, and a per-token
KL penalty to the round's reference (global) policy.  The terminal reward
is the client's personalized reward (the double reward combination minus
the L2 pull toward the global model).  ``prep`` runs without gradients;
``step``'s forward carries them, so on the card causal ``flash_attn`` runs
through its autograd Function there.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import trees
from repro_torch.models.peft import apply_grad_mask
from repro_torch.optim import value_and_grad


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    gen_len: int = 24
    clip: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.001
    kl_coef: float = 0.05
    gamma: float = 1.0
    lam: float = 0.95
    temperature: float = 1.0
    ppo_epochs: int = 2


def seq_logprobs_values(model, params, tokens):
    """LM shift: the hidden state at position i scores token i+1.
    Returns logp (B, S-1), values (B, S-1), entropy (B, S-1)."""
    hidden, _ = model.forward(params, tokens[:, :-1])
    logits = model.logits(params, hidden)                  # (B, S-1, V) f32
    logall = torch.log_softmax(logits, dim=-1)
    logp = logall.gather(-1, tokens[:, 1:, None].long())[..., 0]
    ent = -(torch.exp(logall) * logall).sum(-1)
    # the value head reads a DETACHED trunk: the critic's regression must not
    # distort the policy's representation
    values = (hidden.detach().float() @ params["value_head"].float())[..., 0]
    return logp, values, ent


def gae(rewards, values, mask, gamma: float, lam: float):
    """rewards/values/mask (B, T) → (advantages, returns): the JAX scan over
    reversed time as a host loop over T."""
    v_next = torch.cat([values[:, 1:], torch.zeros_like(values[:, :1])], 1)
    adv = torch.empty_like(rewards)
    carry = torch.zeros_like(rewards[:, 0])
    for t in reversed(range(rewards.shape[1])):
        delta = rewards[:, t] + gamma * v_next[:, t] * mask[:, t] - values[:, t]
        carry = delta + gamma * lam * mask[:, t] * carry
        adv[:, t] = carry
    return adv, adv + values


def clipped_loss(model, cfg: PPOConfig, params, tokens, old_logp, adv, ret, resp_mask):
    """PPO's objective on a rollout batch: the clipped policy loss, plus
    ``vf_coef`` × the value regression, minus ``ent_coef`` × the entropy,
    each a mean over the response positions.  Returns (loss, (pg, vf, en))."""
    logp, values, ent = seq_logprobs_values(model, params, tokens)
    ratio = torch.exp(logp - old_logp)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv
    denom = resp_mask.sum()
    pg = -(torch.minimum(unclipped, clipped) * resp_mask).sum() / denom
    vf = (torch.square(values - ret) * resp_mask).sum() / denom
    en = (ent * resp_mask).sum() / denom
    return pg + cfg.vf_coef * vf - cfg.ent_coef * en, (pg, vf, en)


def make_ppo_fns(model, opt, cfg: PPOConfig, prompt_len: int):
    """The (prep, step) pair of one PPO round, as the JAX package's."""

    @torch.no_grad()
    def prep(params, ref_params, tokens, terminal_reward):
        t = tokens.shape[1] - 1
        resp_mask = (torch.arange(t, device=tokens.device)[None] >= prompt_len - 1).float()
        resp_mask = resp_mask.expand(tokens.shape[0], t)
        old_logp, old_values, _ = seq_logprobs_values(model, params, tokens)
        ref_logp, _, _ = seq_logprobs_values(model, ref_params, tokens)
        kl = old_logp - ref_logp
        rewards = -cfg.kl_coef * kl * resp_mask     # a new tensor: add in place
        rewards[:, -1] += terminal_reward
        adv, ret = gae(rewards, old_values, resp_mask, cfg.gamma, cfg.lam)
        # numpy's (population) std, as jnp.std
        adv = (adv - adv.mean()) / torch.clamp(adv.std(correction=0), min=1e-6)
        mean_kl = (kl * resp_mask).sum() / resp_mask.sum()
        return old_logp, adv, ret, resp_mask, mean_kl

    def step(params, opt_state, tokens, old_logp, adv, ret, resp_mask, grad_mask):
        (loss, auxes), grads = value_and_grad(
            lambda p: clipped_loss(model, cfg, p, tokens, old_logp, adv, ret, resp_mask),
            params, has_aux=True)
        if grad_mask is not None:
            grads = apply_grad_mask(grads, grad_mask)
        updates, opt_state = opt.update(grads, opt_state, params)
        return trees.tree_add(params, updates), opt_state, loss, auxes

    return prep, step


class PPOTrainer:
    def __init__(self, model, opt, cfg: PPOConfig, prompt_len: int):
        self.model = model
        self.opt = opt
        self.cfg = cfg
        self.prompt_len = prompt_len
        self._prep, self._step = make_ppo_fns(model, opt, cfg, prompt_len)

    def round(self, params, ref_params, opt_state, tokens, terminal_reward,
              grad_mask=None):
        """One PPO pass (``cfg.ppo_epochs`` clipped updates) over a rollout
        batch."""
        old_logp, adv, ret, resp_mask, mean_kl = self._prep(
            params, ref_params, tokens, terminal_reward)
        for _ in range(self.cfg.ppo_epochs):
            params, opt_state, loss, (pg, vf, en) = self._step(
                params, opt_state, tokens, old_logp, adv, ret, resp_mask, grad_mask)
        stats = {"loss": float(loss), "pg": float(pg), "vf": float(vf),
                 "entropy": float(en), "kl": float(mean_kl)}
        return params, opt_state, stats


def ppo_round(model, params, ref_params, opt, opt_state, rollout_tokens,
              prompt_len: int, terminal_reward, cfg: PPOConfig, grad_mask=None):
    """One-shot wrapper (tests): a trainer per call."""
    return PPOTrainer(model, opt, cfg, prompt_len).round(
        params, ref_params, opt_state, rollout_tokens, terminal_reward, grad_mask)
