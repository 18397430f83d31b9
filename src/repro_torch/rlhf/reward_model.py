"""Reward models (paper §IV-C: the double reward model for helpfulness and
safety): the port of ``repro.rlhf.reward_model``.

A reward model is a small causal transformer with a scalar head over the
masked mean of its hidden states.  Training is the Bradley–Terry pairwise
ranking loss on pairs ordered by the corpus's ground-truth latent scores,
the synthetic stand-in for the paper's human rankers.  On the card its
forward runs causal ``flash_attn`` once a layer, and training carries the
gradient through the kernel's autograd Function.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import trees
from repro_torch.configs.base import LK, ModelConfig, Stage
from repro_torch.data.synthetic import VOCAB
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw, value_and_grad


def reward_model_config(d_model: int = 128, n_layers: int = 2) -> ModelConfig:
    return ModelConfig(
        name="reward-model",
        family="dense",
        d_model=d_model,
        n_heads=4,
        n_kv_heads=4,
        head_dim=d_model // 4,
        d_ff=4 * d_model,
        vocab_size=VOCAB,
        stages=(Stage((LK("attn", "mlp"),), repeats=n_layers),),
        act="gelu",
        norm="ln",
        pos="learned",
        max_position=1024,
        tie_embeddings=True,
    )


@dataclasses.dataclass
class RewardModel:
    model: Model
    params: dict

    @classmethod
    def create(cls, generator: torch.Generator, d_model: int = 128,
               n_layers: int = 2, device=None) -> "RewardModel":
        """Random parameters drawn on the CPU from ``generator``, the scalar
        head ~ N(0, 1/d)."""
        cfg = reward_model_config(d_model, n_layers)
        model = Model(cfg, device=device)
        params = model.init(generator)
        head = torch.randn(cfg.d_model, 1, generator=generator) * cfg.d_model ** -0.5
        params["reward_head"] = head.to(model.device)
        return cls(model=model, params=params)

    def score(self, params, tokens, mask):
        """tokens (B, S), mask (B, S) → scalar scores (B,) f32."""
        hidden, _ = self.model.forward(params, tokens)
        m = mask[..., None].to(hidden.dtype)
        pooled = (hidden * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
        return (pooled @ params["reward_head"])[:, 0].float()


def train_reward_model(rm: RewardModel, samples: dict, target: str, *,
                       steps: int = 300, batch: int = 32, lr: float = 3e-4):
    """Bradley–Terry training: pairs ranked by the ground truth
    ``samples[target]`` (``help`` or ``safe``), drawn from numpy
    ``RandomState(0)`` as in the JAX package.  Returns the trained params
    and {"bt_loss": last loss, "pair_acc": accuracy on 256 fresh pairs}."""
    device = rm.model.device
    tokens = samples["tokens"]
    mask = samples["mask"] if "mask" in samples else np.ones_like(tokens, np.float32)
    gt = samples[target]
    n = len(tokens)
    opt = adamw(lr)
    opt_state = opt.init(rm.params)
    params = rm.params
    rng = np.random.RandomState(0)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    last = 0.0
    for _ in range(steps):
        i = rng.randint(0, n, size=batch)
        j = rng.randint(0, n, size=batch)
        swap = gt[i] < gt[j]
        wi, li = np.where(swap, j, i), np.where(swap, i, j)
        tw, mw, tl, ml = put(tokens[wi]), put(mask[wi]), put(tokens[li]), put(mask[li])
        loss, g = value_and_grad(
            lambda p: -F.logsigmoid(rm.score(p, tw, mw) - rm.score(p, tl, ml)).mean(),
            params)
        updates, opt_state = opt.update(g, opt_state, params)
        params = trees.tree_add(params, updates)
        last = loss

    # pair accuracy on fresh pairs
    i = rng.randint(0, n, size=256)
    j = rng.randint(0, n, size=256)
    with torch.no_grad():
        si = rm.score(params, put(tokens[i]), put(mask[i])).cpu().numpy()
        sj = rm.score(params, put(tokens[j]), put(mask[j])).cpu().numpy()
    valid = gt[i] != gt[j]
    acc = float((((si > sj) == (gt[i] > gt[j])) & valid).sum() / max(valid.sum(), 1))
    return params, {"bt_loss": float(last), "pair_acc": acc}
