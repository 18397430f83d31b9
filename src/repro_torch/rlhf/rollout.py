"""Autoregressive rollout for PPO: the port of ``repro.rlhf.rollout``.  It
reuses the serving path (``Model.prefill``, then one ``decode_step`` a
token against the KV cache), so a rollout on the card runs causal
``flash_attn`` once a layer, ``decode_attn`` once a layer and step, and
``lora_fused`` on every projection with factors.

Sampling is ``jax.random.categorical``'s: token = argmax(g + logits / T)
with g standard Gumbel noise of shape (B, vocab).  The noise comes from a
hook, ``noise(step) -> (B, vocab)``, so a run can be driven by any stream:
``gumbel_stream`` draws it from a CPU ``torch.Generator`` per stream (the
card and the CPU then sample from the same noise), and parity tests pass
the JAX package's own ``jax.random.gumbel`` draws.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

Noise = Callable[[int], torch.Tensor]


def _stream_seed(seed: int, stream: int) -> int:
    """One 32-bit generator seed per (run seed, stream), as the JAX package
    folds ``stream`` into ``PRNGKey(seed)``."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(1)[0])


def gumbel_stream(seed: int, stream: int, gen_len: int, batch: int, vocab: int,
                  device) -> Noise:
    """The noise hook of one stream: all ``gen_len`` steps of (batch, vocab)
    standard Gumbel noise, -log(-log(u)) with u uniform on [tiny, 1) in f32,
    drawn at once on the CPU and copied to ``device``."""
    g = torch.Generator().manual_seed(_stream_seed(seed, stream))
    u = torch.rand((gen_len, batch, vocab), generator=g)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    buf = (-torch.log(-torch.log(u))).to(device)
    return lambda step: buf[step]


@torch.no_grad()
def generate(model, params, prompts, gen_len: int, noise: Noise, *,
             temperature: float = 1.0, lora=None, lora_scale: float = 1.0,
             margins: Optional[list] = None):
    """prompts (B, P) int → tokens (B, P + gen_len) of the prompts' dtype.

    Fixed-length generation (EOS is handled by the reward masks
    downstream): a prefill with a cache of P + gen_len positions, then
    ``gen_len`` decode steps, the last one's logits unused as in the JAX
    scan.  ``lora`` serves a personalized client unmerged.  ``margins``
    (a list) receives, per step, the (B,) gap between the two highest
    scores g + logits / T, how near each sample was to a tie."""
    b, p = prompts.shape
    logits, cache = model.prefill(params, prompts, cache_len=p + gen_len,
                                  lora=lora, lora_scale=lora_scale)
    toks = []
    for t in range(gen_len):
        score = noise(t) + logits / temperature
        tok = score.argmax(-1, keepdim=True)
        if margins is not None:
            top = score.topk(2, dim=-1).values
            margins.append(top[:, 0] - top[:, 1])
        toks.append(tok)
        logits, cache = model.decode_step(params, cache, tok.to(prompts.dtype),
                                          lora=lora, lora_scale=lora_scale)
    return torch.cat([prompts, torch.cat(toks, 1).to(prompts.dtype)], 1)
