"""Serving launcher: prefill + batched KV-cached decode with a per-client
LoRA kept unmerged (personalized serving), on the GPU by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \
        --batch 8 --prompt-len 128 --gen 64 --lora-rank 8

Every projection with factors runs the fused LoRA kernel, prefill attention
the flash kernel (the block-sparse kernel for ``build(args, impl="sparse")``)
and decode attention the flash-decode kernel; a Mamba-2 config
(``--arch mamba2-1.3b``) runs its scan through the SSD chunk kernel.  The
arch zoo serves the same way: GQA with rotary positions (``--arch
llama3.2-1b``), gemma3's sliding-window ring caches, internvl2 (random
patch embeddings drawn before the prompts, as the JAX launcher draws them,
projected into the first positions), MoE (dbrx), the attention + Mamba +
MoE hybrid (jamba), deepseek-v2's MLA (prefill through the flash kernel at
q/k 192, v 128; absorbed decode over the latent cache) and whisper's
encoder-decoder (random post-conv frames drawn first, as the JAX launcher
draws them; the encoder runs once in prefill, and each decode step
cross-attends to its cached k/v through the flash-decode kernel).  With
``--device cpu`` the same path runs the kernels' plain PyTorch versions.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --batch 8 --prompt-len 512 --gen 64 --lora-rank 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
        --batch 8 --prompt-len 64 --gen 64 --lora-rank 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device, synchronize
from repro_torch.configs import get_config, list_configs
from repro_torch.models import peft as peft_mod
from repro_torch.models.transformer import Model


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--lora-rank", type=int, default=0,
                    help="serve with a random personalized LoRA (PFTT mode)")
    ap.add_argument("--lora-merge", action="store_true",
                    help="bake the LoRA into the base weights (default serves "
                         "it unmerged through the fused LoRA kernel)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def build(args, *, impl: str = "auto", cfg=None, opts=None):
    """→ (model, params, lora, lora_scale, prompts, patches, frames) for the
    parsed args (``patches`` None but for a VLM, ``frames`` (B, S_enc, d)
    None but for an encoder-decoder; numpy ``RandomState(0)`` draws frames,
    then patches, then the prompts, as the JAX launcher); ``impl`` and
    ``opts`` go to ``Model`` ("sparse": the config's block-sparse
    attention); ``cfg`` replaces the arch's config (another reduced
    variant or a cut)."""
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    if cfg.is_encoder_only:
        raise SystemExit("encoder-only architectures have no decode path")
    model = Model(cfg, device=device, impl=impl, opts=opts)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, max_seq=args.prompt_len + args.gen)
    lora, lscale = None, 1.0
    if args.lora_rank:
        pc = peft_mod.PEFTConfig(lora_rank=args.lora_rank)
        lora = peft_mod.init_lora(gen, params, pc)
        lscale = peft_mod.lora_scale(pc)
        if args.lora_merge:
            params = peft_mod.apply_lora(params, lora, pc)
            lora = None
    rng = np.random.RandomState(0)
    patches = frames = None
    if cfg.is_encoder_decoder:
        frames = torch.from_numpy(rng.randn(args.batch, cfg.encoder_seq,
                                            cfg.d_model).astype(np.float32)).to(device)
    if cfg.n_prefix_tokens:
        patches = torch.from_numpy(rng.randn(args.batch, cfg.n_prefix_tokens,
                                             cfg.prefix_dim).astype(np.float32)).to(device)
    prompts = torch.from_numpy(rng.randint(
        6, cfg.vocab_size, size=(args.batch, args.prompt_len))).to(device)
    return model, params, lora, lscale, prompts, patches, frames


def cache_len(model, prompts, gen: int) -> int:
    """Cache positions a generation needs: a VLM's prefix, the prompt and
    ``gen`` steps."""
    return model.cfg.n_prefix_tokens + prompts.shape[1] + gen


def generate(model, params, prompts, gen: int, *, lora=None,
             lora_scale: float = 1.0, patches=None, frames=None):
    """Greedy decoding: prefill (after a VLM's ``patches``; an
    encoder-decoder's ``frames`` through its encoder), then ``gen``
    decode steps, each feeding the previous step's argmax.  Returns
    {"tokens" (B, gen), "logits" (list of gen + 1 (B, vocab) tensors: the
    prefill's, then each step's), "prefill_s", "decode_s"}.  The loop never
    reads a device value back."""
    device = prompts.device
    synchronize(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompts, cache_len(model, prompts, gen),
                                  patches=patches, frames=frames, lora=lora,
                                  lora_scale=lora_scale)
    synchronize(device)
    t1 = time.perf_counter()
    out, all_logits = [], [logits]
    for _ in range(gen):
        nxt = logits.argmax(-1, keepdim=True)
        out.append(nxt)
        logits, cache = model.decode_step(params, cache, nxt, lora=lora,
                                          lora_scale=lora_scale)
        all_logits.append(logits)
    synchronize(device)
    t2 = time.perf_counter()
    return {"tokens": torch.cat(out, 1), "logits": all_logits,
            "prefill_s": t1 - t0, "decode_s": t2 - t1}


def main(argv=None):
    args = parse_args(argv)
    model, params, lora, lscale, prompts, patches, frames = build(args)
    if lora is not None:
        print(f"serving UNMERGED client LoRA (rank {args.lora_rank}, fused "
              "LoRA kernel): base stays shared")
    elif args.lora_rank:
        print(f"serving with merged client LoRA (rank {args.lora_rank})")
    res = generate(model, params, prompts, args.gen, lora=lora, lora_scale=lscale,
                   patches=patches, frames=frames)
    print(f"prefill: {res['prefill_s'] * 1e3:.2f} ms "
          f"({args.batch}×{args.prompt_len} tokens, {model.device})")
    print(f"decode: {args.gen} steps in {res['decode_s']:.3f} s "
          f"→ {args.batch * args.gen / res['decode_s']:.1f} tok/s")
    print("sample:", res["tokens"][0, :16].tolist())
    return res


if __name__ == "__main__":
    main()
