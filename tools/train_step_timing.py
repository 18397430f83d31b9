#!/usr/bin/env python3
"""Times the full-width roberta-base PEFT training step on one NVIDIA GPU.

    python3 tools/train_step_timing.py [--steps 30] [--remat] [--label NAME]

Runs ``launch/train.py``'s ``Trainer`` at ``chip_smoke.py``'s TRAIN-ROBERTA
settings (12 layers, d 768; adapters plus rank-8 LoRA on wq/wv, MLM loss,
batch 16, sequence 128, f32, seed 0), five warm-up steps, then ``--steps``
steps, each ended by ``torch.cuda.synchronize``; ``--remat`` builds
``Model(remat=True)``, as ``launch.train --steps`` does.  Prints one JSON
line: the median step ms on the host clock and its quartiles, min and max,
the peak of ``torch.cuda.max_memory_allocated`` over the timed steps, and
the median forward and backward ms of five more steps on CUDA events.  ``repro_torch`` is imported from
``PYTHONPATH`` where that names a tree, so one script times two trees in
one call; otherwise from this checkout's ``src``.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(os.path.join(ROOT, "src"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("train_step_timing: CUDA is not available")
    import repro_torch
    from repro_torch import trees
    from repro_torch.launch import train

    tr = train.Trainer(train.parse_args(["--arch", "roberta-base", "--batch", "16",
                                         "--seq", "128", "--lora-rank", "8"]),
                       remat=args.remat)
    rng = np.random.RandomState(0)
    batches = [tr.to_device(tr.batch(rng)) for _ in range(5 + args.steps)]
    step_ms = []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.step(b)
        torch.cuda.synchronize()
        if i >= 5:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 4:
            torch.cuda.reset_peak_memory_stats()
    peak = torch.cuda.max_memory_allocated()
    fwd, bwd = [], []
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        leaves = {p: v.detach().requires_grad_() for p, v in trees.flatten(tr.trainable).items()}
        t = trees.map_with_path(lambda p, _: leaves[p], tr.trainable)
        ev[0].record()
        loss = tr.loss(t, batches[-1])
        ev[1].record()
        torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        ev[2].record()
        ev[2].synchronize()
        fwd.append(ev[0].elapsed_time(ev[1]))
        bwd.append(ev[1].elapsed_time(ev[2]))
    print(json.dumps({"label": args.label, "package": os.path.dirname(repro_torch.__file__),
                      "remat": args.remat, "steps": len(step_ms),
                      "median_step_ms": float(np.median(step_ms)),
                      "step_ms_quartiles": [float(q) for q in np.percentile(step_ms, [25, 75])],
                      "step_ms_min_max": [float(min(step_ms)), float(max(step_ms))],
                      "max_memory_allocated_mib": peak / 2**20,
                      "forward_ms": float(np.median(fwd)), "backward_ms": float(np.median(bwd))}),
          flush=True)


if __name__ == "__main__":
    main()
