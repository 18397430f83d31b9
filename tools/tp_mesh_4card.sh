#!/usr/bin/env bash
# The (data, model) tensor-parallel mesh over four cards: llama3.2-1b at
# full width cut to 2 layers, 3 AdamW steps of launch.train --steps (batch
# 4, seq 128, full fine-tuning, lr 1e-4 as chip_smoke.py's TP phase), in
# one process on card 0 and then as a (2, 2) mesh of 4 NCCL ranks started
# by torchrun (one card a rank).  Same seeds both ways: it fails unless
# the losses agree within 1e-4 and every checkpointed parameter within
# 2e-4, chip_smoke.py's limit for the elements AdamW leaves open (it moves
# an element whose gradient is near zero by up to lr a step on rounding
# alone; the rest agree to about 1e-6).  --report gives each step's
# seconds (the first is the process's first) and each rank's peak device
# memory.  Needs four NVIDIA GPUs; run from the repo root:
#
#     bash tools/tp_mesh_4card.sh [OUT_DIR]
set -e
export PYTHONPATH=src
OUT=${1:-experiments/tp4}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
A="--arch llama3.2-1b --depth 2 --steps 3 --batch 4 --seq 128 --lr 1e-4"
echo "== one process, card 0"
python -m repro_torch.launch.train $A --ckpt "$OUT/one.npz" --report "$OUT/one.json"
echo "== torchrun 4 ranks NCCL, (2, 2)"
python -m torch.distributed.run --standalone --nproc-per-node 4 \
    -m repro_torch.launch.train $A --data-axis 2 --ckpt "$OUT/tp.npz" --report "$OUT/tp.json"
python - "$OUT" <<'PY'
import json, sys
import numpy as np
out = sys.argv[1]
one, tp = (json.load(open(f"{out}/{n}.json")) for n in ("one", "tp"))
a, b = np.load(f"{out}/one.npz"), np.load(f"{out}/tp.npz")
assert sorted(a.files) == sorted(b.files)
err = max(float(np.abs(a[k] - b[k]).max()) for k in a.files)
loss_err = max(abs(x - y) for x, y in zip(one["losses"], tp["losses"]))
print(json.dumps({"losses": [one["losses"], tp["losses"]], "loss_max_abs_err": loss_err,
                  "step_s": [one["step_s"], tp["step_s"]],
                  "max_memory_allocated": [one["max_memory_allocated"], tp["max_memory_allocated"]],
                  "param_max_abs_err": err}))
if loss_err > 1e-4 or err > 2e-4:
    sys.exit(f"the (2, 2) run differs from one process: losses {loss_err:.3e}, "
             f"parameters {err:.3e}")
PY
