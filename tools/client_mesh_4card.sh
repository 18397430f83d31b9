#!/usr/bin/env bash
# The client-sharded cohort over four cards: the launcher's PFTT cohort (8
# clients, 3 rounds) and the llama3.2-1b arch round (8 clients, 2 rounds,
# --assert-fused) in one process on card 0, then over a 4-rank NCCL client
# mesh started by torchrun (2 clients a rank).  Same seeds both ways: the
# final accuracy, round bytes and losses must agree; the round seconds
# compare one card with four.  Needs four NVIDIA GPUs; run from the repo root:
#
#     bash tools/client_mesh_4card.sh
set -e
export PYTHONPATH=src
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
A="--arch roberta-base --fl-clients 8 --fl-rounds 3"
L="--arch llama3.2-1b --fl-clients 8 --fl-rounds 2 --assert-fused --fl-dmodel 256"
echo "== one process, card 0: PFTT"
python -m repro_torch.launch.train $A 2>&1 | grep -E "final|round 0"
echo "== torchrun 4 ranks NCCL: PFTT"
python -m torch.distributed.run --standalone --nproc-per-node 4 \
    -m repro_torch.launch.train $A 2>&1 | grep -E "federated|final|round 0"
echo "== one process: arch round"
python -m repro_torch.launch.train $L 2>&1 | grep -E "arch=|oracle|asserted"
echo "== torchrun 4 ranks NCCL: arch round"
python -m torch.distributed.run --standalone --nproc-per-node 4 \
    -m repro_torch.launch.train $L 2>&1 | grep -E "universal|arch=|oracle|asserted"
