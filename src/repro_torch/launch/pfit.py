"""PFIT end-to-end launcher (paper §IV-C, Fig. 4), the port of
``examples/pfit_rlhf.py``: federated RLHF with the double reward model,
personalized reward functions, last-2-layer head-sparse updates, PPO local
optimization and masked aggregation over a Rayleigh uplink.  On the GPU by
default; ``--device cpu`` runs the kernels' plain versions:

    PYTHONPATH=src python -m repro_torch.launch.pfit --rounds 2 --clients 2 --device cpu
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.pfit import METHODS, PFITConfig, run_pfit


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--method", default="pfit", choices=METHODS)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--sparsity", type=float, default=0.4)
    ap.add_argument("--snr-db", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    res = run_pfit(PFITConfig(
        method=args.method, rounds=args.rounds, n_clients=args.clients,
        sparsity=args.sparsity, snr_db=args.snr_db, seed=args.seed,
        verbose=True, device=args.device))
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("reward_per_round", "round_records",
                                   "rollouts_round0", "eval_round0")}, indent=2))
    print("reward curve:", [round(r, 4) for r in res["reward_per_round"]])
    return res


if __name__ == "__main__":
    main()
