"""Generic federated training loop (the port of ``repro.fl.rounds``)."""
from __future__ import annotations

from typing import Callable, Optional, Sequence


def run_rounds(server, clients: Sequence, *, rounds: int, local_steps: int,
               eval_fn: Optional[Callable] = None, verbose: bool = False):
    """eval_fn(clients) → scalar metric, recorded per round."""
    history = []
    for rnd in range(rounds):
        for c in clients:
            c.local_epoch(local_steps)
        server.round(clients)
        if eval_fn is not None:
            m = eval_fn(clients)
            history.append(m)
            if verbose:
                print(f"round {rnd}: {m:.4f}")
    return history
