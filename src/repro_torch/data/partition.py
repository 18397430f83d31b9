"""Non-IID client partitioning (paper §V-B.2: Dirichlet split of AG-News).

The port's copy of ``repro.data.partition`` (numpy only); its test holds it against
the original draw for draw.
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0):
    """Partition sample indices so each client's class distribution is a
    Dirichlet(alpha) draw.  Returns list of index arrays."""
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    out = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for client, chunk in enumerate(np.split(idx, cuts)):
            out[client].extend(chunk.tolist())
    return [np.asarray(sorted(v)) for v in out]


def client_topic_preferences(n_clients: int, n_topics: int, sharpness: float,
                             seed: int = 0):
    """Per-client topic distributions for the instruction corpus (each client
    concentrated on a few topics → personalized instruction data)."""
    rng = np.random.RandomState(seed)
    return rng.dirichlet([sharpness] * n_topics, size=n_clients)
