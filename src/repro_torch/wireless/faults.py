"""Seeded fault injection for the federated runtime (paper §VI-1: wireless
clients fade, stall, and drop mid-round).

A ``FaultPlan`` is a frozen, seeded *specification* of client failure rates;
``FaultPlan.realize(n_clients, rounds)`` expands it into a ``FaultTrace`` —
concrete per-round, per-client availability arrays — so every failure mode
is exactly reproducible across the cohort engine, its tests and the JAX
package's runs.

Failure modes (per client, per round; priority crash > straggle > dropout):

* **dropout** — the client misses the round entirely: no local training, no
  uplink, no broadcast received.  One round, memoryless.
* **straggle-by-k** — the client's round-``r`` local update takes ``1+k``
  round-times to compute + deliver: it trains at round ``r``, stays busy
  (no training, no uplink) through ``r+1 … r+k-1``, and its round-``r``
  payload goes on the air at round ``r+k`` with staleness ``k``.  The
  bounded-staleness engine merges it with the ``α·(1+k)^(-a)`` discount;
  the synchronous engine would have gated the whole cohort on it.
* **crash-and-rejoin** — the client disappears for ``d`` rounds (no train /
  tx / recv; any pending payload is lost) and rejoins from the current
  broadcast global with freshly zeroed optimizer state.
* **SNR dip** — the client's Rayleigh gain is scaled down by ``dip_db`` for
  the round; deep dips push the realized SNR below
  ``RayleighChannel.outage_snr_db`` and trigger the retransmission path.
* **corruption** — the client's delivered payload is corrupted in transit
  for the round: the server's checksum rejects it, the delivery is NACKed
  into the retransmission path and never merged.  Memoryless per round,
  like dropout; only observable on rounds the client actually puts a
  payload on the air.

The trace deliberately stays *channel-independent*: it scales the fading
gains (``gain_scale``) and gates the uplink (``tx``), but outage decisions
remain ``RayleighChannel``'s — the same plan replays identically under any
channel seed.

The port's copy of ``repro.wireless.faults`` (numpy only); its test holds it
against the original draw for draw.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class RoundFaults:
    """One round's realized fault state (all (n_clients,) float32 arrays;
    1.0 = yes).  ``gain_scale`` multiplies the round's Rayleigh draws."""
    train: np.ndarray        # client runs local steps this round
    tx: np.ndarray           # client may put a payload on the air
    recv: np.ndarray         # client receives the broadcast global
    rejoin: np.ndarray       # client rejoins after a crash (reset opt state,
                             # drop pre-crash pending payload)
    gain_scale: np.ndarray   # multiplies the Rayleigh |h|² draw (SNR dips)
    # the two continuous-time fields default to None (= no corruption,
    # unit compute scale) so round-granular consumers and hand-built
    # RoundFaults keep working unchanged
    corrupt: Optional[np.ndarray] = None       # payload corrupted in transit
    compute_scale: Optional[np.ndarray] = None  # straggle factor for the
                                               # compute-time draw (1 + k on
                                               # straggle rounds)


@dataclasses.dataclass(frozen=True)
class FaultTrace:
    """Realized per-round, per-client availability arrays (all
    (rounds, n_clients); see ``RoundFaults`` for per-field semantics)."""
    train: np.ndarray
    tx: np.ndarray
    recv: np.ndarray
    rejoin: np.ndarray
    gain_scale: np.ndarray
    corrupt: Optional[np.ndarray] = None
    compute_scale: Optional[np.ndarray] = None

    @property
    def rounds(self) -> int:
        return self.train.shape[0]

    @property
    def n_clients(self) -> int:
        return self.train.shape[1]

    def round(self, r: int) -> RoundFaults:
        """Clamp past the planned horizon to fault-free (long runs keep
        going; the plan covers the rounds it was realized for)."""
        if r >= self.rounds:
            n = self.n_clients
            one = np.ones((n,), np.float32)
            return RoundFaults(train=one, tx=one, recv=one,
                               rejoin=np.zeros((n,), np.float32),
                               gain_scale=one.copy(),
                               corrupt=np.zeros((n,), np.float32),
                               compute_scale=one.copy())
        return RoundFaults(
            train=self.train[r], tx=self.tx[r],
            recv=self.recv[r], rejoin=self.rejoin[r],
            gain_scale=self.gain_scale[r],
            corrupt=None if self.corrupt is None else self.corrupt[r],
            compute_scale=(None if self.compute_scale is None
                           else self.compute_scale[r]))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded fault specification; ``realize`` makes it a ``FaultTrace``.

    Rates are per-client, per-round probabilities.  ``FaultPlan()`` is the
    zero-fault plan (every mask all-ones — the parity baseline)."""
    dropout_p: float = 0.0
    straggle_p: float = 0.0
    max_straggle: int = 3        # straggle lag k ~ uniform{1..max_straggle}
    crash_p: float = 0.0
    max_crash: int = 4           # crash length d ~ uniform{1..max_crash}
    snr_dip_p: float = 0.0
    snr_dip_db: float = 20.0     # gain scaled by 10^(-dip/10) on dip rounds
    corrupt_p: float = 0.0       # payload corrupted in transit (checksum NACK)
    seed: int = 0

    def is_zero(self) -> bool:
        return (self.dropout_p == 0 and self.straggle_p == 0
                and self.crash_p == 0 and self.snr_dip_p == 0
                and self.corrupt_p == 0)

    def realize(self, n_clients: int, rounds: int) -> FaultTrace:
        rng = np.random.RandomState(self.seed)
        shape = (rounds, n_clients)
        train = np.ones(shape, np.float32)
        tx = np.ones(shape, np.float32)
        recv = np.ones(shape, np.float32)
        rejoin = np.zeros(shape, np.float32)
        gain_scale = np.ones(shape, np.float32)
        corrupt = np.zeros(shape, np.float32)
        compute_scale = np.ones(shape, np.float32)

        # per-client state machines, advanced round-major so a fixed seed
        # yields one canonical trace regardless of the consumer
        busy = np.zeros(n_clients, np.int64)     # straggle rounds remaining
        down = np.zeros(n_clients, np.int64)     # crash rounds remaining
        for r in range(rounds):
            # one draw block per round keeps the stream layout stable
            u_crash = rng.rand(n_clients)
            d_crash = rng.randint(1, self.max_crash + 1, n_clients)
            u_strag = rng.rand(n_clients)
            k_strag = rng.randint(1, self.max_straggle + 1, n_clients)
            u_drop = rng.rand(n_clients)
            u_dip = rng.rand(n_clients)
            # the corruption block is only drawn when the mode is enabled,
            # so a plan without it replays the trace it had before the mode
            # existed
            u_corr = rng.rand(n_clients) if self.corrupt_p > 0 else None
            if u_corr is not None:
                corrupt[r] = (u_corr < self.corrupt_p).astype(np.float32)
            for c in range(n_clients):
                if u_dip[c] < self.snr_dip_p:
                    gain_scale[r, c] = 10.0 ** (-self.snr_dip_db / 10.0)
                if down[c] > 0:                      # mid-crash
                    down[c] -= 1
                    train[r, c] = tx[r, c] = recv[r, c] = 0.0
                    if down[c] == 0:                 # rejoin THIS round:
                        rejoin[r, c] = 1.0           # resync from global,
                        recv[r, c] = 1.0             # train again next round
                    continue
                if busy[c] > 0:                      # mid-straggle
                    busy[c] -= 1
                    train[r, c] = 0.0
                    # still computing → nothing on the air until done; on
                    # the delivery round the client is back online (tx its
                    # stale payload, recv the broadcast)
                    still = busy[c] > 0
                    tx[r, c] = 0.0 if still else 1.0
                    recv[r, c] = 0.0 if still else 1.0
                    continue
                if u_crash[c] < self.crash_p:        # crash starts
                    down[c] = int(d_crash[c])
                    train[r, c] = tx[r, c] = recv[r, c] = 0.0
                    continue
                if u_strag[c] < self.straggle_p:     # straggle starts: train
                    busy[c] = int(k_strag[c])        # now, deliver at r+k
                    tx[r, c] = 0.0
                    # continuous-time view of the same event: the local
                    # update takes 1+k round-times of compute
                    compute_scale[r, c] = 1.0 + float(k_strag[c])
                    continue
                if u_drop[c] < self.dropout_p:       # plain missed round
                    train[r, c] = tx[r, c] = recv[r, c] = 0.0
        return FaultTrace(train=train, tx=tx, recv=recv, rejoin=rejoin,
                          gain_scale=gain_scale, corrupt=corrupt,
                          compute_scale=compute_scale)

    # ---- serialization (launch flags, benchmark manifests) ----------------

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "FaultPlan":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown FaultPlan fields {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        return cls(**d)

    @classmethod
    def from_spec(cls, spec: Optional[str]) -> Optional["FaultPlan"]:
        """Parse a CLI spec: ``None``/"none" → no plan; a path to a JSON
        file of ``to_dict`` fields; or an inline ``k=v,k=v`` string, e.g.
        ``dropout_p=0.3,straggle_p=0.2,max_straggle=4,seed=1``."""
        if spec is None or spec == "" or spec == "none":
            return None
        if os.path.exists(spec):
            with open(spec) as f:
                return cls.from_dict(json.load(f))
        d: Dict = {}
        for item in spec.split(","):
            k, _, v = item.partition("=")
            if not _:
                raise ValueError(f"bad fault-plan item {item!r} "
                                 "(want key=value)")
            k = k.strip()
            d[k] = (int(v) if k in ("max_straggle", "max_crash", "seed")
                    else float(v))
        return cls.from_dict(d)
