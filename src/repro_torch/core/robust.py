"""Host-side runtime for the straggler-tolerant federated round: the port's
copy of ``repro.core.robust`` (numpy only; its test holds it against the
original).

The robust round step (``core/cohort.py`` with ``robust=True``) is
deliberately dumb: it consumes per-round fault masks and a pre-computed
aggregation weight vector, and carries the pending-payload buffer.  ALL the
bookkeeping that decides those inputs — which client has a payload on the
air, how stale it is, what the ``α·(1+s)^(-a)`` discount works out to, how
many bits the retransmission charges — is a pure function of host-known
quantities (fault masks + channel outage outcomes), so it lives here, on
the host, and the port's runs replay the JAX package's weights and ledger
charges exactly.

Per-round contract:

1. ``plan = tracker.begin_round(faults, outage_w)`` — ages the pending
   buffer, drops payloads staler than ``max_staleness``, decides who
   attempts an uplink (``tx`` clients holding a fresh or pending payload),
   who delivers (attempt minus channel outage), and folds the FedAsync
   discount ``α·(1+s)^(-a)`` into ``plan.agg_w``.
2. The round body runs with ``plan.train/agg_w/recv/rejoin``; training
   clients' fresh uploads supersede their pending payloads, stragglers
   retransmit the buffered one.
3. ``charged = tracker.end_round(plan, fresh_bits)`` — updates the buffer
   bookkeeping (fresh-but-undelivered payloads go pending at staleness 0;
   delivered or crash-dropped ones clear) and returns the per-client bit
   charge: fresh encode bits for training clients, the STORED encode bits
   for retransmitters (the payload on the air is the buffered one).

Silent clients (nothing on the air) are excluded from the round's channel
reports entirely — no bytes, no delay, no energy.

Under normalization the global ``α`` cancels out of
``fedavg_stacked``/``masked_fedavg_stacked`` (both divide by the weight
sum), so only the RELATIVE ``(1+s)^(-a)`` discount between fresh and stale
payloads matters; ``α`` is kept for parity with
``core/async_agg.StalenessWeightedAggregator`` and for the all-outage gate
semantics (``α > 0`` never flips the ``Σw > 0`` gate).

With the zero-fault plan every client trains and transmits every round, so
pending payloads are always superseded before they could retransmit,
staleness is identically zero, and ``agg_w`` equals the plain channel
outage weights — the robust round is then bitwise the synchronous round
for ANY ``max_staleness``.  ``max_staleness=0`` additionally makes the
robust engine drop failed uploads exactly like the synchronous engine even
under faults (a pending payload ages to 1 > 0 before its first retransmit
chance).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

from repro_torch.wireless.arrivals import ArrivalModel, DeadlineConfig
from repro_torch.wireless.faults import FaultPlan, RoundFaults


@dataclasses.dataclass(frozen=True)
class StalenessConfig:
    """Bounded-staleness aggregation knobs (FedAsync-style discounting).

    ``alpha``: global merge weight α (cancels under weight normalization —
    see module docstring).  ``a``: staleness exponent; 0 disables
    discounting (stale payloads merge at full weight).  ``max_staleness``:
    pending payloads older than this many rounds are dropped, not merged;
    0 reproduces the synchronous engine's drop-on-failure semantics."""
    alpha: float = 1.0
    a: float = 0.0
    max_staleness: int = 0

    def discount(self, staleness: np.ndarray) -> np.ndarray:
        return (self.alpha
                * (1.0 + staleness.astype(np.float64)) ** (-self.a)
                ).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """One round's resolved schedule (all (n_clients,) arrays).

    The continuous-time fields are only populated when the tracker runs
    with a ``DeadlineConfig`` (else they keep their inert defaults and the
    plan is exactly the round-granular one)."""
    train: np.ndarray      # float32 — client runs local steps
    recv: np.ndarray       # float32 — client receives the broadcast
    rejoin: np.ndarray     # float32 — crash rejoin (opt state reset)
    attempt: np.ndarray    # float32 — a payload goes on the air
    delivered: np.ndarray  # float32 — attempt survived channel + checksum +
                           #           deadline + quorum
    staleness: np.ndarray  # int64   — age of the payload on the air
    agg_w: np.ndarray      # float32 — delivered · α·(1+s)^(-a) (final,
                           #           quorum-aborted rounds are all-zero)
    # ---- continuous-time extras (deadline mode) --------------------------
    ontime: Optional[np.ndarray] = None    # f32 — arrival ≤ deadline (the
                                           # engine's deadline mask input)
    corrupt: Optional[np.ndarray] = None   # f32 — checksum-NACKed attempt
    agg_w_pre: Optional[np.ndarray] = None  # f32 — discount · delivered-
                                           # before-deadline/quorum (the
                                           # engine multiplies by ``ontime``
                                           # and applies the quorum gate
                                           # in-body; ``agg_w_pre · ontime``
                                           # == pre-quorum ``agg_w``)
    arrival_s: Optional[np.ndarray] = None  # f64 — scheduled arrival time
    tx_time_s: Optional[np.ndarray] = None  # f64 — scheduled airtime
    quorum_ok: bool = True                 # round met ``min_quorum``
    n_delivered: int = 0                   # deliveries before the quorum gate
    sim_dt_s: float = 0.0                  # simulated round duration


class StalenessTracker:
    """Pending-payload bookkeeping + staleness-discounted weight vector.

    Tracks, per client: whether the pending buffer holds a real payload
    (``valid``), how many rounds old it is (``age``), and the encoded bit
    size it was produced at (``bits`` — what a retransmission charges).
    The payload *contents* live device-side in the engine's pending buffer;
    the tracker only ever sees masks and sizes.

    With a ``DeadlineConfig`` + ``ArrivalModel`` the tracker additionally
    runs the continuous-time round (``wireless/arrivals.py``): per-client
    arrival times decide a deadline mask, failed attempts (outage, checksum
    NACK, deadline miss) retry under capped exponential backoff and are
    abandoned after ``max_retries``, and a round delivering fewer than
    ``min_quorum`` payloads is voided server-side (deliveries NACKed back
    to pending, no failure counted, no merge).  Passing ``deadline=None``
    is byte-for-byte the round-granular tracker."""

    def __init__(self, n_clients: int, cfg: Optional[StalenessConfig] = None,
                 *, deadline: Optional[DeadlineConfig] = None,
                 arrivals: Optional[ArrivalModel] = None):
        self.cfg = cfg or StalenessConfig()
        self.valid = np.zeros(n_clients, bool)
        self.age = np.zeros(n_clients, np.int64)
        self.bits = np.zeros(n_clients, np.float64)
        if deadline is not None and arrivals is None:
            raise ValueError("deadline mode needs an ArrivalModel")
        self.deadline = deadline
        self.arrivals = arrivals
        # continuous-time state (inert until a DeadlineConfig is set)
        self.fails = np.zeros(n_clients, np.int64)     # failed attempts of
        #                                              # the current payload
        self.next_try_s = np.zeros(n_clients, np.float64)  # backoff window
        self.now_s = 0.0                               # simulated clock
        self.quorum_noops = 0                          # voided rounds
        self.abandoned = 0                             # payloads given up
        self.retransmissions = 0                       # buffered re-sends

    def begin_round(self, faults: RoundFaults, outage_w: np.ndarray, *,
                    gains: Optional[np.ndarray] = None,
                    fresh_bits: Optional[np.ndarray] = None) -> RoundPlan:
        """Resolve the round schedule from the fault masks and the realized
        channel outage weights (1.0 delivered / 0.0 outage per client).

        Deadline mode additionally needs ``gains`` (the realized fading
        draws, dips included) and ``fresh_bits`` (the host-known encoded
        payload size each *training* client would put on the air — exact
        for uncompressed uploads, the previously realized encoded size for
        codec runs; retransmitters always use their buffered size)."""
        # payloads produced in an earlier round are one round staler now;
        # anything beyond the staleness bound is abandoned
        self.age[self.valid] += 1
        self.valid &= self.age <= self.cfg.max_staleness
        train = faults.train > 0
        if self.deadline is None:
            has_payload = train | self.valid    # fresh upload or buffered
            attempt = (faults.tx > 0) & has_payload
            # a corrupted payload fails its host-side checksum on delivery
            # and is NACKed exactly like an outage (never merged) — also in
            # the round-granular runtime (None for pre-corruption traces)
            corrupt = np.zeros(len(self.valid), bool) \
                if faults.corrupt is None else (faults.corrupt > 0)
            corrupt = corrupt & attempt
            self.retransmissions += int((attempt & ~train).sum())
            delivered = attempt & (np.asarray(outage_w) > 0) & ~corrupt
            staleness = np.where(train, 0, self.age)
            agg_w = np.where(delivered, self.cfg.discount(staleness), 0.0)
            return RoundPlan(
                train=train.astype(np.float32), recv=faults.recv.copy(),
                rejoin=faults.rejoin.copy(),
                attempt=attempt.astype(np.float32),
                delivered=delivered.astype(np.float32),
                staleness=staleness.astype(np.int64),
                agg_w=agg_w.astype(np.float32),
                corrupt=corrupt.astype(np.float32))

        # ---- continuous-time round ---------------------------------------
        dl = self.deadline
        if gains is None or fresh_bits is None:
            raise ValueError("deadline mode needs gains= and fresh_bits=")
        n = len(self.valid)
        # a buffered payload can only go back on the air once its backoff
        # window opens inside this round's deadline; fresh uploads replace
        # the pending payload and are never backoff-gated
        start_wait = np.maximum(self.next_try_s - self.now_s, 0.0)
        ready = start_wait < dl.deadline_s
        has_payload = train | (self.valid & ready)
        attempt = (faults.tx > 0) & has_payload
        self.retransmissions += int((attempt & ~train).sum())
        rates = self.arrivals.rates(gains)
        # drawn every round (fixed-size block → the RNG stream stays aligned
        # across runs and checkpoint resume)
        ct = self.arrivals.compute_times(faults.compute_scale)
        bits_on_air = np.where(train, np.asarray(fresh_bits, np.float64),
                               self.bits)
        start = np.where(train, ct, start_wait)
        tx_time = bits_on_air / rates
        arrival = start + tx_time
        ontime = arrival <= dl.deadline_s
        corrupt = np.zeros(n, bool) if faults.corrupt is None \
            else (faults.corrupt > 0)
        corrupt = corrupt & attempt
        clean = attempt & (np.asarray(outage_w) > 0) & ~corrupt
        delivered = clean & ontime
        staleness = np.where(train, 0, self.age)
        disc = self.cfg.discount(staleness)
        agg_w_pre = np.where(clean, disc, 0.0).astype(np.float32)
        agg_w = np.where(delivered, disc, 0.0).astype(np.float32)
        n_del = int(delivered.sum())
        quorum_ok = n_del >= dl.min_quorum
        if not quorum_ok:       # server aborts the round: nothing merges,
            delivered = np.zeros(n, bool)  # deliveries are NACKed back to
            agg_w = np.zeros(n, np.float32)  # pending (no failure counted)
        if math.isinf(dl.deadline_s):
            ok = clean
            sim_dt = float(arrival[ok].max()) if ok.any() else \
                (float(ct[train].max()) if train.any() else 0.0)
        else:
            sim_dt = float(dl.deadline_s)
        return RoundPlan(
            train=train.astype(np.float32), recv=faults.recv.copy(),
            rejoin=faults.rejoin.copy(), attempt=attempt.astype(np.float32),
            delivered=delivered.astype(np.float32),
            staleness=staleness.astype(np.int64), agg_w=agg_w,
            ontime=ontime.astype(np.float32),
            corrupt=corrupt.astype(np.float32), agg_w_pre=agg_w_pre,
            arrival_s=arrival, tx_time_s=tx_time,
            quorum_ok=quorum_ok, n_delivered=n_del, sim_dt_s=sim_dt)

    def end_round(self, plan: RoundPlan,
                  fresh_bits: np.ndarray) -> np.ndarray:
        """Advance the buffer bookkeeping after the round body ran; returns
        the per-client uplink bit charge (0 for silent clients).
        ``fresh_bits`` is the round's encoded payload size per client (only
        read for clients that trained)."""
        train = plan.train > 0
        delivered = plan.delivered > 0
        charged = np.where(plan.attempt > 0,
                           np.where(train, fresh_bits, self.bits), 0.0)
        # training clients overwrite their pending slot with the fresh
        # payload (staleness 0); it clears if it was delivered this round
        self.bits = np.where(train, fresh_bits, self.bits)
        self.age = np.where(train, 0, self.age)
        self.valid = np.where(train, ~delivered, self.valid & ~delivered)
        if self.deadline is not None:
            attempt = plan.attempt > 0
            # channel-caused failures only: a quorum-voided round counts no
            # failures and schedules no backoff (the abort is the server's)
            failed = attempt & ~delivered & plan.quorum_ok
            self.fails = np.where(train, 0, self.fails)   # fresh payload
            self.fails = np.where(failed, self.fails + 1, self.fails)
            self.fails = np.where(delivered, 0, self.fails)
            end_t = self.now_s + plan.sim_dt_s
            wait = self.arrivals.backoff_wait_s(self.fails)
            self.next_try_s = np.where(
                failed, end_t + wait,
                np.where(attempt | train, 0.0, self.next_try_s))
            # abandonment after max_retries failed retransmissions: the
            # payload (and its bit charge) drops out of the ledger for good
            exhausted = self.fails > self.deadline.max_retries
            self.abandoned += int((exhausted & self.valid).sum())
            self.valid &= ~exhausted
            self.bits = np.where(exhausted, 0.0, self.bits)
            self.fails = np.where(exhausted, 0, self.fails)
            self.next_try_s = np.where(exhausted, 0.0, self.next_try_s)
            if not plan.quorum_ok:
                self.quorum_noops += 1
            self.now_s = end_t
        rejoin = plan.rejoin > 0
        self.valid &= ~rejoin                   # crash drops the buffer
        self.fails = np.where(rejoin, 0, self.fails)
        self.next_try_s = np.where(rejoin, 0.0, self.next_try_s)
        return charged

    def counters(self) -> Dict[str, int]:
        """Telemetry snapshot: cumulative run counters + current buffer
        occupancy (feeds the ``staleness`` block of each round event)."""
        return {"pending": int(self.valid.sum()),
                "abandoned": int(self.abandoned),
                "retransmissions": int(self.retransmissions),
                "quorum_noops": int(self.quorum_noops)}

    # ---- checkpoint/resume ------------------------------------------------

    def state_dict(self) -> Dict:
        return {"valid": self.valid.astype(np.int64).tolist(),
                "age": self.age.tolist(), "bits": self.bits.tolist(),
                "fails": self.fails.tolist(),
                "next_try_s": self.next_try_s.tolist(),
                "now_s": self.now_s, "quorum_noops": self.quorum_noops,
                "abandoned": self.abandoned,
                "retransmissions": self.retransmissions}

    def load_state_dict(self, d: Dict) -> None:
        self.valid = np.asarray(d["valid"], np.int64).astype(bool)
        self.age = np.asarray(d["age"], np.int64)
        self.bits = np.asarray(d["bits"], np.float64)
        n = len(self.valid)
        self.fails = np.asarray(d.get("fails", np.zeros(n)), np.int64)
        self.next_try_s = np.asarray(d.get("next_try_s", np.zeros(n)),
                                     np.float64)
        self.now_s = float(d.get("now_s", 0.0))
        self.quorum_noops = int(d.get("quorum_noops", 0))
        self.abandoned = int(d.get("abandoned", 0))
        self.retransmissions = int(d.get("retransmissions", 0))


# ---- the runners' shared setup and ledger entries (port only: the JAX
# package repeats these in ``run_pftt`` and ``run_pfit``) --------------------

def robust_runtime(cfg, channel, n_clients: Optional[int] = None, *,
                   always: bool = False):
    """(deadline, trace, tracker) of a run with ``cfg``'s ``fault_plan``,
    ``deadline`` and staleness fields, over ``n_clients`` (default
    ``cfg.n_clients``; a population run passes its population): a non-inert
    deadline switches the tracker to the continuous-time round (with or
    without a fault plan); (None, None, None) for the synchronous round
    unless ``always`` (population mode runs the robust body every round)."""
    n = cfg.n_clients if n_clients is None else n_clients
    dl = cfg.deadline if (cfg.deadline is not None
                          and not cfg.deadline.is_inert()) else None
    if cfg.fault_plan is None and dl is None and not always:
        return None, None, None
    trace = (cfg.fault_plan or FaultPlan()).realize(n, cfg.rounds)
    arrivals = ArrivalModel(channel, dl, n) if dl is not None else None
    tracker = StalenessTracker(n, StalenessConfig(
        alpha=cfg.staleness_alpha, a=cfg.staleness_a,
        max_staleness=cfg.max_staleness), deadline=dl, arrivals=arrivals)
    return dl, trace, tracker


def round_reports(budget, plan: RoundPlan, charged, gains) -> list:
    """The round's channel reports, one per attempt (silent clients send
    nothing); the continuous-time round charges every attempt's airtime and
    books bytes only on delivery."""
    sent = [ci for ci in range(len(plan.attempt)) if plan.attempt[ci] > 0]
    if plan.tx_time_s is None:
        return [budget.report(charged[ci], gains[ci]) for ci in sent]
    return [budget.attempt_report(charged[ci], gains[ci],
                                  tx_time_s=float(plan.tx_time_s[ci]),
                                  arrival_s=float(plan.arrival_s[ci]),
                                  delivered=bool(plan.delivered[ci] > 0))
            for ci in sent]


def round_extra(plan: RoundPlan) -> Optional[Dict]:
    """The ledger's extra fields of a continuous-time round (None else)."""
    if plan.tx_time_s is None:
        return None
    return {"sim_dt_s": float(plan.sim_dt_s), "quorum_noop": not plan.quorum_ok,
            "n_delivered": int(plan.n_delivered),
            "corrupt": int(np.asarray(plan.corrupt).sum())}
