"""Scenario generators for population-scale wireless FL: the port's copy
of ``repro.wireless.scenarios`` (numpy only; its test holds it against the
original draw for draw).

A ``Scenario`` is a frozen, seeded *specification* of the cell the
population lives in; ``Scenario.realize(n_clients, rounds)`` expands it to
a ``ScenarioTrace`` — concrete per-client, per-round arrays — so a
population run is exactly reproducible across the fused engine, tests,
benchmarks, and checkpoint resume (the trace is a pure function of the
spec, never of consumption order).  Three independent axes compose:

* **non-IID data** (``alpha``): each client's label distribution is a
  Dirichlet(α) draw over the task's classes (paper §V-B.2 at population
  scale).  ``alpha=inf`` (the default) is IID — every client samples
  classes uniformly.  The draw lives in ``ScenarioTrace.class_probs``
  ((n_clients, n_classes)); the data layer samples each client's batches
  from it.
* **availability** (``avail``): per-round participation probability.
  ``diurnal`` gives each client a phase-shifted sinusoid (devices cycle
  through day/night reachability, as the cross-device FL literature
  models); ``periodic`` is a hard duty-cycled on/off window.  The trace
  carries both the probability (``avail_p`` — what availability-weighted
  *sampling* uses) and the seeded realization (``avail`` 0/1 — a sampled
  but unavailable client behaves like a dropout fault for the round).
* **mobility** (``mobility="waypoint"``): clients move through the cell
  under the random-waypoint model; distance to the base station maps to a
  path-loss gain ``(ref_m / max(d, ref_m))^pathloss_exp`` that multiplies
  the round's Rayleigh draw — exactly like ``FaultPlan``'s SNR dips, so
  the realized SNR (and therefore outage, Shannon rate, and the
  continuous-time ``ArrivalModel``'s arrival clock) follows the
  trajectory.  Cell-edge clients fade, returning clients recover.

The trace deliberately stays channel-independent (it scales gains; outage
and rate decisions remain ``RayleighChannel``'s) and fault-independent
(an injected ``FaultPlan`` composes on top: masks AND, gain scales
multiply).

Spec grammar (``Scenario.from_spec`` — the ``--scenario`` launch flag):
``k=v`` pairs separated by commas, or a path to a JSON file of
``to_dict`` fields, e.g.::

    alpha=0.1,avail=diurnal,avail_period=8,mobility=waypoint,seed=3

Unknown keys raise (same contract as ``FaultPlan.from_spec``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Optional

import numpy as np

AVAIL_KINDS = ("none", "diurnal", "periodic")
MOBILITY_KINDS = ("none", "waypoint")


@dataclasses.dataclass(frozen=True)
class ScenarioTrace:
    """Realized per-client scenario arrays.

    ``class_probs`` is (n_clients, n_classes); the per-round arrays are
    (rounds, n_clients).  ``round(r)`` clamps past the planned horizon to
    the benign state (available, unit gain) so longer runs keep going."""
    class_probs: np.ndarray   # (n, n_classes) per-client label distribution
    avail_p: np.ndarray       # (rounds, n) availability probability
    avail: np.ndarray         # (rounds, n) seeded 0/1 realization
    gain_scale: np.ndarray    # (rounds, n) mobility path-loss multiplier

    @property
    def rounds(self) -> int:
        return self.avail.shape[0]

    @property
    def n_clients(self) -> int:
        return self.avail.shape[1]

    def avail_probs(self, r: int) -> np.ndarray:
        if r >= self.rounds:
            return np.ones(self.n_clients, np.float64)
        return self.avail_p[r]

    def avail_round(self, r: int) -> np.ndarray:
        if r >= self.rounds:
            return np.ones(self.n_clients, np.float32)
        return self.avail[r]

    def gain_round(self, r: int) -> np.ndarray:
        if r >= self.rounds:
            return np.ones(self.n_clients, np.float32)
        return self.gain_scale[r]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Seeded population-scenario specification; ``realize`` makes it a
    ``ScenarioTrace``.  ``Scenario()`` is the inert scenario: IID data,
    always-available clients, static unit-gain geometry."""
    alpha: float = math.inf      # Dirichlet label concentration (inf = IID)
    n_classes: int = 4
    avail: str = "none"          # none | diurnal | periodic
    avail_period: float = 24.0   # rounds per availability cycle
    avail_duty: float = 0.5      # periodic: fraction of the cycle online
    avail_min: float = 0.05      # diurnal: floor probability (never 0 —
                                 # availability-weighted sampling stays
                                 # well-defined for every client)
    mobility: str = "none"       # none | waypoint
    cell_m: float = 500.0        # square cell edge, base station centered
    speed_mps: float = 1.5       # random-waypoint speed
    round_s: float = 60.0        # simulated seconds of motion per round
    ref_m: float = 100.0         # path-loss reference distance (unit gain)
    pathloss_exp: float = 3.0
    seed: int = 0

    def __post_init__(self):
        if self.avail not in AVAIL_KINDS:
            raise ValueError(f"avail must be one of {AVAIL_KINDS}, "
                             f"got {self.avail!r}")
        if self.mobility not in MOBILITY_KINDS:
            raise ValueError(f"mobility must be one of {MOBILITY_KINDS}, "
                             f"got {self.mobility!r}")

    def is_inert(self) -> bool:
        return (math.isinf(self.alpha) and self.avail == "none"
                and self.mobility == "none")

    def has_availability(self) -> bool:
        return self.avail != "none"

    # ---- realization -------------------------------------------------------

    def realize(self, n_clients: int, rounds: int) -> ScenarioTrace:
        # one independent RNG stream per axis: enabling one axis never
        # perturbs another's draws, AND each axis's per-round draws are
        # prefix-stable in ``rounds`` (a run re-realized with a longer
        # horizon reproduces the shorter run's rows — the kill/resume and
        # extend-the-run contracts depend on it)
        def stream(tag):
            return np.random.RandomState((self.seed * 0x9E3779B1 + tag)
                                         & 0xFFFFFFFF)

        class_probs = self._realize_class_probs(n_clients, stream(1))
        avail_p, avail = self._realize_availability(n_clients, rounds,
                                                    stream(2))
        gain_scale = self._realize_mobility(n_clients, rounds, stream(3))
        return ScenarioTrace(class_probs=class_probs, avail_p=avail_p,
                             avail=avail, gain_scale=gain_scale)

    def _realize_class_probs(self, n: int, rng) -> np.ndarray:
        if math.isinf(self.alpha):
            return np.full((n, self.n_classes), 1.0 / self.n_classes,
                           np.float64)
        return rng.dirichlet([self.alpha] * self.n_classes, size=n)

    def _realize_availability(self, n: int, rounds: int, rng):
        phase = rng.rand(n)           # drawn even when avail="none" (stream
        u = rng.rand(rounds, n)       # stability across spec edits)
        if self.avail == "none":
            p = np.ones((rounds, n), np.float64)
        else:
            t = np.arange(rounds, dtype=np.float64)[:, None] \
                / max(self.avail_period, 1e-9) + phase[None, :]
            if self.avail == "diurnal":
                p = self.avail_min + (1.0 - self.avail_min) \
                    * 0.5 * (1.0 + np.sin(2.0 * np.pi * t))
            else:                      # periodic: hard duty-cycle window
                p = (np.mod(t, 1.0) < self.avail_duty).astype(np.float64)
                p = np.maximum(p, self.avail_min)
        return p, (u < p).astype(np.float32)

    def _realize_mobility(self, n: int, rounds: int, rng) -> np.ndarray:
        if self.mobility == "none":
            return np.ones((rounds, n), np.float32)
        # random waypoint in a square cell, base station at the center:
        # each client walks toward its waypoint at speed·round_s per round
        # and redraws the waypoint on arrival
        half = self.cell_m / 2.0
        pos = rng.uniform(-half, half, size=(n, 2))
        wp = rng.uniform(-half, half, size=(n, 2))
        step = self.speed_mps * self.round_s
        gain = np.ones((rounds, n), np.float32)
        for r in range(rounds):
            d = np.linalg.norm(pos, axis=1)
            gain[r] = (self.ref_m
                       / np.maximum(d, self.ref_m)) ** self.pathloss_exp
            vec = wp - pos
            dist = np.linalg.norm(vec, axis=1)
            arrive = dist <= step
            move = np.divide(vec, np.maximum(dist, 1e-9)[:, None]) * step
            pos = np.where(arrive[:, None], wp, pos + move)
            # redraw every client's next waypoint each round (fixed-size
            # block keeps the stream stable); only arrivals consume theirs
            nxt = rng.uniform(-half, half, size=(n, 2))
            wp = np.where(arrive[:, None], nxt, wp)
        return gain

    # ---- serialization (launch flags, benchmark manifests) ----------------

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "Scenario":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown Scenario fields {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        return cls(**d)

    @classmethod
    def from_spec(cls, spec: Optional[str]) -> Optional["Scenario"]:
        """``None``/""/"none" → no scenario; a JSON file path; or an inline
        ``k=v,k=v`` string, e.g. ``alpha=0.1,avail=diurnal,seed=3``
        (``alpha=inf`` parses)."""
        if spec is None or spec == "" or spec == "none":
            return None
        if os.path.exists(spec):
            with open(spec) as f:
                return cls.from_dict(json.load(f))
        d: Dict = {}
        for item in spec.split(","):
            k, sep, v = item.partition("=")
            if not sep:
                raise ValueError(f"bad scenario item {item!r} "
                                 "(want key=value)")
            k = k.strip()
            if k in ("avail", "mobility"):
                d[k] = v.strip()
            elif k in ("n_classes", "seed"):
                d[k] = int(v)
            else:
                d[k] = float(v)
        return cls.from_dict(d)
