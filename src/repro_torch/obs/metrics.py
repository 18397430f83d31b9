"""Schema-versioned JSONL run telemetry: the port's copy of
``repro.obs.metrics`` (the same schema, so ``launch/report.py --check`` of
either package accepts the other's stream; its test holds it against the
original).

One ``RunTelemetry`` per run writes ``events.jsonl`` under ``out_dir``:
one JSON object per line, append-only, flushed per event so a killed
run leaves a valid prefix.  Event types (``"event"`` key):

    run         first line of a fresh stream: schema version + run meta
    round       one per federated round — THE joined record: eval metric,
                CommLedger bits/delay/energy, StalenessTracker counters,
                sampler cohort ids, on-device health scalars, and the
                per-phase host timings under ``wall``
    checkpoint  a round-level checkpoint was persisted (after its round
                event — ordering is the exactly-once resume contract)
    resume      a run re-attached to this stream at ``start_round``
    compile     a compiled-dispatch warmup was observed (round 0 wall
                time includes compilation; this marks it)

Resume contract (mirrors the round-level checkpoint semantics): everything
volatile across identical replays — wall-clock timings, host phase
breakdowns — lives under the single reserved ``"wall"`` key of each
event.  ``canonical_stream`` strips ``wall`` and the lifecycle events
(run/checkpoint/resume/compile) and renders each round event as
canonical JSON; a killed-and-resumed run must reproduce the
uninterrupted run's canonical stream byte-for-byte.  ``resume()``
enforces the no-duplicates half: it drops any recorded events with
``round >= start_round`` (present when the kill landed between a round
event and its checkpoint) before appending continues.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 1

_LIFECYCLE = ("run", "checkpoint", "resume", "compile")
_EVENT_TYPES = _LIFECYCLE + ("round",)


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """What to record.  ``out_dir=None`` (via config default) disables
    everything; ``health`` additionally rides device-side training-health
    scalars on the fused round outputs (still one dispatch/round)."""

    out_dir: str
    trace: bool = False         # Chrome trace-event JSON (trace.json)
    torch_profile: bool = False  # device traces via torch.profiler
    health: bool = True         # on-device health scalars in round events


def _sanitize(obj):
    """NaN/Inf → None recursively: the stream must be strict JSON (an
    all-outage round has NaN delay_s in the ledger record)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return obj


def _dumps(ev: Dict) -> str:
    return json.dumps(_sanitize(ev), sort_keys=True, separators=(",", ":"))


class RunTelemetry:
    """JSONL event recorder.  ``out_dir=None`` → fully disabled (every
    method is a cheap no-op), so runners thread one object through
    unconditionally."""

    def __init__(self, out_dir: Optional[str] = None, tracer=None):
        self.out_dir = out_dir
        self.tracer = tracer
        self.enabled = out_dir is not None
        self.path = os.path.join(out_dir, "events.jsonl") if out_dir else None
        if self.enabled:
            os.makedirs(out_dir, exist_ok=True)

    # ---- low-level append --------------------------------------------------

    def _emit(self, ev: Dict) -> None:
        if not self.enabled:
            return
        line = _dumps(ev)
        # open-append-close per event: one line is one atomic-enough unit;
        # a kill mid-run leaves a valid JSONL prefix, never a torn stream.
        with open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())

    # ---- lifecycle ---------------------------------------------------------

    def start(self, run_meta: Optional[Dict] = None) -> None:
        """Begin a FRESH stream (truncates any stale file at this path)."""
        if not self.enabled:
            return
        with open(self.path, "w"):
            pass
        self._emit({"event": "run", "schema": SCHEMA_VERSION,
                    "meta": run_meta or {}})

    def resume(self, start_round: int, run_meta: Optional[Dict] = None) -> None:
        """Re-attach to an existing stream: keep the run event and all
        rounds < start_round, drop rounds >= start_round (recorded but
        not checkpointed before the kill), then mark the resume."""
        if not self.enabled:
            return
        kept: List[Dict] = []
        if os.path.exists(self.path):
            for ev in read_events(self.path):
                if ev.get("event") == "round" and ev.get("round", -1) >= start_round:
                    continue
                kept.append(ev)
        if not any(ev.get("event") == "run" for ev in kept):
            kept.insert(0, {"event": "run", "schema": SCHEMA_VERSION,
                            "meta": run_meta or {}})
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for ev in kept:
                f.write(_dumps(ev) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._emit({"event": "resume", "round": int(start_round),
                    "wall": {"meta": run_meta or {}}})

    def checkpoint(self, rnd: int) -> None:
        self._emit({"event": "checkpoint", "round": int(rnd)})

    def compile_event(self, rnd: int, seconds: float) -> None:
        self._emit({"event": "compile", "round": int(rnd),
                    "wall": {"seconds": float(seconds)}})

    # ---- the joined per-round record ---------------------------------------

    def round_event(self, rnd: int, data: Dict[str, Any],
                    wall: Optional[Dict[str, Any]] = None) -> None:
        """``data`` holds the replay-stable joined record (metric, comm,
        staleness, cohort, health); ``wall`` holds everything volatile."""
        if not self.enabled:
            return
        ev = dict(data)
        ev["event"] = "round"
        ev["round"] = int(rnd)
        ev["wall"] = wall or {}
        self._emit(ev)

    def close(self) -> None:
        """Dump the Chrome trace next to the event stream (if tracing)."""
        if self.enabled and self.tracer is not None and self.tracer.enabled:
            self.tracer.write(os.path.join(self.out_dir, "trace.json"))


# ---------------------------------------------------------------------------
# stream readers / validators (launch/report.py + tests)
# ---------------------------------------------------------------------------


def read_events(path: str) -> List[Dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def canonical_stream(events: List[Dict]) -> List[str]:
    """Round events only, ``wall`` stripped, canonical JSON — the byte
    sequence the kill/resume contract compares."""
    out = []
    for ev in events:
        if ev.get("event") != "round":
            continue
        ev = {k: v for k, v in ev.items() if k != "wall"}
        out.append(_dumps(ev))
    return out


def validate_events(events: List[Dict]) -> List[str]:
    """Schema check → list of human-readable problems (empty = valid)."""
    errs: List[str] = []
    if not events:
        return ["empty event stream"]
    head = events[0]
    if head.get("event") != "run":
        errs.append("first event is %r, expected 'run'" % head.get("event"))
    elif head.get("schema") != SCHEMA_VERSION:
        errs.append("schema version %r, expected %d"
                    % (head.get("schema"), SCHEMA_VERSION))
    seen_rounds: List[int] = []
    for i, ev in enumerate(events):
        kind = ev.get("event")
        if kind not in _EVENT_TYPES:
            errs.append("event %d: unknown type %r" % (i, kind))
            continue
        if kind == "round":
            if not isinstance(ev.get("round"), int):
                errs.append("event %d: round id missing" % i)
                continue
            r = ev["round"]
            if r in seen_rounds:
                errs.append("duplicate round %d" % r)
            if seen_rounds and r <= seen_rounds[-1]:
                errs.append("round %d out of order after %d"
                            % (r, seen_rounds[-1]))
            seen_rounds.append(r)
            for key in ("comm", "wall"):
                if key not in ev:
                    errs.append("round %d: missing %r" % (r, key))
    return errs
