"""Nested host span tracer → Chrome trace-event JSON (Perfetto-loadable):
the port's copy of ``repro.obs.trace`` (its test holds ``SpanTracer``
against the original).

One ``SpanTracer`` instance per run.  ``with tracer.span("gather"):``
times a host phase; spans nest naturally (a ``span`` opened inside
another span renders as its child in Perfetto, because complete-"X"
events on one track nest by time containment).  The tracer ALWAYS times
— even disabled it accumulates per-phase durations, which is how
``PopulationRunner`` keeps its ``host_s``/``round_s`` accounting and how
the telemetry round events get their ``wall.phases`` breakdown — but it
only *records* Chrome trace events when ``enabled=True``, so the
disabled tracer costs two ``perf_counter`` calls and a dict add per
span.

Span-name convention (used by every runner; see docs/observability.md):

    round        whole-round wrapper (population runner)
    sample       cohort sampling (population) / host batch draw (cohort)
    plan         StalenessTracker round plan (population)
    gather       store gather + global overlay + host-to-device copy /
                 batch stack
    encode       the codec's per-client uniform hooks (host side of the
                 compressed uplink)
    device-step  the round step, ended by ``repro_torch.synchronize`` so
                 the span times the device
    scatter      device→store writeback + global snapshot
    ledger       channel reports + CommLedger append
    eval         fused cohort eval dispatch
    checkpoint   round-level checkpoint save

``chrome_trace()``/``write()`` emit the standard
``{"traceEvents": [...]}`` JSON object format: load the file in
https://ui.perfetto.dev (or chrome://tracing) directly.

``torch_profile_start``/``torch_profile_stop`` bracket the run with
``torch.profiler`` (CUDA activity on the card, CPU activity when the run
was asked onto the CPU) and write its Chrome trace under the telemetry
directory.  Unlike the JAX package's best-effort bracket, a profiler that
fails to start raises: ``torch.profiler`` always exists, and a silent
no-op would hide that the trace is missing.
"""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Dict, List


class Span:
    """Handle yielded by ``SpanTracer.span``: ``dur`` (seconds) is set
    when the ``with`` block exits."""

    __slots__ = ("name", "start", "dur")

    def __init__(self, name: str, start: float):
        self.name = name
        self.start = start
        self.dur = 0.0


class SpanTracer:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._t0 = time.perf_counter()
        self._events: List[Dict] = []
        self._depth = 0
        self._round_acc: Dict[str, float] = {}   # since last pop_round()
        self._total_acc: Dict[str, float] = {}   # whole run

    @contextmanager
    def span(self, name: str, **args):
        start = time.perf_counter()
        sp = Span(name, start)
        self._depth += 1
        try:
            yield sp
        finally:
            end = time.perf_counter()
            self._depth -= 1
            sp.dur = end - start
            self._round_acc[name] = self._round_acc.get(name, 0.0) + sp.dur
            self._total_acc[name] = self._total_acc.get(name, 0.0) + sp.dur
            if self.enabled:
                ev = {"name": name, "ph": "X", "pid": os.getpid(), "tid": 1,
                      "ts": (start - self._t0) * 1e6, "dur": sp.dur * 1e6}
                if args:
                    ev["args"] = args
                self._events.append(ev)

    # ---- per-round / whole-run accounting ---------------------------------

    def pop_round(self) -> Dict[str, float]:
        """Per-span-name seconds accumulated since the last call (the
        telemetry round event's ``wall.phases``) — and reset."""
        out = {k: float(v) for k, v in self._round_acc.items()}
        self._round_acc = {}
        return out

    def totals(self) -> Dict[str, float]:
        """Whole-run per-span-name seconds (never reset)."""
        return {k: float(v) for k, v in self._total_acc.items()}

    # ---- Chrome trace-event JSON ------------------------------------------

    def chrome_trace(self) -> Dict:
        return {"traceEvents": list(self._events), "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        """Atomic write (tmp + replace) so a kill mid-dump never leaves a
        truncated trace next to a valid event stream."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.chrome_trace(), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)


# ---------------------------------------------------------------------------
# torch.profiler bracket (device-side traces)
# ---------------------------------------------------------------------------


def torch_profile_start(device):
    """Start a ``torch.profiler.profile`` over ``device``'s activity (CUDA
    on the card, CPU on the CPU) and return it; raises when it cannot
    start."""
    from torch.profiler import ProfilerActivity, profile
    act = ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU
    prof = profile(activities=[act])
    prof.__enter__()
    return prof


def torch_profile_stop(prof, out_dir: str) -> str:
    """Stop ``prof`` and write its Chrome trace to
    ``<out_dir>/torch_profile/trace.json``; returns the path."""
    prof.__exit__(None, None, None)
    path = os.path.join(out_dir, "torch_profile", "trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    return path


# ---------------------------------------------------------------------------
# a runner's observability (the port's runners share it)
# ---------------------------------------------------------------------------


def open_run(telemetry, device, write: bool = True):
    """(tracer, ``RunTelemetry``, health on, profiler or None) of a run
    with ``telemetry`` (an ``obs.TelemetryConfig``, or None: a tracer that
    still times, a telemetry that writes nothing, no health).  ``write``
    False (a sharded run's ranks but 0): health as configured, nothing
    written, no profiler."""
    from repro_torch.obs.metrics import RunTelemetry
    write = write and bool(telemetry)
    tracer = SpanTracer(enabled=bool(write and telemetry.trace))
    tele = RunTelemetry(telemetry.out_dir if write else None, tracer=tracer)
    prof = torch_profile_start(device) if (write and telemetry.torch_profile) else None
    return tracer, tele, bool(telemetry and telemetry.health), prof


def close_run(telemetry, tele, prof) -> None:
    """Stop the profiler (writing its trace) and write ``trace.json``."""
    if prof is not None:
        torch_profile_stop(prof, telemetry.out_dir)
    tele.close()
