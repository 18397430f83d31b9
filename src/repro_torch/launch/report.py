"""Render a run-telemetry directory (``--telemetry-dir``) as a report: the
port's copy of ``repro.launch.report``, reading ``repro_torch.obs`` (the
schema is the same, so either package's report reads either's stream).

    PYTHONPATH=src python -m repro_torch.launch.report /tmp/telemetry

prints a per-round table (metric, comm bytes/delay/outages, staleness
counters, health scalars, host phase timings) from ``events.jsonl`` plus
a slowest-span summary (total host seconds per phase across the run, and
the single slowest round for each phase).  ``--check`` validates the
event stream against the schema (``repro_torch.obs.validate_events``) and
exits nonzero on any violation — the CI telemetry cell runs it after a
``--telemetry-dir`` training run.
"""
import argparse
import os
import sys

from repro_torch.obs import read_events, validate_events


def _fmt(v, width=9):
    if v is None:
        return "-".rjust(width)
    if isinstance(v, float):
        return f"{v:.4g}".rjust(width)
    return str(v).rjust(width)


def _wall_s(phases):
    # the "round" span (population runner) already contains
    # sample/gather/device-step/scatter/ledger — don't double-count the
    # nested children; eval runs outside it
    if "round" in phases:
        return phases["round"] + phases.get("eval", 0.0) \
            + phases.get("checkpoint", 0.0)
    return sum(phases.values())


def _metric_key(rounds):
    for k in ("acc", "reward", "eval_loss"):
        if rounds and k in rounds[0]:
            return k
    return None


def round_table(rounds):
    lines = []
    mk = _metric_key(rounds)
    head = (f"{'round':>5} {mk or 'metric':>9} {'bytes':>12} {'delay_s':>9} "
            f"{'outages':>7} {'pending':>7} {'retx':>6} {'health:loss':>11} "
            f"{'upd_norm':>9} {'host_s':>8}")
    lines.append(head)
    lines.append("-" * len(head))
    for e in rounds:
        comm = e.get("comm") or {}
        st = e.get("staleness") or {}
        h = e.get("health") or {}
        phases = (e.get("wall") or {}).get("phases") or {}
        lines.append(
            f"{e['round']:>5} {_fmt(e.get(mk))} "
            f"{_fmt(comm.get('bytes'), 12)} {_fmt(comm.get('delay_s'))} "
            f"{_fmt(comm.get('outages'), 7)} {_fmt(st.get('pending'), 7)} "
            f"{_fmt(st.get('retransmissions'), 6)} "
            f"{_fmt(h.get('loss_mean'), 11)} {_fmt(h.get('update_norm'))} "
            f"{_fmt(_wall_s(phases), 8)}")
    return "\n".join(lines)


def span_summary(rounds):
    totals, worst = {}, {}
    for e in rounds:
        for name, dur in ((e.get("wall") or {}).get("phases") or {}).items():
            totals[name] = totals.get(name, 0.0) + dur
            if name not in worst or dur > worst[name][1]:
                worst[name] = (e["round"], dur)
    if not totals:
        return "(no phase timings recorded)"
    lines = [f"{'phase':>12} {'total_s':>9} {'slowest_round':>13} "
             f"{'slowest_s':>9}"]
    lines.append("-" * len(lines[0]))
    for name, tot in sorted(totals.items(), key=lambda kv: -kv[1]):
        rnd, dur = worst[name]
        lines.append(f"{name:>12} {tot:>9.4f} {rnd:>13} {dur:>9.4f}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("telemetry_dir",
                    help="directory holding events.jsonl (a training run's "
                         "--telemetry-dir)")
    ap.add_argument("--check", action="store_true",
                    help="validate the event stream against the schema and "
                         "exit nonzero on any violation")
    args = ap.parse_args(argv)

    path = os.path.join(args.telemetry_dir, "events.jsonl")
    if not os.path.exists(path):
        print(f"report: no events.jsonl under {args.telemetry_dir}",
              file=sys.stderr)
        return 2
    events = read_events(path)
    errors = validate_events(events)

    run = next((e for e in events if e.get("event") == "run"), None)
    rounds = [e for e in events if e.get("event") == "round"]
    resumes = sum(1 for e in events if e.get("event") == "resume")
    ckpts = sum(1 for e in events if e.get("event") == "checkpoint")

    if run is not None:
        meta = ", ".join(f"{k}={v}" for k, v in
                         sorted((run.get("meta") or {}).items()))
        print(f"run: schema v{run.get('schema')} ({meta})")
    print(f"{len(rounds)} round(s), {ckpts} checkpoint(s), "
          f"{resumes} resume(s)\n")
    print(round_table(rounds))
    print("\nhost spans (slowest first):")
    print(span_summary(rounds))

    if args.check:
        if errors:
            print(f"\ncheck FAILED: {len(errors)} schema violation(s)",
                  file=sys.stderr)
            for err in errors:
                print(f"  - {err}", file=sys.stderr)
            return 1
        print(f"\ncheck OK: {len(events)} events, schema valid")
    elif errors:
        print(f"\nwarning: {len(errors)} schema violation(s) "
              f"(run with --check to fail on them)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
