"""Schema checks for exported observability artifacts (a copy of
``repro.obs.check``).

Validates (1) a Chrome-trace JSON file against the subset of the Trace
Event Format the tracer emits — required keys, monotonic ``ts``,
matched ``B``/``E`` pairs per thread, matched async ``b``/``e`` pairs
per (cat, id) — and (2) a Prometheus text exposition file, optionally
requiring sample coverage for a set of subsystem namespaces.

CLI (exit 1 on a bad artifact)::

    python -m repro_torch.obs.check trace.json metrics.prom \\
        --require-subsystems engine,scheduler,paging,dispatch,autotune

Library use: :func:`validate_chrome_trace` / :func:`validate_metrics`
raise :class:`TraceValidationError` with a specific message; tests call
them directly on exported files.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.metrics import parse_prometheus

__all__ = [
    "TraceValidationError",
    "validate_chrome_trace",
    "validate_metrics",
    "SUBSYSTEM_PREFIXES",
]

_REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")
_KNOWN_PHASES = {"B", "E", "X", "i", "I", "b", "e", "n", "M", "C"}

# metric-name prefixes per instrumented subsystem (the catalog lives in
# the README "Observability" section; keep both in sync)
SUBSYSTEM_PREFIXES = {
    "engine": ("serve_",),
    "scheduler": ("sched_",),
    "paging": ("page_", "prefix_"),
    "dispatch": ("kernel_dispatch",),
    "autotune": ("autotune_",),
}


class TraceValidationError(ValueError):
    """The artifact violates the expected schema."""


def validate_chrome_trace(path: str, *, require_nonempty: bool = True
                          ) -> dict:
    """Validate an exported Chrome trace; returns summary stats
    (event/span/request counts) on success."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise TraceValidationError(f"{path}: not readable JSON: {e}") from e
    if not isinstance(payload, dict) or "traceEvents" not in payload:
        raise TraceValidationError(
            f"{path}: expected the JSON-object trace form with a "
            "'traceEvents' key")
    events = payload["traceEvents"]
    if not isinstance(events, list):
        raise TraceValidationError(f"{path}: traceEvents is not a list")
    if require_nonempty and not events:
        raise TraceValidationError(f"{path}: trace is empty")

    last_ts = float("-inf")
    open_sync: dict[tuple, list[str]] = {}
    open_async: dict[tuple, int] = {}
    counts = {"events": 0, "sync_spans": 0, "async_spans": 0,
              "instants": 0}
    for i, ev in enumerate(events):
        for key in _REQUIRED_KEYS:
            if key not in ev:
                raise TraceValidationError(
                    f"{path}: event {i} missing required key {key!r}: "
                    f"{ev}")
        ph = ev["ph"]
        if ph not in _KNOWN_PHASES:
            raise TraceValidationError(
                f"{path}: event {i} has unknown phase {ph!r}")
        ts = ev["ts"]
        if not isinstance(ts, (int, float)) or ts < 0:
            raise TraceValidationError(
                f"{path}: event {i} has invalid ts {ts!r}")
        if ts < last_ts:
            raise TraceValidationError(
                f"{path}: ts goes backwards at event {i} "
                f"({ts} < {last_ts})")
        last_ts = ts
        counts["events"] += 1
        if ph == "B":
            open_sync.setdefault((ev["pid"], ev["tid"]), []).append(
                ev["name"])
        elif ph == "E":
            stack = open_sync.get((ev["pid"], ev["tid"]), [])
            if not stack:
                raise TraceValidationError(
                    f"{path}: event {i}: 'E' ({ev['name']}) with no "
                    "open 'B' on its thread")
            stack.pop()
            counts["sync_spans"] += 1
        elif ph == "b":
            key = (ev.get("cat"), ev.get("id"))
            open_async[key] = open_async.get(key, 0) + 1
        elif ph == "e":
            key = (ev.get("cat"), ev.get("id"))
            if open_async.get(key, 0) <= 0:
                raise TraceValidationError(
                    f"{path}: event {i}: async 'e' ({ev['name']}, "
                    f"id={ev.get('id')}) with no open 'b'")
            open_async[key] -= 1
            counts["async_spans"] += 1
        elif ph in ("i", "I", "n"):
            counts["instants"] += 1
    unclosed = [f"{names[-1]} (tid {tid})"
                for (_, tid), names in open_sync.items() if names]
    if unclosed:
        raise TraceValidationError(
            f"{path}: unmatched 'B' events at end of trace: {unclosed}")
    return counts


def validate_metrics(path: str, *, require_subsystems: tuple = ()
                     ) -> dict:
    """Validate a Prometheus text exposition file; optionally require at
    least one sample for every named subsystem (keys of
    :data:`SUBSYSTEM_PREFIXES`)."""
    try:
        with open(path) as f:
            parsed = parse_prometheus(f.read())
    except OSError as e:
        raise TraceValidationError(f"{path}: unreadable: {e}") from e
    except ValueError as e:
        raise TraceValidationError(f"{path}: {e}") from e
    if not parsed["samples"]:
        raise TraceValidationError(f"{path}: no metric samples")
    missing = []
    for subsystem in require_subsystems:
        prefixes = SUBSYSTEM_PREFIXES.get(subsystem)
        if prefixes is None:
            raise TraceValidationError(
                f"unknown subsystem {subsystem!r}; known: "
                f"{sorted(SUBSYSTEM_PREFIXES)}")
        if not any(name.startswith(prefixes) for name in parsed["samples"]):
            missing.append(subsystem)
    if missing:
        raise TraceValidationError(
            f"{path}: no samples from subsystem(s) {missing} — expected "
            f"prefixes {[SUBSYSTEM_PREFIXES[s] for s in missing]}")
    return {"samples": len(parsed["samples"]), "types": parsed["types"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("trace", help="Chrome-trace JSON file")
    ap.add_argument("metrics", nargs="?", default=None,
                    help="Prometheus text exposition file")
    ap.add_argument("--require-subsystems", default="",
                    help="comma-separated subsystem names whose metrics "
                         "must be present (engine,scheduler,paging,"
                         "dispatch,autotune)")
    args = ap.parse_args(argv)
    try:
        stats = validate_chrome_trace(args.trace)
        print(f"{args.trace}: OK — {stats['events']} events, "
              f"{stats['sync_spans']} sync spans, "
              f"{stats['async_spans']} request spans, "
              f"{stats['instants']} instants")
        if args.metrics:
            req = tuple(s for s in args.require_subsystems.split(",") if s)
            mstats = validate_metrics(args.metrics,
                                      require_subsystems=req)
            print(f"{args.metrics}: OK — {mstats['samples']} samples"
                  + (f", subsystems {list(req)} covered" if req else ""))
    except TraceValidationError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
