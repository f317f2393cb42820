"""Structured tracer: typed span/instant events in a thread-safe ring
buffer, exported as Chrome-trace JSON (Perfetto-loadable); a copy of
``repro.obs.trace``, the same event names and format.

Event model (a tight subset of the Trace Event Format that both
``chrome://tracing`` and https://ui.perfetto.dev consume):

  * **Sync spans** (``ph="B"`` / ``ph="E"``) — duration events on the
    emitting thread; :meth:`Tracer.span` is a context manager that
    always emits the matched pair (the ``E`` fires even on exceptions).
    Used for engine-step work: ``engine.prefill`` / ``engine.decode``.
  * **Async spans** (``ph="b"`` / ``ph="e"``, ``cat="request"``,
    ``id=rid``) — request lifetimes that cross many engine steps.
    :meth:`async_begin` / :meth:`async_end`; :meth:`async_instant`
    (``ph="n"``) marks points inside one (``prefill_chunk``,
    ``first_token``, ``preempted``).
  * **Instants** (``ph="i"``) — per-step occupancy snapshots and
    scheduler decisions.

Timestamps are ``time.perf_counter()`` (monotonic) converted to
microseconds relative to tracer creation, so ``ts`` starts near 0 and
never goes backwards. The buffer is a bounded deque (capacity from
``REPRO_OBS_TRACE_CAP``, default 65536 events) — a long-running server
keeps the most recent window instead of growing without bound.

``export_chrome(path)`` writes the JSON-object form
(``{"traceEvents": [...]}``) which Perfetto opens directly.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional

__all__ = ["TraceEvent", "Tracer", "DEFAULT_TRACE_CAPACITY"]

DEFAULT_TRACE_CAPACITY = 65536


class TraceEvent(dict):
    """A trace event is a plain dict (kept JSON-shaped on purpose); the
    subclass exists so tests can assert type without schema drift."""

    __slots__ = ()


def trace_capacity() -> int:
    try:
        return int(os.environ.get("REPRO_OBS_TRACE_CAP",
                                  DEFAULT_TRACE_CAPACITY))
    except ValueError:
        return DEFAULT_TRACE_CAPACITY


class _SpanCtx:
    """Context manager emitting a matched B/E pair around a block."""

    __slots__ = ("_tracer", "_name", "_args")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._tracer._emit("B", self._name, args=self._args)
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer._emit("E", self._name)
        return False


class Tracer:
    """Thread-safe ring buffer of trace events with Chrome-JSON export."""

    def __init__(self, capacity: Optional[int] = None):
        self._cap = capacity if capacity is not None else trace_capacity()
        self._buf: collections.deque[TraceEvent] = collections.deque(
            maxlen=self._cap)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._dropped = 0

    # ---- emission ---------------------------------------------------------

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _emit(self, ph: str, name: str, *, cat: str = "serve",
              args: Optional[dict] = None, id: Optional[int] = None,
              ts: Optional[float] = None) -> None:
        ev = TraceEvent(
            name=name, ph=ph, cat=cat,
            ts=self.now_us() if ts is None else ts,
            pid=self._pid, tid=threading.get_ident(),
        )
        if args:
            ev["args"] = args
        if id is not None:
            ev["id"] = str(id)
        with self._lock:
            if len(self._buf) == self._cap:
                self._dropped += 1
            self._buf.append(ev)

    def span(self, name: str, **args) -> _SpanCtx:
        """``with tracer.span("engine.decode", slots=3): ...`` — emits a
        matched B/E pair on this thread."""
        return _SpanCtx(self, name, args)

    def instant(self, name: str, **args) -> None:
        self._emit("i", name, args=args or None)

    def async_begin(self, name: str, id: int, **args) -> None:
        self._emit("b", name, cat="request", id=id, args=args or None)

    def async_instant(self, name: str, id: int, **args) -> None:
        self._emit("n", name, cat="request", id=id, args=args or None)

    def async_end(self, name: str, id: int, **args) -> None:
        self._emit("e", name, cat="request", id=id, args=args or None)

    # ---- export -----------------------------------------------------------

    def events(self) -> list[TraceEvent]:
        with self._lock:
            return list(self._buf)

    @property
    def dropped(self) -> int:
        """Events evicted by the ring buffer since creation."""
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def export_chrome(self, path: str) -> int:
        """Write the Chrome-trace JSON object form; returns the event
        count. Events are sorted by ``ts`` (the buffer is append-ordered
        already; sorting makes the monotonic-ts contract explicit even
        across threads)."""
        events = sorted(self.events(), key=lambda e: e["ts"])
        payload = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "repro_torch.obs",
                "dropped_events": self._dropped,
            },
        }
        with open(path, "w") as f:
            json.dump(payload, f)
        return len(events)
