"""Process-local metrics registry: counters, gauges, histograms (a copy
of ``repro.obs.metrics``, the same names and formats).

The registry is the numeric half of the observability layer (the
:mod:`repro_torch.obs.trace` tracer is the temporal half). It is deliberately
small and dependency-free:

  * **Counter** — monotonically increasing float (``inc``).
  * **Gauge** — last-write-wins float (``set``).
  * **Histogram** — fixed bucket edges chosen at creation; ``observe``
    increments the first bucket whose upper edge is >= the sample
    (cumulative at export, like Prometheus ``le`` buckets) and tracks
    ``sum`` / ``count``.

Metrics are keyed by ``(name, sorted label items)`` — the same name may
carry many label sets (e.g.
``kernel_dispatch_total{op=...,impl=...,backend=...}``).
All mutation goes through one lock; every hot-path call is a dict lookup
plus a float add, and nothing here is ever invoked unless observability
is enabled (see :mod:`repro_torch.obs`).

``snapshot()`` returns a plain-dict view (JSON-serializable);
``to_prometheus()`` renders
the Prometheus text exposition format, which round-trips through
:func:`parse_prometheus` (used by the CI schema check and tests).
"""
from __future__ import annotations

import threading
from typing import Mapping, Optional, Sequence

__all__ = [
    "MetricsRegistry",
    "DEFAULT_SECONDS_BUCKETS",
    "parse_prometheus",
]

# duration buckets (seconds): 10us .. 30s, roughly log-spaced — wide
# enough for CPU serving steps and microsecond kernels on the card
DEFAULT_SECONDS_BUCKETS = (
    1e-5, 1e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0, 5.0, 30.0,
)


def _label_key(labels: Mapping[str, str]) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class _Histogram:
    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Sequence[float]):
        self.edges = tuple(float(e) for e in edges)
        if list(self.edges) != sorted(self.edges) or not self.edges:
            raise ValueError(f"histogram edges must be sorted+non-empty: "
                             f"{edges}")
        self.counts = [0] * (len(self.edges) + 1)  # +1: +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        for i, e in enumerate(self.edges):
            if v <= e:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.sum += v
        self.count += 1

    def cumulative(self) -> list[tuple[float, int]]:
        """Prometheus-style cumulative (le, count) pairs incl +Inf."""
        out, running = [], 0
        for e, c in zip(self.edges, self.counts):
            running += c
            out.append((e, running))
        out.append((float("inf"), running + self.counts[-1]))
        return out


class MetricsRegistry:
    """Counters, gauges and fixed-bucket histograms behind one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, tuple], float] = {}
        self._gauges: dict[tuple[str, tuple], float] = {}
        self._hists: dict[tuple[str, tuple], _Histogram] = {}
        self._hist_edges: dict[str, tuple] = {}

    # ---- mutation ---------------------------------------------------------

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._gauges[key] = float(value)

    def define_histogram(self, name: str,
                         edges: Sequence[float] = DEFAULT_SECONDS_BUCKETS
                         ) -> None:
        """Pin bucket edges for ``name`` (before the first observe)."""
        with self._lock:
            if name in self._hist_edges and \
                    self._hist_edges[name] != tuple(edges):
                raise ValueError(
                    f"histogram {name!r} already defined with different "
                    f"edges {self._hist_edges[name]}")
            self._hist_edges[name] = tuple(edges)

    def observe(self, name: str, value: float, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = _Histogram(
                    self._hist_edges.get(name, DEFAULT_SECONDS_BUCKETS))
                self._hists[key] = h
            h.observe(float(value))

    # ---- read -------------------------------------------------------------

    def counter_value(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get((name, _label_key(labels)), 0.0)

    def gauge_value(self, name: str, **labels) -> Optional[float]:
        with self._lock:
            return self._gauges.get((name, _label_key(labels)))

    def snapshot(self) -> dict:
        """JSON-serializable view of everything recorded so far."""
        with self._lock:
            counters = {f"{n}{_label_str(lk)}": v
                        for (n, lk), v in sorted(self._counters.items())}
            gauges = {f"{n}{_label_str(lk)}": v
                      for (n, lk), v in sorted(self._gauges.items())}
            hists = {}
            for (n, lk), h in sorted(self._hists.items()):
                hists[f"{n}{_label_str(lk)}"] = {
                    # +Inf spelled as a string so the snapshot stays
                    # strict JSON
                    "buckets": [["+Inf" if le == float("inf") else le, c]
                                for le, c in h.cumulative()],
                    "sum": h.sum,
                    "count": h.count,
                }
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    def to_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4) of the current state."""
        lines: list[str] = []
        with self._lock:
            by_name: dict[str, list[str]] = {}
            for (n, lk), v in sorted(self._counters.items()):
                by_name.setdefault(f"{n}\tcounter", []).append(
                    f"{n}{_label_str(lk)} {_fmt(v)}")
            for (n, lk), v in sorted(self._gauges.items()):
                by_name.setdefault(f"{n}\tgauge", []).append(
                    f"{n}{_label_str(lk)} {_fmt(v)}")
            for (n, lk), h in sorted(self._hists.items()):
                samples = by_name.setdefault(f"{n}\thistogram", [])
                for le, c in h.cumulative():
                    le_s = "+Inf" if le == float("inf") else _fmt(le)
                    key = _label_key(dict(lk, le=le_s)) if lk else \
                        ((("le", le_s),))
                    samples.append(f"{n}_bucket{_label_str(tuple(key))} {c}")
                samples.append(f"{n}_sum{_label_str(lk)} {_fmt(h.sum)}")
                samples.append(f"{n}_count{_label_str(lk)} {h.count}")
        for name_type, samples in sorted(by_name.items()):
            name, mtype = name_type.split("\t")
            lines.append(f"# TYPE {name} {mtype}")
            lines.extend(samples)
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def parse_prometheus(text: str) -> dict:
    """Parse :meth:`MetricsRegistry.to_prometheus` output back into
    ``{"types": {name: type}, "samples": {name{labels}: value}}``.
    Strict enough to validate the exposition in CI and to round-trip a
    snapshot in tests; not a general Prometheus parser."""
    types: dict[str, str] = {}
    samples: dict[str, float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        try:
            key, val = line.rsplit(" ", 1)
            samples[key] = float(val) if val != "+Inf" else float("inf")
        except ValueError as e:
            raise ValueError(
                f"malformed exposition line {lineno}: {line!r}") from e
    return {"types": types, "samples": samples}
