"""Unified observability layer: metrics registry + structured tracer
(port of ``repro.obs``: plain Python, copied, the same metric and event
names, formats and environment gate).

One process-global :class:`Obs` bundle (a :class:`MetricsRegistry` and a
:class:`Tracer`) that every instrumented subsystem — serving engine,
scheduler, page manager, kernel-dispatch registry, autotuner — consults
through :func:`get_obs`. The contract is **zero overhead when off**:

  * ``get_obs()`` returns ``None`` unless observability was enabled, so
    every instrumentation site is a single ``is not None`` check; no
    registries, tracers, or event dicts are ever allocated.
  * Enabling is explicit (:func:`enable`) or environment-driven:
    ``REPRO_OBS=1`` auto-enables on first :func:`get_obs` call.
    ``REPRO_OBS`` unset, empty, or ``0`` keeps observability off —
    the serve token streams are byte-identical either way (tested).

Typical wiring::

    import repro_torch.obs as obs

    handle = obs.enable()                 # or REPRO_OBS=1 in the env
    eng = ServeEngine(lm, ...)            # picks up the global bundle
    eng.run()
    handle.tracer.export_chrome("trace.json")
    open("metrics.prom", "w").write(handle.metrics.to_prometheus())

``ServeEngine(obs=...)`` also accepts an explicit bundle for isolated
collection (for example one bundle an engine). Trace buffer
capacity comes from ``REPRO_OBS_TRACE_CAP`` (default 65536 events).
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional

from repro_torch.obs.metrics import (  # noqa: F401 (re-export)
    DEFAULT_SECONDS_BUCKETS,
    MetricsRegistry,
    parse_prometheus,
)
from repro_torch.obs.trace import (  # noqa: F401 (re-export)
    DEFAULT_TRACE_CAPACITY,
    Tracer,
)

__all__ = [
    "Obs", "MetricsRegistry", "Tracer", "enable", "disable", "get_obs",
    "enabled_by_env", "null_span", "parse_prometheus",
]


@dataclasses.dataclass
class Obs:
    """The observability bundle every instrumented subsystem shares."""

    metrics: MetricsRegistry
    tracer: Tracer

    @classmethod
    def create(cls, trace_capacity: Optional[int] = None) -> "Obs":
        return cls(metrics=MetricsRegistry(),
                   tracer=Tracer(capacity=trace_capacity))


class _NullSpan:
    """Reusable no-op stand-in for ``tracer.span`` when obs is off: one
    module-level instance, callable with any signature, usable as a
    context manager — the off path allocates nothing per call."""

    __slots__ = ()

    def __call__(self, name, **args):
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()

_LOCK = threading.Lock()
_GLOBAL: Optional[Obs] = None
_ENV_CHECKED = False


def enabled_by_env() -> bool:
    """True when ``REPRO_OBS`` requests observability (any value except
    unset / empty / "0")."""
    return os.environ.get("REPRO_OBS", "0") not in ("", "0")


def enable(obs: Optional[Obs] = None) -> Obs:
    """Install (and return) the process-global bundle. Idempotent when
    already enabled and no explicit bundle is passed."""
    global _GLOBAL, _ENV_CHECKED
    with _LOCK:
        if obs is not None:
            _GLOBAL = obs
        elif _GLOBAL is None:
            _GLOBAL = Obs.create()
        _ENV_CHECKED = True
        return _GLOBAL


def disable() -> None:
    """Drop the global bundle (tests; long-lived processes that want a
    fresh collection window should prefer a new explicit bundle)."""
    global _GLOBAL, _ENV_CHECKED
    with _LOCK:
        _GLOBAL = None
        _ENV_CHECKED = True


def reset_for_tests() -> None:
    """Forget both the bundle and the env decision, so the next
    :func:`get_obs` re-reads ``REPRO_OBS``."""
    global _GLOBAL, _ENV_CHECKED
    with _LOCK:
        _GLOBAL = None
        _ENV_CHECKED = False


def get_obs() -> Optional[Obs]:
    """The global bundle, or None when observability is off.

    The first call consults ``REPRO_OBS`` once; after that the decision
    is process-state (``enable`` / ``disable`` flip it explicitly).
    """
    global _GLOBAL, _ENV_CHECKED
    if _ENV_CHECKED:
        return _GLOBAL
    with _LOCK:
        if not _ENV_CHECKED:
            if _GLOBAL is None and enabled_by_env():
                _GLOBAL = Obs.create()
            _ENV_CHECKED = True
        return _GLOBAL


def null_span():
    """The shared no-op span factory (see :class:`_NullSpan`)."""
    return _NULL_SPAN
