"""Kernel registry (port of ``repro.kernels.registry`` and
``repro.kernels.backend``): named implementations per op, priority
dispatch, an inspectable record of every routing decision, and the
backend resolution every call goes through.

Ops register candidate implementations with a ``supports(ctx) -> None |
str`` predicate (None: "I can run this"; a string: why not). ``dispatch``
walks them in descending priority, runs the first supported one and
records a :class:`DispatchRecord`; ``dispatch_counts`` keeps a
never-evicting ``(op, impl, backend) -> count`` map, so a run can show
that the hand-written kernels served it and the reference did not. With
observability on (:mod:`repro_torch.obs`) a dispatch also increments
``kernel_dispatch_total{op,impl,backend}``, except while a CUDA graph is
being captured: the metric counts what ran, and a graph's dispatches run
at its replays (the serving engine adds them there).

Backends. Every implementation serves both devices: a kernel wrapper
launches its CUDA kernel on a CUDA tensor and runs its plain PyTorch
version on a CPU tensor, and the reference runs anywhere. The record
names the backend the call resolved, in this order:
the call's ``backend=`` argument, the weight policy's ``backend``,
``$REPRO_TORCH_BACKEND``, then the device of the input tensor. A backend
that names another device than the tensor's raises
:class:`KernelForceError`: a CUDA tensor never runs a plain version by
accident, and a CPU tensor never claims a kernel.

The meta backend. A tensor on the ``meta`` device (the dry-run,
:mod:`repro_torch.roofline.step_cost`) resolves to ``meta``, and only
such a tensor does. An op family with a kernel registers a meta
implementation (:func:`register_meta`) that returns an empty output of
the kernel's shape and dtype; a meta call whose policy would take the
kernel runs it (impl ``"meta"`` on the record), one whose policy is
``off`` walks the implementations as on the CPU (the reference, on meta
tensors). :func:`meta_observer` wraps every meta implementation's run:
the dry-run charges the op its kernel cost there.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import os
import threading
from typing import Any, Callable, Optional

import torch

from repro_torch import obs as _obs

__all__ = [
    "DispatchRecord",
    "KernelForceError",
    "clear_history",
    "dispatch",
    "dispatch_counts",
    "dispatch_history",
    "explain",
    "last_dispatch",
    "make_ctx",
    "meta_observer",
    "register",
    "register_meta",
    "resolve_backend",
]


@dataclasses.dataclass(frozen=True)
class DispatchRecord:
    """One routing decision (newest last in the history)."""

    op: str  # dispatch family, e.g. "nm_matmul_decode"
    impl: str  # chosen implementation, e.g. "nm_spmm_decode"
    shape: tuple  # logical (M, K, N)
    padded: Optional[tuple]  # (M', K', N') of the kernel's tiles, else None
    block: Optional[tuple]  # (block_m, block_n, block_k) when applicable
    reason: str  # why higher-priority impls were skipped ("" if none)
    backend: str = "cpu"  # resolved backend the call routed under


class KernelForceError(RuntimeError):
    """A forced kernel or backend cannot serve the call. Raised instead
    of a silent fall-through to the reference."""


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    op: str
    name: str
    priority: int
    supports: Callable[[dict], Optional[str]]
    run: Callable[..., Any]
    uses_plan: bool = False


_LOCK = threading.Lock()
_IMPLS: dict[str, list[KernelImpl]] = {}
_HISTORY: collections.deque[DispatchRecord] = collections.deque(maxlen=256)
_COUNTS: collections.Counter = collections.Counter()
_META: dict[str, Callable[..., Any]] = {}
# wraps each meta implementation's run: observer(record, ctx, run, args,
# kwargs) -> output (the dry-run's cost counter)
_META_OBSERVER: contextvars.ContextVar[Optional[Callable]] = \
    contextvars.ContextVar("meta_observer", default=None)


def resolve_backend(requested: Optional[str], device: torch.device) -> str:
    """Concrete backend (``cuda``, ``cpu`` or ``meta``) for a call on
    ``device``; see the module docstring for the order and the error. A
    meta tensor resolves to ``meta`` unless the call or its policy names
    another backend (then it raises); ``$REPRO_TORCH_BACKEND`` names the
    backend of real tensors only."""
    value = requested or "auto"
    source = "call/policy"
    if device.type == "meta":
        if value not in ("auto", "meta"):
            raise KernelForceError(
                f"kernel backend {value!r} (from {source}) cannot serve a "
                f"tensor on {device}")
        return "meta"
    if value == "auto":
        env = os.environ.get("REPRO_TORCH_BACKEND")
        if env:
            value, source = env, "$REPRO_TORCH_BACKEND"
    if value not in ("auto", "cuda", "cpu"):
        raise ValueError(f"unknown kernel backend {value!r} from {source}; "
                         "expected auto, cuda or cpu")
    if device.type not in ("cuda", "cpu"):
        raise KernelForceError(f"no kernel backend for device {device}")
    if value == "auto":
        return device.type
    if value != device.type:
        raise KernelForceError(
            f"kernel backend {value!r} (from {source}) cannot serve a "
            f"tensor on {device}")
    return value


def make_ctx(shape, *, nm, use_kernel: bool, plan=None, dtype=None,
             backend: str = "cpu") -> dict:
    """Dispatch context: logical (M, K, N), the weight's NMConfig, the
    policy's kernel switch, the kernel geometry, the resolved backend. A
    ``note`` a router adds is appended to the record's reason."""
    return {"shape": tuple(shape), "cfg": nm, "use_kernel": use_kernel,
            "plan": plan, "dtype": dtype, "backend": backend}


def register(op: str, name: str, *, priority: int = 0,
             supports: Callable[[dict], Optional[str]] = lambda ctx: None,
             uses_plan: bool = False):
    """Decorator registering ``fn`` as implementation ``name`` of ``op``."""

    def deco(fn):
        impl = KernelImpl(op, name, priority, supports, fn, uses_plan)
        with _LOCK:
            impls = [i for i in _IMPLS.get(op, ()) if i.name != name]
            impls.append(impl)
            impls.sort(key=lambda i: -i.priority)
            _IMPLS[op] = impls
        return fn

    return deco


def register_meta(op: str):
    """Decorator registering ``fn`` as the meta implementation of ``op``:
    it takes the call's arguments and returns an empty output of the
    kernel's shape and dtype on the meta device."""

    def deco(fn):
        with _LOCK:
            _META[op] = fn
        return fn

    return deco


@contextlib.contextmanager
def meta_observer(fn: Callable):
    """Within the block, every meta implementation runs as ``fn(record,
    ctx, run, args, kwargs)``, which calls ``run(*args, **kwargs)`` and
    returns its output."""
    token = _META_OBSERVER.set(fn)
    try:
        yield fn
    finally:
        _META_OBSERVER.reset(token)


def implementations(op: str) -> tuple[KernelImpl, ...]:
    with _LOCK:
        return tuple(_IMPLS.get(op, ()))


def _choose(op: str, ctx: dict) -> tuple[KernelImpl, DispatchRecord]:
    backend = ctx["backend"]
    if backend == "meta" and ctx["use_kernel"] and op in _META:
        return KernelImpl(op, "meta", 0, lambda c: None, _META[op]), \
            DispatchRecord(op=op, impl="meta", shape=tuple(ctx["shape"]),
                           padded=None, block=None,
                           reason=ctx.get("note") or "", backend=backend)
    skipped = []
    for impl in implementations(op):
        why = impl.supports(ctx)
        if why is not None:
            skipped.append(f"{impl.name}: {why}")
            continue
        plan = ctx.get("plan")
        uses_plan = plan is not None and impl.uses_plan
        return impl, DispatchRecord(
            op=op, impl=impl.name, shape=tuple(ctx["shape"]),
            padded=plan.padded_shape if uses_plan else None,
            block=plan.block if uses_plan else None,
            reason="; ".join(skipped + ([ctx["note"]] if ctx.get("note")
                                        else [])),
            backend=backend)
    raise LookupError(
        f"no implementation of {op!r} supports this call on backend "
        f"{backend!r}: {'; '.join(skipped)}")


def dispatch(op: str, ctx: dict, *args, **kwargs):
    """Run the highest-priority supported implementation of ``op``."""
    impl, rec = _choose(op, ctx)
    observer = _META_OBSERVER.get() if rec.impl == "meta" else None
    if observer is not None:
        out = observer(rec, ctx, impl.run, args, kwargs)
    else:
        out = impl.run(*args, **kwargs)
    _record(rec)
    return out


def _record(rec: DispatchRecord) -> None:
    with _LOCK:
        _HISTORY.append(rec)
        _COUNTS[(rec.op, rec.impl, rec.backend)] += 1
    bundle = _obs.get_obs()
    if bundle is not None and not (
            torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        bundle.metrics.inc("kernel_dispatch_total", op=rec.op,
                           impl=rec.impl, backend=rec.backend)


def explain(op: str, ctx: dict) -> DispatchRecord:
    """The record ``dispatch`` would write for ``ctx``, running nothing."""
    return _choose(op, ctx)[1]


def last_dispatch(op: Optional[str] = None) -> Optional[DispatchRecord]:
    with _LOCK:
        for rec in reversed(_HISTORY):
            if op is None or rec.op == op:
                return rec
    return None


def dispatch_history(op: Optional[str] = None) -> list[DispatchRecord]:
    with _LOCK:
        return [r for r in _HISTORY if op is None or r.op == op]


def dispatch_counts(op_prefix: Optional[str] = None,
                    backend: Optional[str] = None) -> dict:
    """Cumulative ``(op, impl, backend) -> count`` since process start or
    :func:`clear_history`."""
    with _LOCK:
        return {k: v for k, v in _COUNTS.items()
                if (op_prefix is None or k[0].startswith(op_prefix))
                and (backend is None or k[2] == backend)}


def clear_history() -> None:
    """Reset the record history and the dispatch counters."""
    with _LOCK:
        _HISTORY.clear()
        _COUNTS.clear()
