"""Kernel registry (port of ``repro.kernels.registry`` and
``repro.kernels.backend``): named implementations per op, priority
dispatch, an inspectable record of every routing decision, and the
backend resolution every call goes through.

Ops register candidate implementations with a ``supports(ctx) -> None |
str`` predicate (None: "I can run this"; a string: why not). ``dispatch``
walks them in descending priority, runs the first supported one and
records a :class:`DispatchRecord`; ``dispatch_counts`` keeps a
never-evicting ``(op, impl, backend) -> count`` map, so a run can show
that the hand-written kernels served it and the reference did not.

Backends. Every implementation serves both devices: a kernel wrapper
launches its CUDA kernel on a CUDA tensor and runs its plain PyTorch
version on a CPU tensor, and the reference runs anywhere. The record
names the backend the call resolved, in this order:
the call's ``backend=`` argument, the weight policy's ``backend``,
``$REPRO_TORCH_BACKEND``, then the device of the input tensor. A backend
that names another device than the tensor's raises
:class:`KernelForceError`: a CUDA tensor never runs a plain version by
accident, and a CPU tensor never claims a kernel.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading
from typing import Any, Callable, Optional

import torch

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
    "register",
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


def resolve_backend(requested: Optional[str], device: torch.device) -> str:
    """Concrete backend (``cuda`` or ``cpu``) for a call on ``device``;
    see the module docstring for the order and the error."""
    value = requested or "auto"
    source = "call/policy"
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
    policy's kernel switch, the kernel geometry, the resolved backend."""
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


def implementations(op: str) -> tuple[KernelImpl, ...]:
    with _LOCK:
        return tuple(_IMPLS.get(op, ()))


def _choose(op: str, ctx: dict) -> tuple[KernelImpl, DispatchRecord]:
    backend = ctx["backend"]
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
            reason="; ".join(skipped), backend=backend)
    raise LookupError(
        f"no implementation of {op!r} supports this call on backend "
        f"{backend!r}: {'; '.join(skipped)}")


def dispatch(op: str, ctx: dict, *args, **kwargs):
    """Run the highest-priority supported implementation of ``op``."""
    impl, rec = _choose(op, ctx)
    out = impl.run(*args, **kwargs)
    with _LOCK:
        _HISTORY.append(rec)
        _COUNTS[(rec.op, rec.impl, rec.backend)] += 1
    return out


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
