"""CUDA graphs over the kernel wrappers: what a capture must keep, and
:class:`Graphed`, a function of device tensors captured once per input
signature and replayed (the serving engine's steps and the CNN forward).

A captured graph replays its kernels on the addresses they were given at
capture. Two kinds of device buffer that wrappers keep in caches of
their own would break that: the decode (and gather) kernels' split-K
workspace and arrival counters, kept per (device, stream) and regrown
when a launch needs more, and a mask plan's operands, kept in an LRU.
If either were regrown or evicted after a capture, the graph would
write or read memory that had gone back to the allocator.

Inside ``with scope(s):`` the wrappers take their scratch from ``s``
(made at the first call inside the scope, so the same step's warm-up run
makes them before its capture, and no later call regrows them), and
:func:`hold` appends every cached operand a launch reads to ``s.held``.
The owner of ``s`` keeps it as long as the graph lives. Outside a scope
both are no-ops and the wrappers' own caches serve.

The registry's dispatch counters and the kernels' launch counters are
Python: they advance when a function runs eagerly and while it is
captured, not on replay. Each graph records what its capture added
(:class:`CapturedStep`), so what ran on the card is the eager count plus
each graph's capture count times its replays, less the capture itself
(:func:`ran_counts`).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.kernels import build, registry

__all__ = ["CapturedStep", "Graphed", "Scope", "active", "hold",
           "ran_counts", "scope", "scratch_cache"]


class Scope:
    """The scratch buffers and the held operands of one graph."""

    def __init__(self):
        self.scratch: dict = {}  # id of a wrapper's cache -> its buffers
        self.held: list = []


_ACTIVE: Optional[Scope] = None


@contextlib.contextmanager
def scope(s: Scope):
    """Route scratch and held operands to ``s`` for the duration."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, s
    try:
        yield s
    finally:
        _ACTIVE = prev


def active() -> Optional[Scope]:
    return _ACTIVE


def hold(*tensors) -> None:
    """Keep ``tensors`` alive with the active scope's graph (if any)."""
    if _ACTIVE is not None:
        _ACTIVE.held.extend(tensors)


def scratch_cache(cache: dict) -> dict:
    """The dict a wrapper keeps its scratch in: its own ``cache``, or the
    active scope's counterpart of it."""
    if _ACTIVE is None:
        return cache
    return _ACTIVE.scratch.setdefault(id(cache), {})


@dataclasses.dataclass
class CapturedStep:
    """One captured graph: its input signature, the dispatches and kernel
    launches its capture recorded (what each replay runs), and how many
    times it was replayed."""

    signature: tuple
    dispatches: dict
    launches: dict
    replays: int = 0


class _Graph:
    def __init__(self, held, inputs: dict):
        self.held = held  # kept: the graph reads and writes them by address
        self.inputs = inputs  # static device buffers
        self.staging = {k: torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True)
                        for k, t in inputs.items()}
        self.copied = torch.cuda.Event()  # the staging copies were read
        self.scope = Scope()
        self.graph = torch.cuda.CUDAGraph()
        self.out: Optional[torch.Tensor] = None
        self.record: Optional[CapturedStep] = None


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


class Graphed:
    """A function run eagerly, or captured once per input signature as a
    CUDA graph and replayed.

    ``fn(*held, **inputs) -> tensor`` runs on device tensors: ``held``
    are passed through as they are (a step's caches; their identity is
    part of the signature), ``inputs`` are the tensors that change from
    call to call. ``check(*held, **inputs)`` is a bounds check run first,
    on the inputs as given. Calling ``g(*held, **inputs)`` with inputs
    on the host (numpy or CPU tensors) or on the device (None entries
    are dropped) runs the check, then either moves the inputs to the
    device and runs ``fn`` (``graphs`` False, or a CPU device), or, on
    the card: at a signature's first call runs ``fn`` on a side stream
    (the warm-up, which also makes every kernel scratch buffer and mask
    plan the function needs; its result is returned) and captures it
    under its own :class:`Scope`, and at later calls copies the inputs
    into the graph's static buffers and replays it. Host inputs go
    through pinned staging buffers, rewritten only after the last
    replay's copies ran (an event). The result of a replay is the
    graph's static output, overwritten by the next replay. A capture
    that fails raises: nothing falls back to eager. ``replayed`` is the
    record of the graph the last call replayed, else None.
    """

    def __init__(self, fn: Callable, *, device: torch.device,
                 graphs: bool = True, check: Optional[Callable] = None):
        self.fn = fn
        self.check = check
        self.device = torch.device(device)
        self.graphed = graphs and self.device.type == "cuda"
        self.built: dict = {}  # signature -> _Graph (card) or None
        self.replayed: Optional[CapturedStep] = None
        self._stream = None

    @property
    def captured(self) -> list[CapturedStep]:
        return [g.record for g in self.built.values() if g is not None]

    @property
    def graphs(self) -> list:
        """The captured ``torch.cuda.CUDAGraph`` s (to time a replay)."""
        return [g.graph for g in self.built.values() if g is not None]

    def __call__(self, *held, **inputs) -> torch.Tensor:
        given = {k: torch.as_tensor(v) for k, v in inputs.items()
                 if v is not None}
        if self.check is not None:
            self.check(*held, **given)
        sig = tuple(id(h) for h in held) + tuple(
            (k, tuple(t.shape), t.dtype) for k, t in sorted(given.items()))
        self.replayed = None
        if not self.graphed:
            self.built.setdefault(sig, None)
            return self.fn(*held, **{k: t.to(self.device)
                                     for k, t in given.items()})
        g = self.built.get(sig)
        if g is None:
            return self._capture(sig, held, given)
        if any(t.device.type == "cpu" for t in given.values()):
            g.copied.synchronize()  # the last replay's copies are done
        for k, t in given.items():
            if t.device.type == "cpu":
                g.staging[k].copy_(t)
                t = g.staging[k]
            g.inputs[k].copy_(t, non_blocking=True)
        g.copied.record()
        g.graph.replay()
        g.record.replays += 1
        self.replayed = g.record
        return g.out

    def _capture(self, sig, held, given: dict) -> torch.Tensor:
        g = _Graph(held, {k: t.to(self.device, copy=True)
                          for k, t in given.items()})
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream), scope(g.scope):
            out = self.fn(*held, **g.inputs)  # the warm-up: a real call
        torch.cuda.current_stream(self.device).wait_stream(stream)
        d0, l0 = registry.dispatch_counts(), build.launch_counts()
        with scope(g.scope), torch.cuda.graph(g.graph, stream=stream):
            g.out = self.fn(*held, **g.inputs)
        g.record = CapturedStep(
            sig[len(held):], _delta(registry.dispatch_counts(), d0),
            _delta(build.launch_counts(), l0))
        self.built[sig] = g
        return out


def ran_counts(records, dispatches: dict,
               launches: dict) -> tuple[dict, dict]:
    """What ran on the card, from the dispatch and launch counters read
    after driving the functions whose graphs are ``records`` (zeroed
    before): each graph's capture counted once and replayed ``replays``
    times, so its counts are replaced by count x replays."""
    d = collections.Counter(dispatches)
    n = collections.Counter(launches)
    for rec in records:
        for k, v in rec.dispatches.items():
            d[k] += v * (rec.replays - 1)
        for k, v in rec.launches.items():
            n[k] += v * (rec.replays - 1)
    return dict(d), dict(n)
