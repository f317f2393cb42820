"""What a CUDA graph captured over the kernel wrappers must keep.

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
"""
from __future__ import annotations

import contextlib
from typing import Optional

__all__ = ["Scope", "active", "hold", "scope", "scratch_cache"]


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
