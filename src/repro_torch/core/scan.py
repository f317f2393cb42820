"""Python-loop scans with a hook for a step count.

A recurrent mixer (Mamba, RWKV) scans its sequence one position at a
time in a Python loop, and the train step its microbatches. Such a loop
is written

    for t in scan_steps(s, x):
        ...
        ys.append(y_t)
    y = torch.stack(scan_outputs(ys, s), dim=1)

and is the plain ``range(s)`` unless a count is installed with
:func:`counting` and the loop runs on meta tensors. A count is an
object with a ``weighted(s)`` method that yields the positions to run:
the dry-run's (``repro_torch.roofline.step_cost``) runs steps 0, 1,
s - 2 and s - 1 of a loop of ``s`` > 4 and charges step 1 for steps 1
to s - 3, as the JAX package's HLO walk multiplies a ``while`` body by
its trip count: a 32k-token prefill is counted in four steps, not
32,768.

:func:`scan_outputs` repeats step 1's output for the steps it stands
for (detached: its gradient reaches step 1 once), so the stack has the
whole sequence's shape and bytes.
"""
from __future__ import annotations

import contextlib
from typing import Iterable, Iterator, Optional

import torch

_COUNTS: list = []  # the installed counts, innermost last


def active() -> Optional[object]:
    """The innermost installed count, None outside one."""
    return _COUNTS[-1] if _COUNTS else None


@contextlib.contextmanager
def counting(count) -> Iterator[None]:
    """Install ``count`` for the scans run inside the block."""
    _COUNTS.append(count)
    try:
        yield
    finally:
        _COUNTS.remove(count)


def scan_steps(s: int, like: torch.Tensor) -> Iterable[int]:
    """The positions of a scan of ``s`` steps over ``like``'s sequence:
    ``range(s)``, or on meta tensors of more than 4 steps under a count
    the positions its ``weighted(s)`` gives."""
    count = active()
    if count is None or not like.is_meta or s <= 4:
        return range(s)
    return count.weighted(s)


def scan_outputs(ys: list, s: int) -> list:
    """The per-step outputs of :func:`scan_steps`' loop, ``s`` of them."""
    if len(ys) == s:
        return ys
    return ys[:2] + [ys[1].detach()] * (s - 4) + ys[2:]
