"""Host-side slot scheduler (port of the slot path of
``repro.serving.scheduler``; no device work here).

The scheduler owns admission into free slots, decode membership and
termination, and hands the engine fixed-shape numpy plans:

  * ``plan_prefill`` admits queued requests into free slots and returns
    one ``(slots, prefill_len)`` token block covering every slot admitted
    this step (batched admission: one prefill call per engine step).
  * ``plan_decode`` covers every slot whose prefill completed.

Admission semantics match the JAX engine: prompts are cut to their last
``prefill_len`` tokens and left-padded with zeros, and a slot's cache
length starts at ``prefill_len`` whatever the true prompt length. A cut
prompt is recorded (``Request.truncated``) and refused in strict mode.
Chunked prefill and paging come with the chunked/paged serving slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (plen,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False  # prompt exceeded prefill_len (tail kept)
    # serving timestamps (perf_counter seconds; the engine fills them in)
    t_submit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    t_tokens: list = dataclasses.field(default_factory=list)

    def itl_s(self) -> np.ndarray:
        """This request's inter-token gaps (seconds), possibly empty."""
        if len(self.t_tokens) < 2:
            return np.asarray([], np.float64)
        return np.diff(np.asarray(self.t_tokens, np.float64))


@dataclasses.dataclass
class PrefillPlan:
    tokens: np.ndarray     # (slots, prefill_len) int32
    mask: np.ndarray       # (slots,) bool: slots whose cache rows are written
    active: list           # slot ids prefilling this step


@dataclasses.dataclass
class DecodePlan:
    tokens: np.ndarray   # (slots, 1) int32: last sampled token per slot
    lengths: np.ndarray  # (slots,) int32: current cache lengths
    mask: np.ndarray     # (slots,) bool: slots whose cache rows are written
    active: list         # slot ids decoding this step


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    tokens: Optional[np.ndarray] = None  # padded (prefill_len,) prompt
    prefilled: bool = False
    length: int = 0  # decode-time cache length


class Scheduler:
    def __init__(self, *, slots: int, max_seq: int, prefill_len: int,
                 strict: bool = False):
        self.n_slots = slots
        self.max_seq = max_seq
        self.prefill_len = prefill_len
        self.strict = strict
        self.slots = [_Slot() for _ in range(slots)]
        self.queue: list[Request] = []
        self.finished: list[Request] = []

    def submit(self, req: Request, now: Optional[float] = None) -> None:
        if len(req.prompt) > self.prefill_len:
            req.truncated = True
            if self.strict:
                raise ValueError(
                    f"request {req.rid}: prompt length {len(req.prompt)} "
                    f"exceeds prefill_len={self.prefill_len} and the "
                    "engine is strict (tail truncation refused)")
        req.t_submit = now
        self.queue.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s.req is not None for s in self.slots)

    def _padded(self, prompt: np.ndarray) -> np.ndarray:
        p = np.asarray(prompt, np.int32)[-self.prefill_len:]
        tok = np.zeros(self.prefill_len, np.int32)
        tok[self.prefill_len - len(p):] = p
        return tok

    def plan_prefill(self) -> Optional[PrefillPlan]:
        for slot in self.slots:
            if slot.req is None and self.queue:
                slot.req = self.queue.pop(0)
                slot.tokens = self._padded(slot.req.prompt)
                slot.prefilled = False
                slot.length = 0
        active = [i for i, s in enumerate(self.slots)
                  if s.req is not None and not s.prefilled]
        if not active:
            return None
        tokens = np.zeros((self.n_slots, self.prefill_len), np.int32)
        mask = np.zeros(self.n_slots, bool)
        for i in active:
            tokens[i] = self.slots[i].tokens
            mask[i] = True
        return PrefillPlan(tokens, mask, active)

    def finish_prefill(self, plan: PrefillPlan, sampled: np.ndarray,
                       now: Optional[float] = None) -> None:
        """Record the first sampled token of every prefilled slot."""
        for i in plan.active:
            slot = self.slots[i]
            req = slot.req
            slot.prefilled = True
            slot.length = self.prefill_len
            req.out.append(int(sampled[i]))
            if now is not None:
                req.t_tokens.append(now)
            if req.t_first is None:
                req.t_first = now
            if len(req.out) >= req.max_new:
                self._finish(i, now)

    def plan_decode(self) -> Optional[DecodePlan]:
        tokens = np.zeros((self.n_slots, 1), np.int32)
        lengths = np.zeros(self.n_slots, np.int32)
        mask = np.zeros(self.n_slots, bool)
        active = []
        for i, slot in enumerate(self.slots):
            if slot.req is None or not slot.prefilled:
                continue
            tokens[i, 0] = slot.req.out[-1]
            lengths[i] = slot.length
            mask[i] = True
            active.append(i)
        if not active:
            return None
        return DecodePlan(tokens, lengths, mask, active)

    def finish_decode(self, plan: DecodePlan, sampled: np.ndarray,
                      now: Optional[float] = None) -> None:
        for i in plan.active:
            slot = self.slots[i]
            req = slot.req
            req.out.append(int(sampled[i]))
            if now is not None:
                req.t_tokens.append(now)
            slot.length += 1
            if len(req.out) >= req.max_new or \
                    slot.length >= self.max_seq - 1:
                self._finish(i, now)

    def _finish(self, i: int, now: Optional[float]) -> None:
        req = self.slots[i].req
        req.done = True
        req.t_done = now
        self.finished.append(req)
        self.slots[i] = _Slot()
