"""Host-side continuous-batching scheduler (port of
``repro.serving.scheduler``; no device work here).

The scheduler owns admission into free slots, chunked-prefill progress,
decode membership and termination, and hands the engine fixed-shape
numpy plans:

  * ``plan_prefill`` admits queued requests and returns one ``(slots,
    prefill_chunk)`` token block covering every slot that still has
    prompt pieces to prefill (batched admission: one prefill call per
    engine step). A prompt advances one ``prefill_chunk`` piece a step,
    so the time to first token is bounded by the chunks, not by the
    longest prompt.
  * ``plan_decode`` covers every slot whose prefill completed.

Prompts are cut to their last ``prefill_len`` tokens and left-padded
with zeros, and a slot's cache length starts at ``prefill_len`` whatever
the true prompt length. A cut prompt is recorded (``Request.truncated``)
and refused in strict mode.

Paged mode (``paging=PageManager(...)``): admission is planned against
the free-page budget as well as free slots. A request is admitted when
a free slot's group has enough free or evictable pages for its prompt,
less the prefix-cache pages it can reuse (whole pages and whole chunks,
at most ``prefill_len - prefill_chunk`` tokens, so the last chunk always
runs and gives the first token). Admission is arrival-ordered with a
starvation guard: a request that does not fit may be passed by later
arrivals once (``Request.bypassed``); the second time, admission stops
behind it. Decode allocates pages lazily (one a ``page_size`` tokens);
when the pool is exhausted the scheduler preempts the latest-admitted
slot of the group: its pages are freed and its request goes back to the
front of the queue, to be recomputed (``preemptions`` counts them).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch import obs as _obs
from repro_torch.serving.paging import (
    PageManager,
    PoolExhaustedError,
    page_keys,
)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (plen,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False  # prompt exceeded prefill_len (tail kept)
    bypassed: bool = False   # a later arrival was admitted past this one
    # serving timestamps (perf_counter seconds; the engine fills them in)
    t_submit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    # one per entry of ``out``; cleared with ``out`` on preemption
    t_tokens: list = dataclasses.field(default_factory=list)

    def itl_s(self) -> np.ndarray:
        """This request's inter-token gaps (seconds), possibly empty."""
        if len(self.t_tokens) < 2:
            return np.asarray([], np.float64)
        return np.diff(np.asarray(self.t_tokens, np.float64))


@dataclasses.dataclass
class PrefillPlan:
    tokens: np.ndarray     # (slots, prefill_chunk) int32
    cache_len: np.ndarray  # (slots,) int32: per-slot write offset
    mask: np.ndarray       # (slots,) bool: slots whose cache rows are written
    active: list           # slot ids prefilling this step
    finishing: list        # the subset writing their last chunk


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
    pos: int = 0      # prefill progress (tokens written to the cache)
    length: int = 0   # decode-time cache length
    # paged mode
    seq: int = 0                  # admission order (preemption victim)
    hit_pages: int = 0            # prefix pages reused at admission
    keys: Optional[list] = None   # the prompt's page chain keys


class Scheduler:
    def __init__(self, *, slots: int, max_seq: int, prefill_len: int,
                 prefill_chunk: Optional[int] = None, strict: bool = False,
                 paging: Optional[PageManager] = None, obs=None):
        self.prefill_chunk = prefill_chunk or prefill_len
        if prefill_len % self.prefill_chunk:
            raise ValueError(
                f"prefill_len={prefill_len} must be a multiple of "
                f"prefill_chunk={self.prefill_chunk} (fixed-shape chunks)")
        self.n_slots = slots
        self.max_seq = max_seq
        self.prefill_len = prefill_len
        self.strict = strict
        self.paging = paging
        if paging is not None:
            if prefill_len % paging.page_size:
                raise ValueError(
                    f"prefill_len={prefill_len} must be a multiple of "
                    f"page_size={paging.page_size}: decode must start on "
                    "a fresh page so prompt pages stay immutable once "
                    "registered in the prefix cache")
            # prefix hits advance in whole pages AND whole chunks
            self._hit_gran = math.lcm(paging.page_size, self.prefill_chunk)
        self.slots = [_Slot() for _ in range(slots)]
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.preemptions = 0
        self._admit_seq = 0
        self.obs = obs if obs is not None else _obs.get_obs()

    # ---- observability ----------------------------------------------------

    def _count(self, name: str, n: float = 1, **labels) -> None:
        if self.obs is not None:
            self.obs.metrics.inc(name, n, **labels)

    def _admitted(self, req: Request, slot: int, group: int,
                  hit_pages: int) -> None:
        """A request's span begins at admission (a readmission after a
        preemption opens a new one under the same request id)."""
        self._count("sched_admissions_total")
        if self.obs is not None:
            self.obs.tracer.async_begin(
                f"request {req.rid}", req.rid, slot=slot, group=group,
                truncated=req.truncated, hit_pages=hit_pages)

    # ---- admission --------------------------------------------------------

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
        self._count("sched_submitted_total")
        if req.truncated:
            self._count("sched_truncated_total")

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s.req is not None for s in self.slots)

    def _padded(self, prompt: np.ndarray) -> np.ndarray:
        p = np.asarray(prompt, np.int32)[-self.prefill_len:]
        tok = np.zeros(self.prefill_len, np.int32)
        tok[self.prefill_len - len(p):] = p
        return tok

    # ---- paged admission --------------------------------------------------

    def _plan_hit(self, group: int, keys: list) -> tuple[int, list]:
        """Longest page- and chunk-aligned cached prefix of ``keys``,
        capped at ``prefill_len - prefill_chunk``; (hit_pages, gids), not
        yet retained."""
        pm = self.paging
        gids = []
        for k in keys:
            gid = pm.peek(group, k)
            if gid is None:
                break
            gids.append(gid)
        hit_tokens = min(len(gids) * pm.page_size,
                         self.prefill_len - self.prefill_chunk)
        hit_tokens -= hit_tokens % self._hit_gran
        hit_pages = hit_tokens // pm.page_size
        return hit_pages, gids[:hit_pages]

    def _admit_paged(self) -> None:
        """Arrival-ordered admission against the page budget, with the
        bypass-once starvation guard (module docstring)."""
        pm = self.paging
        free = [i for i, s in enumerate(self.slots) if s.req is None]
        pages_per_prompt = self.prefill_len // pm.page_size
        for req in list(self.queue):
            if not free:
                break
            tokens = self._padded(req.prompt)
            keys = page_keys(tokens, pm.page_size)
            placed = None
            for i in free:
                g = pm.slot_group(i)
                hit_pages, gids = self._plan_hit(g, keys)
                need = pages_per_prompt - hit_pages
                if pm.available_pages(g, exclude=gids) >= need:
                    placed = (i, g, hit_pages, gids)
                    break
            if placed is None:
                if req.bypassed:
                    break  # the guard: it goes next, or nothing does
                req.bypassed = True
                self._count("sched_bypasses_total")
                if self.obs is not None:
                    self.obs.tracer.instant("sched.bypass", rid=req.rid)
                continue
            i, g, hit_pages, gids = placed
            free.remove(i)
            self.queue.remove(req)
            self._admit_seq += 1
            slot = self.slots[i]
            slot.req = req
            slot.tokens = tokens
            slot.pos = hit_pages * pm.page_size  # skip the cached prefix
            slot.length = 0
            slot.seq = self._admit_seq
            slot.hit_pages = hit_pages
            slot.keys = keys
            req.bypassed = False
            self._admitted(req, i, g, hit_pages)
            pm.count_prefix_lookup(pages_per_prompt)
            for p, gid in enumerate(gids):
                pm.hit(gid)
                pm.assign(i, p, gid)
            for p in range(hit_pages, pages_per_prompt):
                pm.assign(i, p, pm.alloc_or_evict(g))

    def _preempt(self, victim: int) -> None:
        """Evict a running request for recompute: free its pages, clear
        its output, requeue it at the FRONT (it keeps its arrival
        priority)."""
        slot = self.slots[victim]
        req = slot.req
        self.paging.free_slot(victim)
        req.out.clear()
        req.t_tokens.clear()
        req.t_first = None
        req.bypassed = False
        self.queue.insert(0, req)
        self.slots[victim] = _Slot()
        self.preemptions += 1
        self._count("sched_preemptions_total")
        if self.obs is not None:
            self.obs.tracer.async_end(f"request {req.rid}", req.rid,
                                      preempted=True)

    def _ensure_decode_page(self, i: int) -> bool:
        """Make sure slot i's next decode write lands in a page it owns,
        preempting the latest-admitted other slot of its group while the
        pool is exhausted."""
        pm = self.paging
        p = self.slots[i].length // pm.page_size
        if pm.table[i, p] != 0:
            return True
        g = pm.slot_group(i)
        while True:
            try:
                pm.assign(i, p, pm.alloc_or_evict(g))
                return True
            except PoolExhaustedError:
                victims = [j for j, s in enumerate(self.slots)
                           if j != i and s.req is not None
                           and pm.slot_group(j) == g]
                if not victims:
                    raise PoolExhaustedError(
                        f"slot {i} needs a decode page but group {g} has "
                        "no free, evictable or preemptible page: the pool "
                        "is too small for a single max-length request"
                    ) from None
                self._preempt(max(victims, key=lambda j: self.slots[j].seq))

    # ---- prefill ----------------------------------------------------------

    def plan_prefill(self) -> Optional[PrefillPlan]:
        if self.paging is not None:
            self._admit_paged()
        else:
            for i, slot in enumerate(self.slots):
                if slot.req is None and self.queue:
                    slot.req = self.queue.pop(0)
                    slot.tokens = self._padded(slot.req.prompt)
                    slot.pos = 0
                    slot.length = 0
                    self._admitted(slot.req, i, 0, 0)
        chunk = self.prefill_chunk
        active, finishing = [], []
        tokens = np.zeros((self.n_slots, chunk), np.int32)
        cache_len = np.zeros(self.n_slots, np.int32)
        mask = np.zeros(self.n_slots, bool)
        for i, slot in enumerate(self.slots):
            if slot.req is None or slot.pos >= self.prefill_len:
                continue
            tokens[i] = slot.tokens[slot.pos:slot.pos + chunk]
            cache_len[i] = slot.pos
            mask[i] = True
            active.append(i)
            if slot.pos + chunk >= self.prefill_len:
                finishing.append(i)
        if not active:
            return None
        return PrefillPlan(tokens, cache_len, mask, active, finishing)

    def finish_prefill(self, plan: PrefillPlan, sampled: np.ndarray,
                       now: Optional[float] = None) -> None:
        """Advance chunk progress; record the first sampled token of the
        slots whose prompt is now written."""
        for i in plan.active:
            slot = self.slots[i]
            slot.pos += self.prefill_chunk
            if self.obs is not None and i not in plan.finishing:
                self.obs.tracer.async_instant(
                    "prefill_chunk", slot.req.rid, slot=i,
                    pos=slot.pos, of=self.prefill_len)
        for i in plan.finishing:
            slot = self.slots[i]
            req = slot.req
            req.out.append(int(sampled[i]))
            if now is not None:
                req.t_tokens.append(now)
            if req.t_first is None:
                req.t_first = now
                if self.obs is not None:
                    self.obs.tracer.async_instant("first_token", req.rid,
                                                  slot=i)
                    if req.t_submit is not None and now is not None:
                        self.obs.metrics.observe("serve_ttft_seconds",
                                                 now - req.t_submit)
            slot.length = self.prefill_len
            if self.paging is not None:
                # the prompt is written: publish its own (non-hit) pages
                # under their chain keys; decode starts on a fresh page,
                # so these stay immutable
                pm = self.paging
                g = pm.slot_group(i)
                for p in range(slot.hit_pages,
                               self.prefill_len // pm.page_size):
                    pm.register_prefix(g, slot.keys[p], int(pm.table[i, p]))
            if len(req.out) >= req.max_new:
                self._finish(i, now)

    # ---- decode -----------------------------------------------------------

    def plan_decode(self) -> Optional[DecodePlan]:
        if self.paging is not None:
            # lazy pages for this round's writes, before the plan is
            # built: a preempted victim drops out of the round
            for i, slot in enumerate(self.slots):
                if slot.req is not None and slot.pos >= self.prefill_len:
                    self._ensure_decode_page(i)
        tokens = np.zeros((self.n_slots, 1), np.int32)
        lengths = np.zeros(self.n_slots, np.int32)
        mask = np.zeros(self.n_slots, bool)
        active = []
        for i, slot in enumerate(self.slots):
            if slot.req is None or slot.pos < self.prefill_len:
                continue
            tokens[i, 0] = slot.req.out[-1]
            lengths[i] = slot.length
            mask[i] = True
            active.append(i)
        if not active:
            return None
        # the mask keeps a decode call's placeholder rows out of slots
        # that are mid-prefill or empty
        return DecodePlan(tokens, lengths, mask, active)

    def finish_decode(self, plan: DecodePlan, sampled: np.ndarray,
                      now: Optional[float] = None) -> None:
        for i in plan.active:
            slot = self.slots[i]
            req = slot.req
            req.out.append(int(sampled[i]))
            if now is not None:
                if self.obs is not None and req.t_tokens:
                    self.obs.metrics.observe("serve_itl_seconds",
                                             now - req.t_tokens[-1])
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
        if self.paging is not None:
            self.paging.free_slot(i)  # the pages recycle
        self.slots[i] = _Slot()
        self._count("sched_finished_total")
        if self.obs is not None:
            self.obs.tracer.async_end(f"request {req.rid}", req.rid,
                                      tokens=len(req.out))
