"""Paged KV cache: a pool of fixed-size pages behind a block table (port
of ``repro.serving.paging``; host bookkeeping only, no device work).

Instead of binding a request to a fixed-shape cache slot for its whole
lifetime, the cache is a pool of ``page_size``-token pages and every
slot owns a *block table* row: logical position ``p`` of a slot lives in
page ``table[slot, p // page_size]``. The device side reads and writes
through that indirection (``repro_torch.models.attention.paged_write``
and ``paged_gather``); this module owns the mapping:

  * **Pool accounting**: per-group free lists, allocation, release;
    freed pages recycle at once into other requests.
  * **Refcounts / copy-on-write**: a page may be referenced by many
    slots (shared prompt prefixes). Shared pages are read-only; ``fork``
    gives a writer a private page in place of a shared one (metadata
    only). The scheduler's page-aligned prefix hits never need it.
  * **Prefix cache**: full pages of prefilled prompt are registered
    under a hash chain of the *padded* prompt blocks (``page_keys``). A
    later request whose padded prompt starts with the same blocks
    references those pages instead of recomputing them. Cached pages
    with no active reference stay resident as evictable until pool
    pressure reclaims them (LRU).

Device layout: local row 0 of every group's sub-pool is the **null
page**, where masked-off or out-of-range writes land and which no block
table references for reads. ``groups`` splits the pool into independent
sub-pools (one per data-parallel shard); global page id ``g * stride +
local`` (``stride = pages_per_group + 1``) maps to local row ``id %
stride``. With one device ``groups`` is 1.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Optional

import numpy as np

from repro_torch import obs as _obs

__all__ = ["PageManager", "PageStats", "PoolExhaustedError", "page_keys",
           "prefix_granularity"]


class PoolExhaustedError(RuntimeError):
    """No free or evictable page is available in the requested group."""


def page_keys(tokens: np.ndarray, page_size: int) -> list[bytes]:
    """Hash chain over the full pages of a (padded) prompt-token block:
    ``key[p]`` is the 16-byte blake2b digest of ``key[p-1]`` and page
    ``p``'s int32 tokens, so two prompts share page ``p`` iff they agree
    on all of the first ``(p+1) * page_size`` tokens."""
    out: list[bytes] = []
    h = b""
    toks = np.asarray(tokens, np.int32)
    for p in range(len(toks) // page_size):
        blk = toks[p * page_size:(p + 1) * page_size].tobytes()
        h = hashlib.blake2b(h + blk, digest_size=16).digest()
        out.append(h)
    return out


@dataclasses.dataclass
class PageStats:
    """Counters the engine reports through ``throughput_stats()``."""

    allocs: int = 0
    prefix_lookup_pages: int = 0  # pages probed against the cache
    prefix_hit_pages: int = 0     # pages reused from it
    evictions: int = 0
    forks: int = 0

    @property
    def prefix_hit_rate(self) -> float:
        if self.prefix_lookup_pages == 0:
            return 0.0
        return self.prefix_hit_pages / self.prefix_lookup_pages


class PageManager:
    """The page pool, the block tables, refcounts and the prefix cache.
    The engine copies ``self.table`` (``(slots, pages_per_slot)`` int32
    of *global* page ids, 0 = null) to the device each step."""

    def __init__(self, *, page_size: int, pages_per_group: int,
                 slots: int, max_seq: int, groups: int = 1,
                 prefix_cache: bool = True, obs=None):
        if max_seq % page_size:
            raise ValueError(
                f"max_seq={max_seq} must be a multiple of "
                f"page_size={page_size} (block tables are fixed-shape)")
        if slots % groups:
            raise ValueError(
                f"slots={slots} must divide over groups={groups}")
        if pages_per_group < max_seq // page_size:
            raise ValueError(
                f"pages_per_group={pages_per_group} cannot hold even one "
                f"full-length request ({max_seq // page_size} pages): no "
                "admission could be guaranteed progress")
        self.page_size = page_size
        self.pages_per_group = pages_per_group
        self.groups = groups
        self.n_slots = slots
        self.max_seq = max_seq
        self.pages_per_slot = max_seq // page_size
        self.stride = pages_per_group + 1  # +1: local row 0 = null page
        self.rows = groups * self.stride   # device pool leading dim
        self.prefix_enabled = prefix_cache
        # global page id g*stride + j, j in [1, pages_per_group]
        self._free: list[list[int]] = [
            [g * self.stride + j for j in range(pages_per_group, 0, -1)]
            for g in range(groups)
        ]
        self._ref = np.zeros(self.rows, np.int32)
        self._cached: dict[int, bytes] = {}          # gid -> key
        self._prefix: list[dict[bytes, int]] = [dict() for _ in range(groups)]
        self._lru: dict[int, int] = {}               # gid -> last-use stamp
        self._clock = 0
        self._slot_pages: list[list[int]] = [[] for _ in range(slots)]
        self.table = np.zeros((slots, self.pages_per_slot), np.int32)
        self.stats = PageStats()
        # PageStats stays the engine's source of truth; with a bundle
        # every stats change also increments a page_* / prefix_* counter
        self._obs = obs if obs is not None else _obs.get_obs()

    def _count(self, name: str, n: float = 1) -> None:
        if self._obs is not None:
            self._obs.metrics.inc(name, n)

    def count_prefix_lookup(self, pages: int) -> None:
        """Record ``pages`` prefix-cache probes (admission planning)."""
        self.stats.prefix_lookup_pages += pages
        self._count("prefix_lookup_pages_total", pages)

    # ---- geometry ---------------------------------------------------------

    def slot_group(self, slot: int) -> int:
        """Contiguous slot -> group mapping (slots split over the data
        shards in order)."""
        return slot // (self.n_slots // self.groups)

    def group_of(self, gid: int) -> int:
        return gid // self.stride

    @property
    def capacity(self) -> int:
        return self.groups * self.pages_per_group

    def used_pages(self) -> int:
        """Pages referenced by at least one slot (cache-only pages with
        no reader count as reclaimable, not used)."""
        return int((self._ref > 0).sum())

    def utilization(self) -> float:
        return self.used_pages() / self.capacity

    def free_pages(self, group: int) -> int:
        return len(self._free[group])

    def evictable_pages(self, group: int, exclude=()) -> int:
        ex = set(exclude)
        return sum(1 for gid in self._cached
                   if self.group_of(gid) == group and self._ref[gid] == 0
                   and gid not in ex)

    def available_pages(self, group: int, exclude=()) -> int:
        """Free plus evictable: the admission budget."""
        return self.free_pages(group) + self.evictable_pages(group, exclude)

    # ---- allocation / refcounts ------------------------------------------

    def alloc(self, group: int) -> int:
        if not self._free[group]:
            raise PoolExhaustedError(
                f"group {group}: no free page "
                f"({self.pages_per_group} total)")
        gid = self._free[group].pop()
        self._ref[gid] = 1
        self.stats.allocs += 1
        self._count("page_allocs_total")
        return gid

    def alloc_or_evict(self, group: int) -> int:
        """Allocate, reclaiming LRU cache-only pages under pressure."""
        if not self._free[group] and not self.evict_lru(group):
            raise PoolExhaustedError(
                f"group {group}: pool exhausted and nothing evictable "
                f"({self.pages_per_group} pages, all actively referenced)")
        return self.alloc(group)

    def retain(self, gid: int) -> None:
        assert gid % self.stride != 0, "null page is not refcountable"
        self._ref[gid] += 1

    def release(self, gid: int) -> None:
        assert self._ref[gid] > 0, f"release of unreferenced page {gid}"
        self._ref[gid] -= 1
        if self._ref[gid] == 0 and gid not in self._cached:
            self._free[self.group_of(gid)].append(gid)
            self._count("page_frees_total")

    def is_shared(self, gid: int) -> bool:
        """A page its holder may NOT write: other readers exist, or the
        prefix cache could hand it to one at any time."""
        return self._ref[gid] > 1 or gid in self._cached

    def fork(self, gid: int) -> int:
        """Copy-on-write, the metadata half: a private page in place of
        shared ``gid`` (the caller copies the contents before writing)."""
        group = self.group_of(gid)
        new = self.alloc_or_evict(group)
        self.release(gid)
        self.stats.forks += 1
        self._count("page_forks_total")
        return new

    # ---- prefix cache -----------------------------------------------------

    def peek(self, group: int, key: bytes) -> Optional[int]:
        """Cache probe without retaining (admission planning)."""
        return self._prefix[group].get(key)

    def hit(self, gid: int) -> None:
        """Commit a planned prefix reuse: retain, LRU bump, stats."""
        self.retain(gid)
        self._clock += 1
        self._lru[gid] = self._clock
        self.stats.prefix_hit_pages += 1
        self._count("prefix_hit_pages_total")

    def register_prefix(self, group: int, key: bytes, gid: int) -> None:
        """Publish a fully written page under its chain key. The first
        writer wins; a concurrent duplicate keeps its private copy."""
        if not self.prefix_enabled or key in self._prefix[group]:
            return
        self._prefix[group][key] = gid
        self._cached[gid] = key
        self._clock += 1
        self._lru[gid] = self._clock

    def evict_lru(self, group: int) -> bool:
        """Reclaim the least recently used cache-only page (refcount 0)
        of ``group`` into the free list; False when none qualifies."""
        victims = [gid for gid in self._cached
                   if self.group_of(gid) == group and self._ref[gid] == 0]
        if not victims:
            return False
        gid = min(victims, key=lambda g: self._lru.get(g, 0))
        key = self._cached.pop(gid)
        del self._prefix[group][key]
        self._lru.pop(gid, None)
        self._free[group].append(gid)
        self.stats.evictions += 1
        self._count("page_evictions_total")
        return True

    # ---- slot bookkeeping -------------------------------------------------

    def assign(self, slot: int, page_idx: int, gid: int) -> None:
        assert self.table[slot, page_idx] == 0, (slot, page_idx)
        self.table[slot, page_idx] = gid
        self._slot_pages[slot].append(gid)

    def writable(self, slot: int, page_idx: int) -> bool:
        gid = int(self.table[slot, page_idx])
        return gid != 0 and not self.is_shared(gid)

    def free_slot(self, slot: int) -> None:
        """Release every page the slot references and clear its table
        row; a page still held by the prefix cache stays resident
        (evictable) for later hits."""
        for gid in self._slot_pages[slot]:
            self.release(gid)
        self._slot_pages[slot] = []
        self.table[slot, :] = 0


def prefix_granularity(page_size: int, chunk: int) -> int:
    """Usable prefix-hit sizes: multiples of lcm(page, chunk), so reused
    pages are whole and the rest of the prompt still splits into
    fixed-shape prefill chunks."""
    return math.lcm(page_size, chunk)
