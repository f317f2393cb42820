"""The port's paging host logic and paged cache addressing against the
JAX package's: ``PageManager`` and ``page_keys`` on the same operation
sequences, the scheduler's plans over the same request streams (slot,
chunked and paged, with the bypass-once guard and preemption), and
``paged_write`` / ``paged_gather`` on the same pools and tables.

Host bookkeeping is integer and hash arithmetic, so every comparison is
exact; the paged writes and gathers move f32 values without arithmetic,
so they are compared bit for bit too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import paged_gather as jax_paged_gather
from repro.models.attention import paged_write as jax_paged_write
from repro.serving import paging as jpaging
from repro.serving.scheduler import Request as JaxRequest
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro_torch.models.attention import paged_gather, paged_write
from repro_torch.models.cache import CacheView
from repro_torch.serving import paging as tpaging
from repro_torch.serving.scheduler import Request, Scheduler

# ---------------------------------------------------------------------------
# PageManager and page_keys
# ---------------------------------------------------------------------------


def _pms(**kw):
    base = dict(page_size=4, pages_per_group=8, slots=2, max_seq=16)
    base.update(kw)
    return jpaging.PageManager(**base), tpaging.PageManager(**base)


def _state(pm) -> dict:
    """Everything a PageManager holds, in comparable form."""
    return {
        "free": [list(f) for f in pm._free],
        "ref": pm._ref.tolist(),
        "cached": dict(pm._cached),
        "prefix": [dict(p) for p in pm._prefix],
        "lru": dict(pm._lru),
        "slot_pages": [list(s) for s in pm._slot_pages],
        "table": pm.table.tolist(),
        "stats": (pm.stats.allocs, pm.stats.prefix_lookup_pages,
                  pm.stats.prefix_hit_pages, pm.stats.evictions,
                  pm.stats.forks, pm.stats.prefix_hit_rate),
        "geometry": (pm.stride, pm.rows, pm.pages_per_slot, pm.capacity,
                     pm.used_pages(), pm.utilization()),
    }


def _both(pms, op, *args):
    """Apply ``op`` to both managers: equal results, or the same error
    type from each; then equal states."""
    out = []
    for pm in pms:
        try:
            out.append(("ok", getattr(pm, op)(*args)))
        except (RuntimeError, AssertionError) as e:
            out.append(("raise", "exhausted" if "Exhausted" in
                        type(e).__name__ else type(e).__name__))
    assert out[0] == out[1], (op, args, out)
    assert _state(pms[0]) == _state(pms[1]), (op, args)
    return out[0]


def test_alloc_release_recycle_and_exhaustion_match_jax():
    pms = _pms()
    a = _both(pms, "alloc", 0)[1]
    b = _both(pms, "alloc", 0)[1]
    assert a != b and a % pms[1].stride and b % pms[1].stride
    _both(pms, "release", a)
    assert _both(pms, "alloc", 0)[1] == a  # LIFO recycle
    for _ in range(6):
        _both(pms, "alloc", 0)
    assert _both(pms, "alloc", 0) == ("raise", "exhausted")
    with pytest.raises(tpaging.PoolExhaustedError):
        pms[1].alloc(0)


def test_refcounts_fork_and_sharing_match_jax():
    pms = _pms()
    a = _both(pms, "alloc", 0)[1]
    _both(pms, "retain", a)
    assert _both(pms, "is_shared", a) == ("ok", True)
    new = _both(pms, "fork", a)[1]  # copy-on-write: a private page
    assert new != a
    assert _both(pms, "is_shared", new) == ("ok", False)
    assert _both(pms, "is_shared", a) == ("ok", False)
    _both(pms, "release", a)
    assert pms[1].stats.forks == 1


def test_prefix_cache_lru_and_eviction_match_jax():
    pms = _pms(pages_per_group=4)
    pages = [_both(pms, "alloc", 0)[1] for _ in range(3)]
    keys = [bytes([i]) * 16 for i in range(3)]
    for k, g in zip(keys, pages):
        _both(pms, "register_prefix", 0, k, g)
    _both(pms, "register_prefix", 0, keys[0], pages[1])  # first writer wins
    for g in pages:
        _both(pms, "release", g)
    assert _both(pms, "evictable_pages", 0) == ("ok", 3)
    assert _both(pms, "available_pages", 0, [pages[2]]) == ("ok", 3)
    assert _both(pms, "peek", 0, keys[1]) == ("ok", pages[1])
    _both(pms, "hit", pages[0])  # page 0 becomes the most recently used
    assert _both(pms, "evict_lru", 0) == ("ok", True)  # pages[1] goes
    assert _both(pms, "peek", 0, keys[1]) == ("ok", None)
    _both(pms, "alloc", 0)
    _both(pms, "alloc_or_evict", 0)  # the last free page
    assert _both(pms, "alloc_or_evict", 0) == ("ok", pages[2])  # evicted
    assert _both(pms, "alloc_or_evict", 0) == ("raise", "exhausted")
    _both(pms, "release", pages[0])
    assert _both(pms, "alloc_or_evict", 0) == ("ok", pages[0])


def test_slots_tables_and_grouped_pools_match_jax():
    pms = _pms(slots=4, groups=2)
    assert [pms[1].slot_group(i) for i in range(4)] == [0, 0, 1, 1]
    for slot, group in ((0, 0), (2, 1), (3, 1)):
        for p in range(2):
            _both(pms, "assign", slot, p, _both(pms, "alloc", group)[1])
    assert _both(pms, "writable", 2, 1) == ("ok", True)
    assert _both(pms, "writable", 1, 0) == ("ok", False)
    a = int(pms[1].table[0, 0])
    _both(pms, "register_prefix", 0, b"k" * 16, a)
    assert _both(pms, "peek", 1, b"k" * 16) == ("ok", None)
    assert _both(pms, "group_of", int(pms[1].table[2, 0])) == ("ok", 1)
    _both(pms, "free_slot", 0)
    _both(pms, "free_slot", 2)
    assert _both(pms, "free_pages", 0) == ("ok", 7)  # a stays cached
    assert _both(pms, "evictable_pages", 0) == ("ok", 1)


@pytest.mark.parametrize("seed", range(4))
def test_random_operation_sequences_match_jax(seed):
    """300 random operations on both managers (with prefix sharing and
    two groups): equal results and equal states after every one."""
    rng = np.random.default_rng(seed)
    pms = _pms(slots=4, groups=2, pages_per_group=6)
    held = []  # (gid) references the test owns
    for _ in range(300):
        op = rng.choice(["alloc", "alloc_or_evict", "release", "retain",
                         "register", "hit", "evict", "fork", "assign",
                         "free_slot"])
        g = int(rng.integers(2))
        if op in ("alloc", "alloc_or_evict"):
            r = _both(pms, op, g)
            if r[0] == "ok":
                held.append(r[1])
        elif op in ("release", "retain", "fork") and held:
            gid = held[int(rng.integers(len(held)))]
            if op == "release":
                held.remove(gid)
            r = _both(pms, op, gid)
            if op == "retain":
                held.append(gid)
            elif op == "fork" and r[0] == "ok":
                held.remove(gid)
                held.append(r[1])
        elif op == "register" and held:
            gid = held[int(rng.integers(len(held)))]
            key = bytes([int(rng.integers(6))]) * 16
            _both(pms, "register_prefix", pms[1].group_of(gid), key, gid)
        elif op == "hit":
            key = bytes([int(rng.integers(6))]) * 16
            gid = pms[1].peek(g, key)
            if gid is not None:
                _both(pms, "hit", gid)
                held.append(gid)
        elif op == "evict":
            _both(pms, "evict_lru", g)
        elif op == "assign" and held:
            slot = int(rng.integers(4))
            free = np.flatnonzero(pms[1].table[slot] == 0)
            if len(free):
                gid = held.pop(int(rng.integers(len(held))))
                _both(pms, "assign", slot, int(free[0]), gid)
        elif op == "free_slot":
            _both(pms, "free_slot", int(rng.integers(4)))


@pytest.mark.parametrize("kw,match", [
    (dict(page_size=5), "multiple"),
    (dict(pages_per_group=3), "full-length"),
    (dict(slots=3, groups=2), "groups"),
])
def test_manager_validation_errors_match_jax(kw, match):
    base = dict(page_size=4, pages_per_group=8, slots=2, max_seq=16)
    base.update(kw)
    with pytest.raises(ValueError, match=match):
        jpaging.PageManager(**base)
    with pytest.raises(ValueError, match=match):
        tpaging.PageManager(**base)


@pytest.mark.parametrize("n,page", [(16, 4), (7, 4), (64, 8), (12, 1)])
def test_page_keys_bytes_equal_jax(n, page):
    rng = np.random.default_rng(n)
    toks = rng.integers(0, 60000, n).astype(np.int32)
    assert tpaging.page_keys(toks, page) == jpaging.page_keys(toks, page)
    b = toks.copy()
    b[min(5, n - 1)] += 1
    ka, kb = tpaging.page_keys(toks, page), tpaging.page_keys(b, page)
    first = min(5, n - 1) // page
    assert ka[:first] == kb[:first]
    assert all(x != y for x, y in zip(ka[first:], kb[first:]))  # chained


def test_prefix_granularity_matches_jax():
    for ps, chunk in ((4, 4), (4, 8), (6, 4), (32, 64)):
        assert (tpaging.prefix_granularity(ps, chunk)
                == jpaging.prefix_granularity(ps, chunk))


# ---------------------------------------------------------------------------
# scheduler plans, step by step
# ---------------------------------------------------------------------------


def _plan_state(plan):
    if plan is None:
        return None
    d = {"tokens": plan.tokens.tolist(), "mask": plan.mask.tolist(),
         "active": list(plan.active)}
    if hasattr(plan, "finishing"):
        d.update(cache_len=plan.cache_len.tolist(),
                 finishing=list(plan.finishing))
    else:
        d.update(lengths=plan.lengths.tolist())
    return d


def _sched_state(s):
    st = {"queue": [(r.rid, r.bypassed) for r in s.queue],
          "finished": [(r.rid, list(r.out)) for r in s.finished],
          "slots": [(sl.req.rid if sl.req is not None else None, sl.pos,
                     sl.length, sl.seq, sl.hit_pages) for sl in s.slots],
          "preemptions": s.preemptions}
    if s.paging is not None:
        st["pages"] = _state(s.paging)
    return st


def _prompts(n, seed, lens=(8, 5, 8, 3, 8, 6, 8), shared=True):
    rng = np.random.default_rng(seed)
    ps = [rng.integers(1, 500, size=lens[i % len(lens)]).astype(np.int32)
          for i in range(n)]
    if shared and n > 4:
        ps[2][:4] = ps[0][:4]
        ps[4] = ps[0].copy()
    return ps


def _drive(scheds, prompts, max_news, *, steps=200):
    """Run both schedulers on the same stream with the same sampled
    tokens (a function of slot and step), comparing the plans, the
    scheduler state and the page state after every call."""
    for s, cls in zip(scheds, (JaxRequest, Request)):
        for i, (p, m) in enumerate(zip(prompts, max_news)):
            s.submit(cls(rid=i, prompt=p.copy(), max_new=m))
    for step in range(steps):
        if not scheds[1].has_work:
            break
        assert scheds[0].has_work
        pf = [s.plan_prefill() for s in scheds]
        assert _plan_state(pf[0]) == _plan_state(pf[1])
        assert _sched_state(scheds[0]) == _sched_state(scheds[1])
        if pf[1] is not None:
            toks = (np.arange(len(scheds[1].slots)) * 7 + step) % 500
            for s, p in zip(scheds, pf):
                s.finish_prefill(p, toks)
        dc = [s.plan_decode() for s in scheds]
        assert _plan_state(dc[0]) == _plan_state(dc[1])
        assert _sched_state(scheds[0]) == _sched_state(scheds[1])
        if dc[1] is not None:
            toks = (np.arange(len(scheds[1].slots)) * 11 + step) % 500
            for s, d in zip(scheds, dc):
                s.finish_decode(d, toks)
        assert _sched_state(scheds[0]) == _sched_state(scheds[1])
    assert not scheds[1].has_work and not scheds[0].has_work
    return scheds


@pytest.mark.parametrize("chunk", [None, 4, 2])
def test_slot_scheduler_plans_match_jax(chunk):
    kw = dict(slots=2, max_seq=32, prefill_len=8, prefill_chunk=chunk)
    _drive((JaxScheduler(**kw), Scheduler(**kw)), _prompts(7, 0),
           [3 + i % 4 for i in range(7)])


@pytest.mark.parametrize("chunk,page,pool", [
    (4, 4, 16), (None, 8, 8), (2, 4, 12), (4, 4, 9)],
    ids=["chunk4-page4", "full-page8", "chunk2-page4", "tight-pool"])
def test_paged_scheduler_plans_match_jax(chunk, page, pool):
    """Shared prefixes hit the cache (chunk- and page-aligned), decode
    takes pages lazily, and the tight pool preempts: every plan, block
    table, refcount and queue equal to JAX's."""
    mk = dict(page_size=page, pages_per_group=pool, slots=2, max_seq=32)
    sk = dict(slots=2, max_seq=32, prefill_len=8, prefill_chunk=chunk)
    scheds = _drive(
        (JaxScheduler(paging=jpaging.PageManager(**mk), **sk),
         Scheduler(paging=tpaging.PageManager(**mk), **sk)),
        _prompts(7, 1), [18, 5, 18, 3, 6, 4, 18])
    if pool == 9:
        assert scheds[1].preemptions > 0
    # a hit stops a chunk short of the prompt, so a whole-prompt chunk
    # never hits
    assert (scheds[1].paging.stats.prefix_hit_pages > 0) == (chunk is not None)


def test_admission_is_arrival_ordered_like_jax():
    pms = _pms(slots=2, pages_per_group=8)
    scheds = (JaxScheduler(slots=2, max_seq=16, prefill_len=8,
                           prefill_chunk=4, paging=pms[0]),
              Scheduler(slots=2, max_seq=16, prefill_len=8, prefill_chunk=4,
                        paging=pms[1]))
    for s, cls in zip(scheds, (JaxRequest, Request)):
        for i in range(4):
            s.submit(cls(rid=i, prompt=_prompts(4, 2)[i], max_new=4))
    plans = [s.plan_prefill() for s in scheds]
    assert _plan_state(plans[0]) == _plan_state(plans[1])
    assert [scheds[1].slots[i].req.rid for i in plans[1].active] == [0, 1]


def test_starvation_guard_bypass_once_like_jax():
    """A request that does not fit is passed once; the second time
    admission stops behind it; it goes first when pages free up."""
    pms = _pms(slots=2, pages_per_group=4, max_seq=16)
    kw = dict(slots=2, max_seq=16, prefill_len=8, prefill_chunk=4)
    scheds = (JaxScheduler(paging=pms[0], **kw),
              Scheduler(paging=pms[1], **kw))
    ps = _prompts(3, 3, lens=(8,), shared=False)
    for s, cls in zip(scheds, (JaxRequest, Request)):
        s.submit(cls(rid=0, prompt=ps[0], max_new=4))
        s.plan_prefill()
    blockers = [_both(pms, "alloc", 0)[1] for _ in range(2)]
    for s, cls in zip(scheds, (JaxRequest, Request)):
        s.submit(cls(rid=1, prompt=ps[1], max_new=4))
        s.submit(cls(rid=2, prompt=ps[2], max_new=4))
    for release in (None, blockers[0], blockers[1]):
        if release is not None:
            _both(pms, "release", release)
        plans = [s.plan_prefill() for s in scheds]
        assert _plan_state(plans[0]) == _plan_state(plans[1])
        assert _sched_state(scheds[0]) == _sched_state(scheds[1])
        if release is None:
            assert [r.bypassed for r in scheds[1].queue] == [True, True]
        elif release == blockers[0]:
            assert [r.rid for r in scheds[1].queue] == [1, 2]
    assert scheds[1].slots[1].req.rid == 1
    assert not scheds[1].slots[1].req.bypassed


def test_preemption_requeues_at_the_front_like_jax():
    pms = _pms(slots=2, pages_per_group=4, max_seq=16)
    kw = dict(slots=2, max_seq=16, prefill_len=8, prefill_chunk=4)
    scheds = (JaxScheduler(paging=pms[0], **kw),
              Scheduler(paging=pms[1], **kw))
    ps = _prompts(2, 4, lens=(8,), shared=False)
    for s, cls in zip(scheds, (JaxRequest, Request)):
        s.submit(cls(rid=0, prompt=ps[0], max_new=4))
        s.plan_prefill()
        s.submit(cls(rid=5, prompt=ps[1], max_new=4))
        s._preempt(0)
    assert _sched_state(scheds[0]) == _sched_state(scheds[1])
    assert [r.rid for r in scheds[1].queue] == [0, 5]
    assert scheds[1].preemptions == 1


@pytest.mark.parametrize("kw,match", [
    (dict(prefill_chunk=3), "multiple of prefill_chunk"),
    (dict(paging="ps16"), "page_size"),
])
def test_scheduler_validation_matches_jax(kw, match):
    def make(cls, pm_cls):
        k = dict(kw)
        if k.get("paging") == "ps16":
            k["paging"] = pm_cls.PageManager(page_size=16, pages_per_group=8,
                                             slots=2, max_seq=32)
        return cls(slots=2, max_seq=32, prefill_len=8, **k)

    with pytest.raises(ValueError, match=match):
        make(JaxScheduler, jpaging)
    with pytest.raises(ValueError, match=match):
        make(Scheduler, tpaging)


# ---------------------------------------------------------------------------
# paged cache writes and reads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 3, 4])
def test_paged_write_and_gather_match_jax(s):
    """Random pool and table; a masked-off slot and a write past the
    table's last page land in the null page (row 0), every other row
    equals JAX's bit for bit; the gathered views are equal."""
    rng = np.random.default_rng(s)
    rows, ps, n_pages, b = 9, 4, 3, 4
    pool = rng.standard_normal((rows, ps, 2, 8)).astype(np.float32)
    new = rng.standard_normal((b, s, 2, 8)).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, rows))[:n_pages]
                      for _ in range(b)]).astype(np.int32)
    table[1, 2] = 0  # an unassigned page reads the null page
    cache_len = np.array([0, 5, ps * n_pages - 1, 2], np.int32)
    mask = np.array([True, True, True, False])
    want = np.asarray(jax_paged_write(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(cache_len),
        jnp.asarray(table), jnp.asarray(mask)))
    got = torch.from_numpy(pool.copy())
    paged_write(got, torch.from_numpy(new), torch.from_numpy(cache_len),
                torch.from_numpy(table), torch.from_numpy(mask))
    np.testing.assert_array_equal(got[1:].numpy(), want[1:])
    # slot 3 (masked off) and slot 2's overflow rows went to the null page
    untouched = [r for r in range(1, rows)
                 if r not in table[:3].ravel()]
    np.testing.assert_array_equal(got[untouched].numpy(), pool[untouched])
    if s > 1:  # slot 2 runs past its table
        assert not np.array_equal(got[0].numpy(), pool[0])
    gw = np.asarray(jax_paged_gather(jnp.asarray(want), jnp.asarray(table)))
    gt = paged_gather(torch.from_numpy(want.copy()), torch.from_numpy(table))
    assert gt.shape == (b, n_pages * ps, 2, 8)
    np.testing.assert_array_equal(gt.numpy(), gw)


def test_paged_view_needs_a_write_mask():
    with pytest.raises(TypeError, match="block_table AND write_mask"):
        CacheView.decode(np.zeros(2, np.int32),
                         block_table=np.zeros((2, 2), np.int32))
    view = CacheView.chunk(np.zeros(2, np.int32), np.ones(2, bool),
                           block_table=np.zeros((2, 2), np.int32))
    assert view.paged and view.offset_mode
    assert not CacheView.decode(np.zeros(2, np.int32)).paged
