"""Serving engine: continuous batching over fixed-shape steps (port of
``repro.serving.engine.ServeEngine``: the slot cache, chunked prefill,
and the paged cache with prefix caching and preemption).

The host loop is thin: per-request decisions live in
:mod:`repro_torch.serving.scheduler`, sampling runs on the device, and
only the sampled ``(slots,)`` token ids come back to the host each step.
Every step has a fixed shape: prefill runs all slots over
``prefill_chunk`` tokens (``prefill_len`` unless chunked), decode all
slots over one token. The head projects only the position a step
samples. Only the slots a step planned for keep their new cache rows
(the step's ``CacheView.write_mask``; the slots outside it write back
the rows they hold, or the null page of the paged pool), so the cache is
written in place; the JAX engine computes a new cache and merges those
slots back, which gives the same cache.

On the card each step is captured once as a CUDA graph and then only
replayed (:class:`StepGraph`), the counterpart of the JAX engine's
``jax.jit`` of each step: the first call of a step runs it eagerly on a
side stream (the warm-up, which also makes every mask plan and kernel
scratch buffer the step needs), then captures it. The tokens, offsets,
write mask and block table go into static device buffers before each
replay; every bounds check runs on the host, from the numpy plan, before
that copy. ``compiled_cache_sizes()`` counts the graphs of each step
kind (the distinct step shapes built, on the CPU); after warm-up it is
``{"prefill": 1, "decode": 1}``. A capture that fails raises: nothing
falls back to eager. ``graphs=False`` runs every step eagerly.

The registry's dispatch counters and the kernels' launch counters are
Python: they advance when a step runs eagerly and while it is captured,
not on replay. Each captured graph records what its capture added
(:class:`CapturedStep`), so what ran on the card is the eager count
plus each graph's capture count times its replays (:func:`ran_counts`).

Observability (``obs=``, else the process-wide bundle of
:mod:`repro_torch.obs`; off by default, and then every site is one
``is not None`` check): spans ``engine.prefill`` / ``engine.decode``
around each step's host call, which holds the host's work, the copies,
the graph's replay (or the eager step) and the sync that reads the
sampled ids back; per-step instants and gauges; the scheduler's and the
pages' counters. The registry mirrors each dispatch to
``kernel_dispatch_total``, but not while a graph is captured, and the
engine adds a graph's recorded dispatches at each replay: the metric
counts what ran, as an eager serve's counts would. Obs stays outside the
captured steps, so turning it on changes no graph.

``autotune_blocks=True`` sweeps, at construction and before any step is
captured, every compressed GEMM shape the steps will issue (prefill M =
slots x prefill_chunk, decode M = slots; int8 keys for int8 weights) and
the block-sparse attention tile of each masked layer at the full
prefill (MLA's at dk = nope + rope, dv = v_head_dim), where the autotune
cache has no entry
(:mod:`repro_torch.kernels.autotune`); the captured steps then launch
the winners.
"""
from __future__ import annotations

import functools
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.configs.base import AttnConfig
from repro_torch.kernels import autotune, capture
from repro_torch.kernels.capture import CapturedStep
from repro_torch.kernels.indexmac.ops import decode_m_max
from repro_torch.models.attention import _check_cache_len
from repro_torch.models.cache import CacheView
from repro_torch.models.common import Linear, check_quantize
from repro_torch.models.transformer import LM
from repro_torch.quant.calibrate import quantize_tree
from repro_torch.quant.qnmweight import QNMWeight
from repro_torch.serving.paging import PageManager
from repro_torch.serving.sampling import make_sampler
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["CapturedStep", "Request", "ServeEngine", "ShardedServeEngine",
           "StepGraph", "make_serve_steps", "ran_counts"]


class StepGraph(capture.Graphed):
    """A serving step ``fn(caches, **inputs) -> tensor`` as a
    :class:`~repro_torch.kernels.capture.Graphed`: the caches are held
    (the graph writes them by address; their identity is part of the
    signature), ``check(caches, **inputs)`` is the step's bounds check on
    the host arrays, and ``step(caches, **inputs)`` takes the step's host
    arrays (tokens, offsets, write mask, block table)."""


def _host_check(lm: LM, caches, tokens, cache_len=None, mask=None,
                table=None, enc_input=None) -> None:
    """The bounds check of a step, on the host: offsets plus the step's
    tokens within the attention caches (a paged view's: pages_per_slot *
    page_size) and a learned position table, and an encoder input of
    the cross caches' length. A
    model without attention has no bound here; the scheduler keeps a
    slot within ``max_seq``."""
    if enc_input is not None and enc_input.shape[1] != lm.cfg.encoder_seq:
        raise ValueError(
            f"enc_input of {enc_input.shape[1]} positions; the cross "
            f"caches hold encoder_seq = {lm.cfg.encoder_seq}")
    attn = lm.attn_cache(caches)
    if cache_len is None or attn is None:
        return  # prefill from 0: LM.forward checks it without the card
    bound = attn.shape[1]
    if table is not None:
        bound *= table.shape[1]
    if lm.pos is not None:  # the learned position table's rows
        bound = min(bound, lm.cfg.max_seq)
    _check_cache_len(cache_len, tokens.shape[1], bound)


def make_serve_steps(lm: LM, *, graphs: bool = True,
                     sampler: Optional[Callable] = None):
    """(prefill_step, decode_step) of ``lm`` as :class:`StepGraph` s: the
    counterpart of the JAX package's ``make_serve_steps(lm, jit=True)``.

      prefill_step(caches, tokens=, cache_len=None, mask=None, table=None,
                   enc_input=None)
      decode_step(caches, tokens=, cache_len=, mask=None, table=None)

    return the logits of the last position, (B, V) f32, or the
    ``sampler``'s ids where one is given (it is called with no
    generator: greedy). Prefill without ``cache_len`` writes from
    position 0 (``CacheView.prefill``), with it a chunk at those offsets;
    a ``table`` addresses the paged pool (and needs ``mask``). On the
    card they are captured once per input signature and replayed unless
    ``graphs`` is False; on the CPU they run eagerly.

    An encoder-decoder (whisper) prefills with ``enc_input``, the
    encoder's input of every slot (frames (B, encoder_seq, d_model) or
    token ids): an input of the prefill graph like the tokens, copied
    into its static buffer at each replay, so one graph serves any
    frames of that shape. The prefill writes the cross K/V of the slots
    in ``mask``; decode reads them from the cache. This is the port's
    only serving path for such a model: :class:`ServeEngine` refuses
    it, as the JAX engine cannot serve it either.

    A from-zero prefill first zeroes the recurrent state (Mamba, RWKV) of
    the slots in ``mask`` (``LM.reset_state``), inside the step: a
    request admitted to a slot starts from zero, not from the state its
    last occupant left. The JAX engine starts that prefill from the
    slot's cache as it stands, so its stream depends on the occupant;
    on a slot's first use the two are the same.
    """

    def view_of(mode, cache_len, mask, table):
        if cache_len is None and table is None:
            return CacheView.prefill(mask)
        return CacheView._offset(mode, cache_len, mask, table)

    def run(mode):
        def step(caches, tokens, cache_len=None, mask=None, table=None,
                 enc_input=None):
            view = view_of(mode, cache_len, mask, table)
            if view.mode == "prefill":
                lm.reset_state(caches, mask)
            logits, _ = lm(tokens, view=view,
                           caches=caches, last_only=True, host_checked=True,
                           enc_input=enc_input)
            last = logits[:, -1]
            return last if sampler is None else sampler(last, None)
        return step

    return tuple(StepGraph(run(mode), device=lm.device, graphs=graphs,
                           check=functools.partial(_host_check, lm))
                 for mode in ("chunk", "decode"))


class ServeEngine:
    """Continuous batching over fixed-shape steps.

    ``lm`` holds its weights on its device; the cache, the sampler's
    generator and every step run there.

    ``quantize="int8"`` quantizes every compressed ``Linear`` of ``lm``
    in place at construction (per-output-channel absmax scales; the
    counterpart of the JAX engine's ``quantize_tree`` on its params);
    dense weights are untouched, and every compressed GEMM then runs
    through the int8 families. The scales come from the values the model
    holds: on an f32 model the result is bit-equal to the JAX engine's,
    on a bf16 model they come from the bf16 values (to build an int8
    model from f32 values, pass ``quantize`` to ``LM.init`` instead).

    ``prefill_chunk`` (a divisor of ``prefill_len``) prefills prompts in
    pieces of that many tokens, one a step. ``paged=True`` keeps the KV
    cache as a pool of ``page_size``-token pages (default
    ``$REPRO_KV_PAGE_SIZE``, else the chunk) behind per-slot block
    tables, ``pool_pages`` of them (default ``$REPRO_KV_POOL_PAGES``,
    else enough for every slot at ``max_seq``), with a prefix cache over
    whole prompt pages and preemption when decode runs out of pages.
    ``graphs=False`` runs every step eagerly on the card too. ``obs``
    and ``autotune_blocks``: see the module docstring.
    """

    def __init__(self, lm: LM, *, slots: int, max_seq: int,
                 prefill_len: int, temperature: float = 0.0, seed: int = 0,
                 strict: bool = False, quantize: Optional[str] = None,
                 prefill_chunk: Optional[int] = None, paged: bool = False,
                 page_size: Optional[int] = None,
                 pool_pages: Optional[int] = None, graphs: bool = True,
                 obs=None, autotune_blocks: bool = False):
        check_quantize(quantize)
        if lm.cfg.encoder_plan is not None:
            raise NotImplementedError(
                f"{lm.cfg.name} is an encoder-decoder: ServeEngine has no "
                "encoder input (nor has the JAX engine); serve it through "
                "make_serve_steps, whose prefill step takes enc_input")
        self.lm = lm
        self.obs = obs if obs is not None else _obs.get_obs()
        self.device = lm.device
        self.slots = slots
        self.max_seq = max_seq
        self.prefill_len = prefill_len
        self.temperature = temperature
        self.strict = strict
        self.paged = paged
        self.page_manager: Optional[PageManager] = None
        chunk = prefill_chunk or prefill_len
        if paged:
            # every paged prefill is a chunk-mode call through the table
            _validate_chunkable(lm.cfg)
            ps = int(page_size if page_size is not None
                     else os.environ.get("REPRO_KV_PAGE_SIZE") or chunk)
            pool = int(pool_pages if pool_pages is not None
                       else os.environ.get("REPRO_KV_POOL_PAGES")
                       or slots * (max_seq // ps))
            groups = self._data_parallel()
            if pool % groups:
                raise ValueError(
                    f"pool_pages={pool} must divide over the data-parallel "
                    f"degree ({groups}): each data shard owns an "
                    "independent sub-pool")
            self.page_manager = PageManager(
                page_size=ps, pages_per_group=pool // groups, slots=slots,
                max_seq=max_seq, groups=groups, obs=self.obs)
        self.scheduler = Scheduler(
            slots=slots, max_seq=max_seq, prefill_len=prefill_len,
            prefill_chunk=prefill_chunk, strict=strict,
            paging=self.page_manager, obs=self.obs)
        self.prefill_chunk = self.scheduler.prefill_chunk
        self._full = self.prefill_chunk == prefill_len and not paged
        if self.prefill_chunk != prefill_len and not paged:
            _validate_chunkable(lm.cfg)
        if quantize == "int8":
            quantize_tree(lm)
        if autotune_blocks:
            self._autotune_blocks()
        self._sampler = make_sampler(temperature)
        self._greedy = temperature <= 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._prefill, self._decode = make_serve_steps(
            lm, graphs=graphs,
            sampler=self._sampler if self._greedy else None)
        self.caches = self._init_caches()
        self.decode_times: list[float] = []  # wall clock after each decode
        self.queue_depths: list[int] = []    # per-step admission backlog
        self.page_utils: list[float] = []    # per-step pool utilization
        self.steps = 0

    # ---- engine-flavour hooks (ShardedServeEngine overrides them) --------

    def _data_parallel(self) -> int:
        """Page sub-pools: one a data shard."""
        return 1

    def _init_caches(self) -> list:
        """The cache; the paged pool reuses the slot-cache constructor:
        its batch rows are pages (row 0 the null page), its length the
        page size."""
        if self.paged:
            pm = self.page_manager
            return self.lm.init_cache(pm.rows, pm.page_size)
        return self.lm.init_cache(self.slots, self.max_seq)

    # ---- warm-up ----------------------------------------------------------

    def _autotune_blocks(self) -> None:
        """Sweep (where the cache has none) the launch of every compressed
        GEMM shape the steps issue: prefill M = slots x prefill_chunk,
        decode M = slots, each weight at its own N:M and values' dtype
        (int8 for a ``QNMWeight``), x in the model's dtype; and the
        ``bs_attention`` tile of each masked attention at the full
        prefill (the only step that runs that kernel). Weights under
        policy ``off`` run no kernel and are skipped. MoE experts run at
        M = capacity, not at these M; the walk tunes them at the same two
        M as every other weight, as the JAX engine does."""
        lm, dev = self.lm, self.device
        chunk = self.prefill_chunk
        shapes = set()
        for mod in lm.modules():
            if not isinstance(mod, Linear) or mod.nm is None:
                continue
            w = mod.weight
            if w.axis != 0 or w.kernel_policy.mode == "off":
                continue
            kc, n = w.vals.shape
            # float values run in x's dtype (nm_matmul casts them)
            shapes.add((kc * w.nm.m // w.nm.n, n, w.nm,
                        torch.int8 if isinstance(w, QNMWeight)
                        else lm.dtype))
        for k, n, nm, dt in sorted(shapes, key=lambda t: (
                t[0], t[1], t[2].tag, str(t[3]))):
            for m in sorted({self.slots, self.slots * chunk}):
                autotune.ensure_tuned(
                    m, n, k, nm, dt,
                    "decode" if m <= decode_m_max() else "prefill",
                    x_dtype=lm.dtype, device=dev)
        if not self._full:
            return  # chunked and paged prefill run the decode-form mask
        for mx in dict.fromkeys(b.mixer for b in lm.cfg.blocks()):
            if not isinstance(mx, AttnConfig) or mx.mask is None:
                continue
            if mx.kind == "mla":  # per-head K and V from the latent
                dk, dv = mx.nope_head_dim + mx.rope_head_dim, mx.v_head_dim
                heads = (mx.q_heads, mx.q_heads)
            else:
                dk = dv = mx.head_dim
                heads = (mx.q_heads, mx.kv_heads)
            autotune.ensure_tuned_attn(
                self.prefill_len, self.prefill_len, dk, mx.mask, lm.dtype,
                dv=dv, heads=heads, batch=self.slots, device=dev)

    # ---- device steps -----------------------------------------------------

    @torch.inference_mode()
    def _run(self, step: StepGraph, tokens: np.ndarray,
             cache_len: np.ndarray, mask: np.ndarray) -> np.ndarray:
        kw = dict(tokens=tokens, mask=mask)
        if self.paged:
            kw.update(cache_len=cache_len, table=self.page_manager.table)
        elif step is self._decode or not self._full:
            kw.update(cache_len=cache_len)
        out = step(self.caches, **kw)
        if not self._greedy:
            out = self._sampler(out, self._gen)
        ids = out.cpu().numpy()  # the step's one device sync
        if self.obs is not None and step.replayed is not None:
            for (op, impl, be), v in step.replayed.dispatches.items():
                self.obs.metrics.inc("kernel_dispatch_total", v, op=op,
                                     impl=impl, backend=be)
        return ids

    # ---- public API -------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.scheduler.submit(req, now=time.perf_counter())

    @property
    def queue(self) -> list[Request]:
        return self.scheduler.queue

    @property
    def finished(self) -> list[Request]:
        return self.scheduler.finished

    def compiled_cache_sizes(self) -> dict:
        """Graphs captured for each step kind on the card (distinct step
        shapes built on the CPU); after warm-up these stay at 1 each."""
        return {"prefill": len(self._prefill.built),
                "decode": len(self._decode.built)}

    def captured(self) -> dict:
        """{"prefill": [...], "decode": [...]} :class:`CapturedStep` s."""
        return {"prefill": self._prefill.captured,
                "decode": self._decode.captured}

    def step(self) -> None:
        """One engine step: a (batched, possibly chunked) prefill for every
        slot with prompt pieces left, then one decode for every slot whose
        prefill completed."""
        sched = self.scheduler
        obs = self.obs
        span = obs.tracer.span if obs is not None else _obs.null_span()
        pf = sched.plan_prefill()
        if pf is not None:
            # paged: the table is read after planning, which assigned the
            # admitted slots' pages
            with span("engine.prefill", step=self.steps,
                      active=len(pf.active), finishing=len(pf.finishing)):
                toks = self._run(self._prefill, pf.tokens, pf.cache_len,
                                 pf.mask)
            sched.finish_prefill(pf, toks, now=time.perf_counter())
        dc = sched.plan_decode()
        if dc is not None:
            # paged: planning may have given out pages or preempted a slot
            with span("engine.decode", step=self.steps,
                      active=len(dc.active)):
                toks = self._run(self._decode, dc.tokens, dc.lengths,
                                 dc.mask)
            now = time.perf_counter()
            self.decode_times.append(now)
            if len(self.decode_times) > 8192:  # bounded history
                del self.decode_times[:4096]
            sched.finish_decode(dc, toks, now=now)
            if obs is not None:
                obs.metrics.inc("serve_decode_steps_total")
                obs.metrics.inc("serve_tokens_total", len(dc.active))
        self.queue_depths.append(len(sched.queue))
        if self.page_manager is not None:
            self.page_utils.append(self.page_manager.utilization())
        if len(self.queue_depths) > 8192:
            del self.queue_depths[:4096]
            del self.page_utils[:4096]
        self.steps += 1
        if obs is not None:
            occupied = sum(1 for s in sched.slots if s.req is not None)
            obs.tracer.instant("engine.step", step=self.steps,
                               occupied=occupied, queue=len(sched.queue))
            obs.metrics.inc("serve_steps_total")
            obs.metrics.set_gauge("serve_slots_occupied", occupied)
            obs.metrics.set_gauge("serve_queue_depth", len(sched.queue))
            if self.page_manager is not None:
                obs.metrics.set_gauge("page_pool_utilization",
                                      self.page_utils[-1])
                obs.metrics.set_gauge(
                    "prefix_hit_rate",
                    self.page_manager.stats.prefix_hit_rate)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while self.scheduler.has_work and steps < max_steps:
            self.step()
            steps += 1
        return self.scheduler.finished

    def throughput_stats(self) -> dict:
        """Serving metrics over every finished request: generated tokens,
        mean and p50/p99 time to first token, p50/p99 inter-token
        latency pooled from each request's own token timestamps, the
        mean and largest admission backlog after a step, and with paging
        the pool utilization, prefix-cache hits, evictions and
        preemptions."""
        reqs = list(self.scheduler.finished)
        toks = sum(len(r.out) for r in reqs)
        ttfts = [r.t_first - r.t_submit for r in reqs
                 if r.t_first is not None and r.t_submit is not None]
        gaps = [r.itl_s() for r in reqs]
        itl = np.concatenate(gaps) if gaps else np.asarray([])

        def pct(a, q):
            return float(np.percentile(a, q)) if len(a) else float("nan")

        stats = {
            "requests": len(reqs),
            "tokens": toks,
            "decode_steps": len(self.decode_times),
            "ttft_s": float(np.mean(ttfts)) if ttfts else float("nan"),
            "ttft_p50_s": pct(ttfts, 50),
            "ttft_p99_s": pct(ttfts, 99),
            "itl_p50_s": pct(itl, 50),
            "itl_p99_s": pct(itl, 99),
            "queue_depth_mean": float(np.mean(self.queue_depths))
            if self.queue_depths else 0.0,
            "queue_depth_max": int(max(self.queue_depths, default=0)),
        }
        if self.page_manager is not None:
            pm = self.page_manager
            stats.update({
                "page_util_mean": float(np.mean(self.page_utils))
                if self.page_utils else 0.0,
                "page_util_max": float(max(self.page_utils, default=0.0)),
                "prefix_hit_pages": pm.stats.prefix_hit_pages,
                "prefix_lookup_pages": pm.stats.prefix_lookup_pages,
                "prefix_hit_rate": pm.stats.prefix_hit_rate,
                "page_evictions": pm.stats.evictions,
                "preemptions": self.scheduler.preemptions,
            })
        return stats


class ShardedServeEngine(ServeEngine):
    """The same engine on one rank of a ``data x model`` mesh (port of the
    JAX package's ``ShardedServeEngine``): slots split over "data",
    projections tensor-parallel over "model" with head-aware slices
    (:mod:`repro_torch.parallel.sharding`), the KV cache split on its
    heads where the plan splits them, compressed vals, idx and scales
    sliced together so that each rank's kernels read only its slice.

    Every rank of the mesh builds one, with the same arguments, and runs
    the same host loop and scheduler on the same requests: its steps run
    its data shard's slots under ``tp_serving`` (the row-parallel
    outputs summed over "model"), the last position's logits are summed
    over "data" into a zero-filled (slots, V) buffer, and every rank
    samples the global logits with one generator whose state is the
    same on every rank. So the streams, greedy or sampled, are the
    single-card engine's with the same seed, on every rank. Paged: one
    page sub-pool a data shard (``PageManager(groups=data)``), each rank
    holding its own; ``table % stride`` is the local page row.

    ``lm`` is the whole model (sliced in place here, after ``quantize``
    made its compressed weights int8 from the whole ones, as the JAX
    engine quantizes before it places the params) or a shard made by
    ``parallel.sharding.init_sharded`` (then ``quantize`` must be None:
    quantize it when it is made). ``slots`` must divide over "data". The
    steps run eagerly: gloo collectives cannot be captured in a CUDA
    graph.
    """

    def __init__(self, lm: LM, *, mesh, quantize: Optional[str] = None,
                 **kw):
        from repro_torch.parallel.sharding import serve_tp_plan, shard_lm_

        slots = kw.get("slots")
        if slots is None or slots % mesh.data:
            raise ValueError(f"slots={slots} must divide over the data "
                             f"axis ({mesh.data})")
        if kw.pop("graphs", False):
            raise NotImplementedError(
                "ShardedServeEngine runs its steps eagerly: gloo "
                "collectives cannot be captured in a CUDA graph")
        check_quantize(quantize)
        self.mesh = mesh
        plan = getattr(lm, "tp_plan", None)
        if plan is None:
            plan = serve_tp_plan(lm.cfg, mesh.model)
            if quantize == "int8":
                quantize_tree(lm)
            shard_lm_(lm, plan, mesh)
        elif plan.tp != mesh.model:
            raise ValueError(f"a tp={plan.tp} shard on a mesh of "
                             f"{mesh.model} model ranks")
        elif quantize is not None:
            raise ValueError("quantize a sharded model when it is made "
                             "(parallel.sharding.init_sharded(..., "
                             "quantize=))")
        self.tp_plan = plan
        self.step_calls = {"prefill": 0, "decode": 0}
        super().__init__(lm, graphs=False, **kw)
        # the steps return the local logits; sampling runs on the global
        self._prefill, self._decode = make_serve_steps(lm, graphs=False)

    def _data_parallel(self) -> int:
        return self.mesh.data

    def _init_caches(self) -> list:
        if self.paged:
            pm = self.page_manager
            return self.lm.init_cache(pm.stride, pm.page_size)
        return self.lm.init_cache(self.slots // self.mesh.data,
                                  self.max_seq)

    @torch.inference_mode()
    def _run(self, step: StepGraph, tokens: np.ndarray,
             cache_len: np.ndarray, mask: np.ndarray) -> np.ndarray:
        from repro_torch.launch.mesh import local_rows
        from repro_torch.parallel.hints import tp_serving

        self.step_calls["decode" if step is self._decode else "prefill"] += 1
        rows = local_rows(self.mesh, self.slots)
        kw = dict(tokens=tokens[rows], mask=mask[rows])
        if self.paged:
            kw.update(cache_len=cache_len[rows],
                      table=self.page_manager.table[rows])
        elif step is self._decode or not self._full:
            kw.update(cache_len=cache_len[rows])
        with tp_serving(self.mesh, self.tp_plan.reduce_tags):
            out = step(self.caches, **kw)              # (slots / data, V)
        logits = torch.zeros((self.slots, out.shape[-1]), dtype=out.dtype,
                             device=out.device)
        logits[rows] = out
        logits = self.mesh.all_reduce(logits, "data")
        ids = self._sampler(logits, None if self._greedy else self._gen)
        return ids.cpu().numpy()  # the step's one device sync


def ran_counts(engine: ServeEngine, dispatches: dict,
               launches: dict) -> tuple[dict, dict]:
    """What ran on the card, from the dispatch and launch counters read
    after driving ``engine`` (zeroed before it was built): each graph's
    capture counted once and replayed ``replays`` times, so its counts
    are replaced by count x replays."""
    recs = engine.captured()
    return capture.ran_counts(recs["prefill"] + recs["decode"], dispatches,
                              launches)


def _validate_chunkable(cfg) -> None:
    """Chunked prefill needs the mixers' chunk mode (a multi-token write
    at a cache offset, causal against absolute positions): attention
    blocks without cross-attention."""
    for blk in cfg.blocks():
        if not isinstance(blk.mixer, AttnConfig) or getattr(
                blk, "cross_attn", False):
            raise NotImplementedError(
                f"prefill_chunk < prefill_len needs attention-mixer "
                f"decoder blocks; {cfg.name} has "
                f"{type(blk.mixer).__name__}")
