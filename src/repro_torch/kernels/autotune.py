"""Launch autotuner for the port's kernels, with a persistent cache (port
of ``repro.kernels.autotune``).

The host rules choose every launch by default: the prefill tile
(``padding.prefill_tile``), the decode launch (``padding.decode_plan``:
columns a CTA and the split of K) and the block-sparse attention tile
(``mask.default_tile``). This module times the launches each rule
chooses from on real operands and remembers the fastest per problem, so
that the sweep is paid once per shape per card.

Families, each a set of launches of one kernel pair:

  prefill   ``nm_spmm`` / ``nm_spmm_q``: a block ``(block_m, block_n,
            block_k)`` of :func:`padding.prefill_candidates`
  decode    ``nm_spmm_decode`` / ``_q``: ``(rows, columns a CTA, dense
            rows of K a split)`` of :func:`padding.decode_candidates`
  bs_attn   ``bs_attention``: a ``(bq, bk)`` tile, ``spec.block`` / {1,
            2, 4} where the mask tiles (:func:`candidate_attn_tiles`)

Cache
-----
JSON at ``$REPRO_TORCH_AUTOTUNE_CACHE`` (default
``~/.cache/repro_torch/autotune.json``; the JAX package's file is never
read or written), one entry per key::

    {"v1|<card name>|<SMs>|<family>|<x dtype>|<vals dtype>|n:m|MxKxN": [...]}

The card's name and SM count are in the key (an H100 PCIe has 114 SMs,
the SXM part 132), and so are x's and the values' dtypes: the int8
kernels are their own family, whose winners never shadow the float
sweep's. The bs_attn family keys its ``spec.tag``, Dv and ``Sq x Skv x
Dk``.

Timing and correctness
----------------------
A sweep times each candidate with CUDA events on the current stream,
the L2 cache flushed before every launch, and takes the median of
``repeats``. Before a candidate can win, its output is held to the
rule's on the same operands: the N:M families run on the integer
lattice (integer x and weights, power-of-two scales), where every
summation order is exact, so every candidate must equal the rule's bit
for bit; attention must agree within the kernel's stated tolerance. A
candidate that disagrees is a kernel fault and the sweep raises.

On the CPU the kernels do not exist, so nothing is timed:
:func:`ensure_tuned` gives the rule's launch and writes nothing.

Lookup in the hot path (``nm_matmul``, ``bs_attention`` with no tile):
the policy's pinned block, then a cache hit, then, with
``REPRO_AUTOTUNE=1``, an inline sweep (never while a CUDA graph is
being captured: then the rule's launch, with a note on the dispatch
record), else the rule. The serving engine calls :func:`ensure_tuned`
for its shapes at construction (``autotune_blocks=True``).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import statistics
import threading
import time
from typing import Callable, Optional, Sequence

import torch

from repro_torch import obs as _obs
from repro_torch.core.sparsity import NMConfig
from repro_torch.kernels import padding

__all__ = ["FAMILIES", "Sweep", "best_attn_tile", "best_block",
           "cache_path", "cached_block", "candidate_attn_tiles",
           "candidate_blocks", "clear_memory_cache", "default_block",
           "ensure_tuned", "ensure_tuned_attn", "store", "sweep",
           "sweep_attn", "tune", "tune_attn"]

FAMILIES = ("prefill", "decode", "bs_attn")
_CACHE_VERSION = "v1"
# tolerance (rtol = atol) of an attention candidate against the rule's
# tile: both sum in f32, in another order (the kernels' stated one)
ATTN_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
CAPTURE_NOTE = ("autotune: cache miss while a CUDA graph is captured; the "
                "rule's launch, no sweep")

_LOCK = threading.Lock()
_MEM: dict[str, tuple] = {}
_LOADED_FROM: Optional[str] = None


def cache_path() -> str:
    return os.environ.get(
        "REPRO_TORCH_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "autotune.json"))


def _device(device) -> torch.device:
    """The device of a lookup (default: the card where there is one); a
    card's index made explicit, where the process has a card."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _on_card(dev: torch.device) -> bool:
    return dev.type == "cuda" and torch.cuda.is_available()


def _sms(dev: torch.device) -> int:
    """SMs of ``dev``'s card (the rules' NUM_SMS without one: a dry run)."""
    return padding.sm_count(dev.index) if _on_card(dev) else padding.NUM_SMS


@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _key(m: int, n: int, k: int, tag: str, dtype, x_dtype, family: str,
         dev: torch.device) -> str:
    card = (f"{_card_name(dev.index)}|{_sms(dev)}" if _on_card(dev)
            else f"{dev.type}|0")
    return (f"{_CACHE_VERSION}|{card}|{family}|{_dtype_name(x_dtype)}|"
            f"{_dtype_name(dtype)}|{tag}|{m}x{k}x{n}")


def _x_dtype(dtype, x_dtype):
    """x's dtype of a key: as given, else the values' (a float family),
    else f32 (int8 values)."""
    if x_dtype is not None:
        return x_dtype
    return torch.float32 if dtype == torch.int8 else dtype


def _entry(v) -> Optional[tuple]:
    if isinstance(v, list) and len(v) in (2, 3) and all(
            isinstance(b, int) for b in v):
        return tuple(v)
    return None


def _load_locked() -> None:
    global _LOADED_FROM
    path = cache_path()
    if _LOADED_FROM == path:
        return
    _MEM.clear()
    _LOADED_FROM = path
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return  # a missing or corrupt cache is an empty one
    if isinstance(raw, dict):
        for key, v in raw.items():
            if _entry(v) is not None:
                _MEM[key] = _entry(v)


def _save_locked() -> None:
    path = cache_path()
    try:
        # merge on save: another process may have stored entries since
        # this one loaded, so concurrent tuners add to each other's
        try:
            with open(path) as f:
                for key, v in json.load(f).items():
                    if key not in _MEM and _entry(v) is not None:
                        _MEM[key] = _entry(v)
        except (OSError, ValueError, AttributeError):
            pass
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({k: list(v) for k, v in sorted(_MEM.items())}, f,
                      indent=1)
        os.replace(tmp, path)
    except OSError:
        pass  # a read-only file system: the entries stay in memory


def clear_memory_cache() -> None:
    """Forget the loaded entries (the next lookup reads the file again)."""
    global _LOADED_FROM
    with _LOCK:
        _MEM.clear()
        _LOADED_FROM = None


def _lookup(key: str, family: str) -> Optional[tuple]:
    with _LOCK:
        _load_locked()
        hit = _MEM.get(key)
    bundle = _obs.get_obs()
    if bundle is not None:
        bundle.metrics.inc("autotune_cache_hits_total" if hit is not None
                           else "autotune_cache_misses_total", family=family)
    return hit


def cached_block(m: int, n: int, k: int, cfg: NMConfig, dtype,
                 family: str = "prefill", *, x_dtype=None,
                 device=None) -> Optional[tuple]:
    """The stored launch of an N:M family for y[M, N] = x[M, K] @ W with
    values of ``dtype`` (int8: the ``_q`` kernels) and x of ``x_dtype``
    on ``device``'s card, or None."""
    dev = _device(device)
    return _lookup(_key(m, n, k, cfg.tag, dtype, _x_dtype(dtype, x_dtype),
                        family, dev), family)


def candidate_blocks(m: int, n: int, k: int, cfg: NMConfig, dtype,
                     family: str = "prefill", *, x_dtype=None,
                     device=None) -> list[tuple]:
    """The launches the family's rule chooses from (module docstring)."""
    xd = _x_dtype(dtype, x_dtype)
    if family == "prefill":
        return padding.prefill_candidates(cfg, m, n, xd, dtype)
    if family == "decode":
        return [(p.rows, p.cols, p.span) for p in padding.decode_candidates(
            m, k, n, cfg, dtype.itemsize, _sms(_device(device)))]
    raise ValueError(f"unknown N:M family {family!r}")


def default_block(m: int, n: int, k: int, cfg: NMConfig, dtype,
                  family: str = "prefill", *, x_dtype=None,
                  device=None) -> tuple:
    """The rule's launch (``padding.prefill_block`` / ``decode_block`` on
    ``device``'s SMs)."""
    xd = _x_dtype(dtype, x_dtype)
    if family == "prefill":
        return padding.prefill_block(cfg, m, n, xd, dtype)
    return padding.decode_block(cfg, m, k, n, dtype.itemsize,
                                _sms(_device(device)))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def _cuda_ms(fn: Callable[[], object], repeats: int,
             device: torch.device) -> float:
    """Median ms of one call of ``fn`` on the current stream: CUDA events
    around the call alone, the L2 flushed before each. The flush writes
    1 GiB (about 0.3 ms on an H100): that evicts the 50 MB L2 and keeps
    the card busy while the host enqueues the timed launch, so the event
    pair holds the kernel and not the wrapper's host time (a 128 MiB
    flush let a decode launch's Python overhead into the time)."""
    flush = torch.empty(2**30, dtype=torch.uint8, device=device)
    fn()
    torch.cuda.synchronize(device)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(repeats)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize(device)
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def _timer(device: torch.device) -> Optional[Callable]:
    """``timer(fn, repeats) -> ms`` on ``device``, or None on the CPU,
    where the kernels do not run."""
    if not _on_card(device):
        return None
    return lambda fn, repeats: _cuda_ms(fn, repeats, device)


@dataclasses.dataclass
class Sweep:
    """One sweep: its cache key and family, the rule's launch and its ms,
    the winner and its ms, and every candidate's ms."""

    key: str
    family: str
    rule: tuple
    rule_ms: float
    best: tuple
    best_ms: float
    times: dict


def _time_all(key, family, what, rule, cands, run, agrees, timer,
              repeats) -> Sweep:
    """Time ``run(c)`` for each candidate ``c`` after holding its output
    to the rule's (``agrees(got, want)``; a fault raises)."""
    want = run(rule)
    times = {}
    for c in cands:
        c = tuple(c)
        got = run(c)
        if not agrees(got, want):
            raise RuntimeError(
                f"autotune {family} {what}: launch {c} gives another "
                f"output than the rule's {rule} (max |diff| "
                f"{float((got.float() - want.float()).abs().max())})")
        times[c] = timer(lambda c=c: run(c), repeats)
    rule_ms = times[rule] if rule in times else timer(lambda: run(rule),
                                                      repeats)
    best = min(times, key=times.get) if times else rule
    return Sweep(key=key, family=family, rule=rule, rule_ms=rule_ms,
                 best=best, best_ms=times.get(best, rule_ms), times=times)


def _lattice_operands(m, n, k, cfg, dtype, x_dtype, dev, seed=0):
    """x and the compressed weight on the integer lattice: every sum of
    the kernels is exact in f32 whatever its order."""
    from repro_torch.core.sparsity import apply_mask, compress_nm, \
        prune_mask_nm

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randint(-4, 5, (m, k), generator=gen, device=dev)
    w = (torch.randint(1, 5, (k, n), generator=gen, device=dev)
         * (torch.randint(0, 2, (k, n), generator=gen, device=dev) * 2 - 1))
    w = w.to(torch.float32)
    vals, idx = compress_nm(apply_mask(w, prune_mask_nm(w, cfg)), cfg)
    scales = None
    if dtype == torch.int8:
        scales = torch.full((n,), 2.0 ** -6, dtype=torch.float32, device=dev)
    return (x.to(x_dtype), vals.to(dtype).contiguous(), idx.contiguous(),
            scales)


def sweep(m: int, n: int, k: int, cfg: NMConfig, dtype=torch.float32,
          candidates: Optional[Sequence[tuple]] = None, repeats: int = 10,
          family: str = "prefill", *, x_dtype=None,
          device=None) -> Optional[Sweep]:
    """Time every candidate launch of an N:M family (default: all of
    :func:`candidate_blocks`) on lattice operands; None on the CPU (no
    timer). Raises where a candidate's output differs from the rule's."""
    from repro_torch.kernels.indexmac import decode_kernel, kernel

    dev = _device(device)
    timer = _timer(dev)
    if timer is None:
        return None
    xd = _x_dtype(dtype, x_dtype)
    kk = -(-k // cfg.m) * cfg.m  # whole m-blocks
    x, vals, idx, scales = _lattice_operands(m, n, kk, cfg, dtype, xd, dev)
    itemsize = vals.element_size()

    def run(block):
        if family == "prefill":
            if scales is None:
                return kernel.nm_spmm(x, vals, idx, cfg, tile=block[:2])
            return kernel.nm_spmm_q(x, vals, idx, scales, cfg,
                                    tile=block[:2])
        plan = padding.decode_launch(block, m, kk, n, cfg, itemsize)
        if plan is None:
            raise ValueError(f"decode block {block} names no launch")
        if scales is None:
            return decode_kernel.nm_spmm_decode(x, vals, idx, None, cfg,
                                                plan=plan)
        return decode_kernel.nm_spmm_decode_q(x, vals, idx, scales, None,
                                              cfg, plan=plan)

    rule = tuple(default_block(m, n, kk, cfg, dtype, family, x_dtype=xd,
                               device=dev))
    cands = candidates or candidate_blocks(m, n, kk, cfg, dtype, family,
                                           x_dtype=xd, device=dev)
    return _time_all(_key(m, n, k, cfg.tag, dtype, xd, family, dev), family,
                     f"{cfg.tag} {m}x{kk}x{n} on the integer lattice", rule,
                     cands, run, torch.equal, timer, repeats)


def store(s: Sweep, t0: Optional[float] = None) -> tuple:
    """Persist a sweep's winner; returns it."""
    with _LOCK:
        _load_locked()
        _MEM[s.key] = tuple(s.best)
        _save_locked()
    bundle = _obs.get_obs()
    if bundle is not None:
        bundle.metrics.inc("autotune_sweeps_total", family=s.family)
        if t0 is not None:
            bundle.metrics.observe("autotune_sweep_seconds",
                                   time.perf_counter() - t0)
    return tuple(s.best)


def tune(m: int, n: int, k: int, cfg: NMConfig, dtype=torch.float32,
         candidates: Optional[Sequence[tuple]] = None, repeats: int = 10,
         family: str = "prefill", *, x_dtype=None, device=None) -> tuple:
    """Sweep, persist and return the winner; on the CPU the rule's launch,
    nothing written."""
    t0 = time.perf_counter()
    s = sweep(m, n, k, cfg, dtype, candidates, repeats, family,
              x_dtype=x_dtype, device=device)
    if s is None:
        return tuple(default_block(m, n, k, cfg, dtype, family,
                                   x_dtype=x_dtype, device=device))
    return store(s, t0)


def _sweep_on() -> bool:
    return os.environ.get("REPRO_AUTOTUNE") == "1"


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def best_block(m: int, n: int, k: int, cfg: NMConfig, dtype,
               family: str = "prefill", *, x_dtype=None, device=None,
               notes: Optional[list] = None) -> tuple:
    """Hot-path lookup: a cache hit, else a sweep when REPRO_AUTOTUNE=1
    and no graph is being captured, else the rule's launch (``notes``
    gets :data:`CAPTURE_NOTE` where a capture kept the sweep from
    running)."""
    hit = cached_block(m, n, k, cfg, dtype, family, x_dtype=x_dtype,
                       device=device)
    if hit is not None:
        return hit
    if _sweep_on():
        if not _capturing():
            return tune(m, n, k, cfg, dtype, family=family, x_dtype=x_dtype,
                        device=device)
        if notes is not None:
            notes.append(CAPTURE_NOTE)
    return tuple(default_block(m, n, k, cfg, dtype, family, x_dtype=x_dtype,
                               device=device))


def ensure_tuned(m: int, n: int, k: int, cfg: NMConfig, dtype,
                 family: str = "prefill", *, x_dtype=None,
                 device=None) -> tuple:
    """Sweep where the cache has no entry, whatever REPRO_AUTOTUNE says
    (the serving engine's warm-up)."""
    return cached_block(m, n, k, cfg, dtype, family, x_dtype=x_dtype,
                        device=device) or tune(
        m, n, k, cfg, dtype, family=family, x_dtype=x_dtype, device=device)


# ---------------------------------------------------------------------------
# bs_attn family: (bq, bk) tiles of the block-sparse attention kernel
# ---------------------------------------------------------------------------

_ATTN = "bs_attn"


def candidate_attn_tiles(spec, sq: int, skv: int, dtype=None, dk=None,
                         dv=None) -> list[tuple]:
    """Tiles ``spec.block / {1, 2, 4}`` that are multiples of 8, where the
    mask compiles (a tile above ``spec.block`` can only merge live and
    dead blocks, so none is swept) and the kernel has a build for the
    call (``dtype``, head dims, where given)."""
    from repro_torch.kernels.blocksparse_attn.kernel import MAX_DK, MAX_DV
    from repro_torch.kernels.blocksparse_attn.mask import compile_mask
    from repro_torch.kernels.indexmac.kernel import KERNEL_DTYPES

    if dtype is not None and dtype not in KERNEL_DTYPES:
        return []
    if any(d is not None and not 1 <= d <= lim
           for d, lim in ((dk, MAX_DK), (dv, MAX_DV))):
        return []
    cands = []
    for div in (1, 2, 4):
        t = (spec.block // div, spec.block // div)
        if t[0] < 8 or t[0] % 8 or spec.block % div:
            continue
        if compile_mask(spec, sq, skv, t) is not None and t not in cands:
            cands.append(t)
    return cands


def _attn_key(sq, skv, dk, dv, spec, dtype, dev) -> str:
    return _key(sq, dk, skv, f"{spec.tag}|dv{dv}", dtype, dtype, _ATTN, dev)


def sweep_attn(sq: int, skv: int, dk: int, spec, dtype=torch.float32,
               repeats: int = 10, *, dv: Optional[int] = None,
               heads: tuple = (4, 4), batch: int = 1,
               device=None) -> Optional[Sweep]:
    """Time ``bs_attention`` at every candidate tile on random operands
    (``batch`` x ``heads`` = (Hq, Hkv), q and k ``dk`` wide, v ``dv``
    wide, ``dk`` when None); None on the CPU. Raises where a tile's
    output leaves :data:`ATTN_TOL` of the rule tile's."""
    from repro_torch.kernels.blocksparse_attn.kernel import bs_attention
    from repro_torch.kernels.blocksparse_attn.mask import compile_mask, \
        default_tile

    dv = dk if dv is None else dv
    dev = _device(device)
    timer = _timer(dev)
    if timer is None:
        return None
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    hq, hkv = heads
    q = torch.randn(batch, sq, hq, dk, generator=gen, device=dev).to(dtype)
    k = torch.randn(batch, skv, hkv, dk, generator=gen, device=dev).to(dtype)
    v = torch.randn(batch, skv, hkv, dv, generator=gen, device=dev).to(dtype)

    def run(tile):
        return bs_attention(q, k, v, compile_mask(spec, sq, skv, tile))

    tol = ATTN_TOL[dtype]

    def close(got, want):
        got, want = got.float(), want.float()
        return bool(((got - want).abs() <= tol + tol * want.abs()).all())

    return _time_all(_attn_key(sq, skv, dk, dv, spec, dtype, dev), _ATTN,
                     f"{spec.tag} {sq}x{skv}x{dk} dv {dv} (tolerance {tol})",
                     tuple(default_tile(spec, sq, skv)),
                     candidate_attn_tiles(spec, sq, skv, dtype, dk, dv), run,
                     close, timer, repeats)


def tune_attn(sq: int, skv: int, dk: int, spec, dtype=torch.float32,
              repeats: int = 10, *, dv: Optional[int] = None,
              heads: tuple = (4, 4), batch: int = 1,
              device=None) -> tuple:
    """Sweep, persist and return the winning (bq, bk); on the CPU the
    rule's tile, nothing written."""
    from repro_torch.kernels.blocksparse_attn.mask import default_tile

    t0 = time.perf_counter()
    s = sweep_attn(sq, skv, dk, spec, dtype, repeats, dv=dv, heads=heads,
                   batch=batch, device=device)
    if s is None:
        return tuple(default_tile(spec, sq, skv))
    return store(s, t0)


def best_attn_tile(sq: int, skv: int, dk: int, spec, dtype=torch.float32,
                   *, dv: Optional[int] = None, device=None,
                   notes: Optional[list] = None) -> tuple:
    """Hot-path (bq, bk) lookup of the bs_attn family, as
    :func:`best_block`; the rule is the spec's own granularity."""
    from repro_torch.kernels.blocksparse_attn.mask import default_tile

    dv = dk if dv is None else dv
    dev = _device(device)
    hit = _lookup(_attn_key(sq, skv, dk, dv, spec, dtype, dev), _ATTN)
    if hit is not None:
        return tuple(hit[:2])
    if _sweep_on():
        if not _capturing():
            return tune_attn(sq, skv, dk, spec, dtype, dv=dv, device=dev)
        if notes is not None:
            notes.append(CAPTURE_NOTE)
    return tuple(default_tile(spec, sq, skv))


def ensure_tuned_attn(sq: int, skv: int, dk: int, spec, dtype=torch.float32,
                      *, dv: Optional[int] = None, heads: tuple = (4, 4),
                      batch: int = 1, device=None) -> tuple:
    """Sweep-if-missing for the bs_attn family (the engine's warm-up)."""
    dv = dk if dv is None else dv
    dev = _device(device)
    hit = _lookup(_attn_key(sq, skv, dk, dv, spec, dtype, dev), _ATTN)
    if hit is not None:
        return tuple(hit[:2])
    return tune_attn(sq, skv, dk, spec, dtype, dv=dv, heads=heads,
                     batch=batch, device=dev)
