"""Kernel tile geometry (port of ``repro.kernels.padding``).

The JAX package pads operands up to TPU tiles (sublane 8, lane 128) and
copies the padded weight on every call. The Hopper kernels mask their
ragged M, N and K edges themselves, so nothing is padded or copied here:
a :class:`PadPlan` is the geometry the kernel's tiles cover, which the
router checks (a call with no geometry has no kernel) and the dispatch
record reports. The JAX package's waste limits, which sent calls with
much padding to the reference, have no counterpart: no call pays for
padding here.

Tiles (see the sources under ``indexmac/csrc`` and
``indexmac_gather/csrc``):

* ``nm_spmm`` and ``nm_spmm_q`` (prefill families, on the tensor cores):
  a path and one of two compiled tiles, both chosen here and passed to
  the kernel as one code (:func:`prefill_code`). :func:`prefill_path`
  gives ``"sparse"`` (``mma.sp`` on the compressed tile: 2:4 and 1:4
  with bf16 x) or ``"dense"`` (the tile expanded in shared memory: bf16
  MMA for bf16 x, 3xTF32 for f32 x; every other pattern).
  :func:`prefill_tile` gives 128 x 128 outputs (8 MMA warps and 8 copy
  warps) where that grid fills at least half the card's 132 SMs, N >=
  128 and its shared memory (:func:`prefill_smem`) fits the card's 227
  KB, else 128 rows x 32 columns (4 and 4: DenseNet-121's C_out = 32
  convs, ResNet-50's late layers, yi-9b's K/V projections, and f32 x
  with f32 vals at dense patterns of 26 or more kept rows a stage, such
  as 7:8 or 15:16).
  K is walked in stages of 64 dense rows on the sparse path and 32 on
  the dense one (whole m-blocks: ``(32 // m) * m`` rows where m does not
  divide 32).
* ``nm_spmm_decode`` and ``nm_spmm_decode_q``: one launch per at most
  8 rows (1, 2, 4 or 8 rows compiled), CTAs of 256 threads; a thread
  holds ``decode_vec`` columns (8 bf16 or int8, 4 f32) and a CTA 8, 16
  or 32 lanes of them; K is split in whole m-blocks of at most 1024 dense
  rows (each CTA stages its split of x once) so that the grid loads the
  SMs evenly within one wave of CTA slots (:func:`decode_plan`, the slots
  from :func:`decode_ctas_per_sm`); the last CTA of a column tile adds
  the splits' partials in split order.
* ``indexmac_gather`` and ``indexmac_gather_q`` (the paper's
  orientation C[Mr, Nc] = A @ B): CTAs of 128 threads, one of two tiles
  of C (:data:`GATHER_TILES`, chosen by :func:`gather_tile` from Mr, Nc
  and the pattern), K walked in steps of whole m-blocks (32 dense rows,
  or one m-block where m > 32) and split so that the grid fills the
  card's CTA slots once (:func:`gather_splits`, the slots from
  :func:`gather_ctas_per_sm`); :func:`gather_plan` is the whole launch.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.sparsity import NMConfig

# (block_m, block_n) of the compiled prefill tiles, in the order of the
# kernel's tile code
PREFILL_TILES = ((128, 128), (128, 32))
PREFILL_PATHS = ("dense", "sparse")  # in the order of the kernel's code
PREFILL_K_ROWS = {"dense": 32, "sparse": 64}  # dense K rows a stage
# the kernel's ring of copied stages, its transformed stages, and the
# dynamic shared memory a block may take (PF_STAGES, PF_WORK, PF_SMEM_MAX)
PREFILL_STAGES, PREFILL_WORK = 5, 3
PREFILL_SMEM_MAX = 227 * 1024
NUM_SMS = 132  # H100 SXM
DECODE_ROWS = (1, 2, 4, 8)
DECODE_K_ROWS = 1024  # dense rows of K a decode split spans at most (DC_KROWS)
DECODE_THREADS = 256  # a decode CTA (DC_THREADS)
DECODE_LANES = (32, 16, 8)  # threads across a decode tile's columns
DECODE_RPT = 2  # rows of a ring stage a decode thread computes
DECODE_STAGES = {1: 6, 2: 4, 4: 5}  # ring slots by vals' item size
DECODE_X_BYTES = DECODE_K_ROWS * 8 * 4  # room for x (DC_XBYTES)
DECODE_CTAS_MAX = 2  # the decode kernels' launch bounds (DC_CTAS)
DECODE_MIN_STAGES = 2  # ring stages of rows a decode split holds at least
# a plan whose grid loads the SMs within this share of the best one's
# balance counts as even; of those the one with the fewest splits is taken
DECODE_FILL_SLACK = 0.95
# (block_m, block_n) of the gather kernels' tiles, in the order of the
# kernel's tile code: a row group of 16 or 8 lanes spans 4 columns a lane
# and holds 4 rows a lane, in CTAs of 128 threads
GATHER_TILES = ((32, 64), (64, 32))
GATHER_K_ROWS = 32  # dense rows a K step (whole m-blocks; m when m > 32)
GATHER_M_MAX = 64  # largest m the gather kernels take
GATHER_STAGES = 4  # the kernel's cp.async ring (G_STAGES)
GATHER_SMEM_MAX = 227 * 1024
GATHER_CTAS_MAX = 3  # the kernel's __launch_bounds__ (G_CTAS)
# an SM's shared memory, and what the card reserves of it per CTA
SM_SMEM, CTA_SMEM_RESERVED = 228 * 1024, 1024
GATHER_MIN_STEPS = 2  # K steps a split holds at least
GATHER_MAX_SPLITS = 32  # the last CTA of a tile reads the other partials


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def decode_vec(itemsize: int) -> int:
    """Columns a decode thread holds for ``vals`` of ``itemsize`` bytes:
    one 16-byte shared load of float values, or 8 int8 values."""
    return 8 if itemsize == 1 else 16 // itemsize


def prefill_path(cfg: NMConfig, x_dtype: torch.dtype,
                 vals_dtype: torch.dtype) -> str:
    """``"sparse"`` where the sparse tensor cores take the pattern and
    the operands (2:4 or 1:4, bf16 x, bf16 or int8 vals), else
    ``"dense"``."""
    if (cfg.m == 4 and cfg.n <= 2 and x_dtype == torch.bfloat16
            and vals_dtype in (torch.bfloat16, torch.int8)):
        return "sparse"
    return "dense"


def prefill_smem(tile: tuple[int, int], path: str, cfg: NMConfig,
                 x_dtype: torch.dtype, vals_dtype: torch.dtype) -> int:
    """Bytes of dynamic shared memory one ``nm_spmm`` / ``nm_spmm_q``
    launch takes (``PfLayout::smem`` in ``csrc/nm_spmm.cuh``): a ring of
    PREFILL_STAGES copied stages (the x tile and the stage's rows of vals
    and idx, rows padded by 16 bytes) and PREFILL_WORK transformed ones
    (``mma.sp`` fragments, or the dense W^T tile in x's dtype), or the
    output tile where that is larger."""
    bm, bn = tile
    krows = PREFILL_K_ROWS[path]
    vrows = krows // cfg.m * cfg.n
    xs, vs = x_dtype.itemsize, vals_dtype.itemsize
    stage = _round_up(bm * (krows + 16 // xs) * xs
                      + vrows * ((bn + 16 // vs) * vs + bn + 16), 16)
    work = (bn // 16 * (krows // 32) * 32 * 20 if path == "sparse"
            else _round_up(bn * (krows + 16 // xs) * xs, 16))
    return max(PREFILL_STAGES * stage + PREFILL_WORK * work,
               bm * (bn + 16 // xs) * xs)


def prefill_tile(m: int, n: int, cfg: NMConfig, x_dtype: torch.dtype,
                 vals_dtype: torch.dtype) -> tuple[int, int]:
    """The (block_m, block_n) of the compiled tile for an M x N output:
    the large tile when its grid fills at least half the SMs, N holds a
    whole 128-column tile and its shared memory fits, else the small one
    (which fits every accepted pattern and dtype). Both paths have both
    tiles and take the same rule."""
    path = prefill_path(cfg, x_dtype, vals_dtype)
    big_m, big_n = PREFILL_TILES[0]
    grid = -(-m // big_m) * -(-n // big_n)
    fits = prefill_smem(PREFILL_TILES[0], path, cfg, x_dtype,
                        vals_dtype) <= PREFILL_SMEM_MAX
    return PREFILL_TILES[
        0 if n >= big_n and grid >= NUM_SMS // 2 and fits else 1]


def prefill_candidates(cfg: NMConfig, m: int, n: int, x_dtype: torch.dtype,
                       vals_dtype: torch.dtype) -> list[tuple[int, int, int]]:
    """Every (block_m, block_n, block_k) launch of ``nm_spmm`` /
    ``nm_spmm_q`` for an M x N output: each compiled tile whose shared
    memory fits, at the path's K stage (the rule,
    :func:`prefill_block`, picks one of them; the kernels mask ragged
    edges, so every fitting tile is legal at any M and N)."""
    path = prefill_path(cfg, x_dtype, vals_dtype)
    bk = (PREFILL_K_ROWS[path] // cfg.m) * cfg.m
    return [(*t, bk) for t in PREFILL_TILES
            if prefill_smem(t, path, cfg, x_dtype, vals_dtype)
            <= PREFILL_SMEM_MAX]


def prefill_code(path: str, tile: tuple[int, int]) -> int:
    """The kernel's ``variant`` argument: path + 2 * tile index."""
    if path not in PREFILL_PATHS:
        raise ValueError(f"unknown prefill path {path!r}")
    return PREFILL_PATHS.index(path) + 2 * PREFILL_TILES.index(tuple(tile))


def prefill_block(cfg: NMConfig, m: int, n: int, x_dtype: torch.dtype,
                  vals_dtype: torch.dtype) -> tuple[int, int, int]:
    """The (block_m, block_n, block_k) ``nm_spmm`` / ``nm_spmm_q`` launch
    for an M x N output with x and vals of these dtypes."""
    path = prefill_path(cfg, x_dtype, vals_dtype)
    return (*prefill_tile(m, n, cfg, x_dtype, vals_dtype),
            (PREFILL_K_ROWS[path] // cfg.m) * cfg.m)


def decode_smem(itemsize: int) -> int:
    """Bytes of dynamic shared memory one decode CTA takes (``dc_smem`` in
    ``indexmac/csrc/nm_spmm_decode.cuh``) for ``vals`` of ``itemsize``
    bytes: 128 bytes to align the ring, DECODE_STAGES ring stages of
    DECODE_THREADS * DECODE_RPT * vec kept values (vals, then an idx byte
    each), then room for x as f32, DECODE_K_ROWS dense rows of up to 8
    rows."""
    stage = (DECODE_THREADS * DECODE_RPT * decode_vec(itemsize)
             * (itemsize + 1))
    return 128 + DECODE_STAGES[itemsize] * stage + DECODE_X_BYTES


def decode_ctas_per_sm(itemsize: int) -> int:
    """CTAs of the decode kernel an SM holds at once, whatever the rows:
    the launch bounds' DECODE_CTAS_MAX, which is also all that the CTA's
    shared memory (:func:`decode_smem`, the card's reserve and the
    kernel's static word included) lets an SM hold, so that no kernel
    that ptxas gives fewer registers fits more. ``chip_smoke.py`` holds
    it to ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    per_cta = (_round_up(decode_smem(itemsize) + 16, 128)
               + CTA_SMEM_RESERVED)
    return max(1, min(DECODE_CTAS_MAX, SM_SMEM // per_cta))


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """One decode launch: the rows it computes, the columns of a CTA, and
    how K is split. Split ``s`` sums m-blocks [s * per, (s + 1) * per) of
    K, dense rows [s * span, (s + 1) * span); the splits are added in
    order."""

    rows: int
    cols: int
    per: int
    span: int
    splits: int
    tiles: int

    @property
    def ctas(self) -> int:
        return self.tiles * self.splits

    def k_ranges(self, k: int) -> list[tuple[int, int]]:
        """The dense rows [k0, k1) of each split, in split order."""
        return [(k0, min(k0 + self.span, k))
                for k0 in range(0, k, self.span)] or [(0, 0)]


@functools.lru_cache(maxsize=4096)
def decode_plan(m: int, k: int, n: int, cfg: NMConfig, itemsize: int,
                sms: int = NUM_SMS, *, cols: Optional[int] = None,
                per: Optional[int] = None) -> DecodePlan:
    """The decode kernels' launch for y[M, N] = x[M, K] @ W, M <= 8 (a
    call of more rows launches once per 8, each with its own plan), vals
    of ``itemsize`` bytes (1: ``nm_spmm_decode_q``), on a card of ``sms``
    SMs (K a multiple of m <= DECODE_K_ROWS).

    The candidates are :func:`decode_candidates`' (every tile width and
    split depth whose splits keep within DECODE_K_ROWS dense rows, x is
    staged once a CTA, and whose grid fits the card's CTA slots, ``sms``
    times :func:`decode_ctas_per_sm`, at once where any does). The rule
    takes the grid that loads the SMs most evenly
    (CTAs over ``sms`` times the CTAs of the busiest SM, within
    DECODE_FILL_SLACK of the best): every CTA streams the same bytes, so
    the busiest SM sets the time. Of those it takes the fewest splits (a
    split adds a partial for the tile's last CTA to add), then the widest
    tile. So one split where N alone fills the card evenly, narrow tiles
    and more splits where it does not (wk / wv, N = 512: 8 tiles of 64
    columns in 16 splits, 128 CTAs; 17 splits, 136 CTAs with four SMs
    holding two, were 8 % slower on an H100, ``launch/
    profile_decode_plan.py``). ``cols`` and ``per`` (m-blocks a split)
    replace the rule's choice, to time the launches it did not choose."""
    if cols is not None or per is not None:
        p = per if per is not None else max(1, DECODE_K_ROWS // cfg.m)
        c = cols or DECODE_LANES[0] * decode_vec(itemsize)
        return DecodePlan(rows=decode_rows(min(max(m, 1), DECODE_ROWS[-1])),
                          cols=c, per=p, span=p * cfg.m,
                          splits=max(1, -(-(k // cfg.m) // p)),
                          tiles=-(-n // c))

    def fill(pl: DecodePlan) -> float:
        return pl.ctas / (sms * max(1, -(-pl.ctas // sms)))

    fits = decode_candidates(m, k, n, cfg, itemsize, sms)
    best = max(fill(pl) for pl in fits)
    return min((pl for pl in fits if fill(pl) >= DECODE_FILL_SLACK * best),
               key=lambda pl: (pl.splits, -pl.cols))


@functools.lru_cache(maxsize=4096)
def decode_candidates(m: int, k: int, n: int, cfg: NMConfig, itemsize: int,
                      sms: int = NUM_SMS) -> tuple[DecodePlan, ...]:
    """The launches :func:`decode_plan`'s rule chooses from: every tile
    width (DECODE_LANES lanes of ``decode_vec`` columns) and split depth
    in whole m-blocks whose splits keep within DECODE_K_ROWS dense rows
    and hold at least DECODE_MIN_STAGES ring stages of rows, those whose
    grid fits the card's CTA slots at once where any does."""
    rows = decode_rows(min(max(m, 1), DECODE_ROWS[-1]))
    vec = decode_vec(itemsize)
    slots = sms * decode_ctas_per_sm(itemsize)
    kb = k // cfg.m
    most = max(1, DECODE_K_ROWS // cfg.m)
    cands = []
    for lanes in DECODE_LANES:
        c = lanes * vec
        stage = max(1, DECODE_THREADS // lanes * DECODE_RPT // cfg.n)
        least = max(1, -(-kb // most))
        top = max(least, kb // (DECODE_MIN_STAGES * stage))
        pers = {max(1, min(most, -(-kb // s))) for s in range(least, top + 1)}
        cands += [DecodePlan(rows=rows, cols=c, per=p, span=p * cfg.m,
                             splits=max(1, -(-kb // p)), tiles=-(-n // c))
                  for p in sorted(pers)]
    return tuple(pl for pl in cands if pl.ctas <= slots) or tuple(cands)


def decode_launch(block: tuple, m: int, k: int, n: int, cfg: NMConfig,
                  itemsize: int) -> Optional[DecodePlan]:
    """The decode launch a ``(rows, columns a CTA, dense rows of K a
    split)`` block names for y[M, N] = x[M, K] @ W, or None where the
    kernels have none: rows other than M's compiled row count, columns
    that are not DECODE_LANES lanes of ``decode_vec`` columns, or a split
    that is not a whole number of m-blocks within DECODE_K_ROWS rows."""
    rows, cols, span = (int(b) for b in block)
    vec = decode_vec(itemsize)
    per, rest = divmod(span, cfg.m)
    if (rows != decode_rows(min(max(m, 1), DECODE_ROWS[-1]))
            or cols not in [lanes * vec for lanes in DECODE_LANES]
            or rest or not 1 <= per <= DECODE_K_ROWS // cfg.m):
        return None
    return decode_plan(m, k, n, cfg, itemsize, cols=cols, per=per)


def decode_block(cfg: NMConfig, m: int, k: int, n: int, itemsize: int,
                 sms: int = NUM_SMS) -> tuple[int, int, int]:
    """The (rows, columns a CTA, dense rows of K a split) of the decode
    kernels' first launch for y[M, N] = x[M, K] @ W with ``vals`` of
    ``itemsize`` bytes (:func:`decode_plan` on a card of ``sms`` SMs); a
    split of 0 rows where an m-block exceeds DECODE_K_ROWS (no kernel)."""
    plan = decode_plan(m, k, n, cfg, itemsize, sms)
    return plan.rows, plan.cols, plan.span if cfg.m <= DECODE_K_ROWS else 0


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``device_index``."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def gather_k_rows(cfg: NMConfig) -> int:
    """Dense rows of B a gather K step: whole m-blocks, 32 rows or the
    nearest below (one m-block where m > 32); 0 where m exceeds
    GATHER_M_MAX (no kernel)."""
    if cfg.m > GATHER_M_MAX:
        return 0
    return cfg.m if cfg.m > GATHER_K_ROWS else GATHER_K_ROWS // cfg.m * cfg.m


def gather_tile(mr: int, nc: int, cfg: NMConfig) -> tuple[int, int]:
    """The (block_m, block_n) tile of C for Mr x Nc under ``cfg``: the one
    whose lanes resolve the fewest 4-slot chunks of the strip a K step
    (a row group of G lanes resolves its rows' kept values 4 at a time,
    G / 4 lanes a row), then the one with the fewest padded outputs (idle
    lanes), then the one with more rows. At 2:4 (16 kept values a row a
    step) the 32 x 64 tile resolves one chunk a lane and the 64 x 32 tile
    two, and the 32 x 64 tile was the faster at every ResNet-50 layer
    timed in f32, even at Nc = 196 where it pads more; at 1:4 both
    resolve one and the 64 x 32 tile was as fast or faster
    (``launch/profile_gather.py``, ``PERF.md``)."""
    ks = gather_k_rows(cfg) // cfg.m * cfg.n
    return min(GATHER_TILES, key=lambda t: (
        -(-ks // (t[1] // 4)),  # a group's lanes: 4 columns a lane
        _round_up(mr, t[0]) * _round_up(nc, t[1]), -t[0]))


def gather_ctas_per_sm(tile: tuple[int, int], cfg: NMConfig,
                       b_dtype: torch.dtype, v_dtype: torch.dtype) -> int:
    """CTAs of the gather kernel an SM holds at once: the launch bounds'
    GATHER_CTAS_MAX (registers), or fewer where the shared memory of a
    CTA (:func:`gather_smem`, the card's reserve and the kernel's static
    word included) does not fit that many. ``chip_smoke.py`` holds it to
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    per_cta = (_round_up(gather_smem(tile, cfg, b_dtype, v_dtype) + 16, 128)
               + CTA_SMEM_RESERVED)
    return max(1, min(GATHER_CTAS_MAX, SM_SMEM // per_cta))


def gather_splits(tiles: int, steps: int, sms: int = NUM_SMS,
                  ctas_per_sm: int = GATHER_CTAS_MAX) -> tuple[int, int]:
    """(K steps a split, splits) for a grid of ``tiles`` tiles over
    ``steps`` K steps: one split where the tiles alone give every SM a
    CTA; else the most splits of at least GATHER_MIN_STEPS whole steps
    each (the last may hold fewer) whose grid still fits the card at
    once (``ctas_per_sm`` CTAs an SM), at most GATHER_MAX_SPLITS. A
    split adds a partial that the tile's last CTA reads, and a second
    wave of CTAs costs more than the splits gain (measured on the
    ResNet-50 layer GEMMs, ``PERF.md``)."""
    most = min(GATHER_MAX_SPLITS, steps // GATHER_MIN_STEPS,
               ctas_per_sm * sms // max(tiles, 1))
    if tiles >= sms or most < 2:
        return max(steps, 1), 1
    per = -(-steps // most)
    return per, -(-steps // per)


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """One gather launch: the tile of C, its code, the K step, and how K
    is split. Split ``s`` sums dense rows [s * per * k_rows, (s + 1) *
    per * k_rows) of K; the splits are added in order."""

    tile: tuple
    code: int
    k_rows: int
    steps: int
    per: int
    splits: int
    tiles: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def k_ranges(self, k: int) -> list[tuple[int, int]]:
        """The dense rows [k0, k1) of each split, in split order."""
        span = self.per * self.k_rows
        return [(k0, min(k0 + span, k)) for k0 in range(0, k, span)]


def gather_plan(mr: int, k: int, nc: int, cfg: NMConfig,
                b_dtype: torch.dtype, v_dtype: torch.dtype,
                sms: int = NUM_SMS, *, tile: Optional[tuple] = None,
                per: Optional[int] = None) -> GatherPlan:
    """The gather kernels' launch for C[Mr, Nc] = A[Mr, K] @ B[K, Nc], B
    and vals of these dtypes (int8 vals: ``indexmac_gather_q``), on a
    card of ``sms`` SMs (K a positive multiple of m <= GATHER_M_MAX).
    ``tile`` and ``per`` (K steps a split) replace the rule's choice, to
    time the launches it did not choose (``launch/profile_gather.py``)."""
    tile = tuple(tile) if tile is not None else gather_tile(mr, nc, cfg)
    k_rows = gather_k_rows(cfg)
    steps = -(-k // k_rows)
    tiles = -(-mr // tile[0]) * -(-nc // tile[1])
    if per is None:
        per, splits = gather_splits(
            tiles, steps, sms,
            gather_ctas_per_sm(tile, cfg, b_dtype, v_dtype))
    else:
        splits = -(-steps // per)
    return GatherPlan(tile=tile, code=GATHER_TILES.index(tile),
                      k_rows=k_rows, steps=steps, per=per, splits=splits,
                      tiles=tiles)


def gather_smem(tile: tuple[int, int], cfg: NMConfig, b_dtype: torch.dtype,
                v_dtype: torch.dtype) -> int:
    """Bytes of dynamic shared memory one gather CTA takes (``g_layout``
    in ``indexmac_gather/csrc/indexmac_gather.cuh``): GATHER_STAGES
    stages of the B tile and the strip's vals and idx (rows padded to 16
    bytes), then the resolved strip, 8 bytes a kept value, rows padded to
    a multiple of 4 and 2 more, then an int32 per resolved slot."""
    bm, bn = tile
    kr = gather_k_rows(cfg)
    ks = kr // cfg.m * cfg.n
    stage = (_round_up(kr * bn * b_dtype.itemsize, 16)
             + bm * (_round_up(ks * v_dtype.itemsize, 16)
                     + _round_up(ks, 16)))
    return (GATHER_STAGES * stage + bm * (_round_up(ks, 4) + 2) * 8
            + _round_up(_round_up(ks, 4) * 4, 16))


def gather_block(cfg: NMConfig, mr: int, nc: int) -> tuple[int, int, int]:
    """The (block_m, block_n, block_k) of the gather kernels for an
    Mr x Nc output: block_m rows of A, block_n columns of B, block_k
    dense rows of B per K step (0 where m exceeds GATHER_M_MAX: no
    kernel)."""
    return (*gather_tile(mr, nc, cfg), gather_k_rows(cfg))


def decode_rows(m: int) -> int:
    """Rows the decode kernel computes for M rows: the smallest compiled
    row count that holds them, in launches of at most 8 rows."""
    if m > DECODE_ROWS[-1]:
        return _round_up(m, DECODE_ROWS[-1])
    return next(r for r in DECODE_ROWS if r >= m)


@dataclasses.dataclass(frozen=True)
class PadPlan:
    """Logical dims and the dims the kernel's tiles cover for one call."""

    m: int
    n: int
    k: int
    pm: int
    pn: int
    pk: int
    block: tuple

    @property
    def padded_shape(self) -> tuple:
        return (self.pm, self.pk, self.pn)


def plan_nm_matmul(m: int, n: int, k: int, cfg: NMConfig, block: tuple, *,
                   decode: bool = False) -> Optional[PadPlan]:
    """The geometry of one call under ``block``; None for empty dims or a
    K that holds no whole number of m-blocks, or an m-block larger than
    the kernel's K chunk."""
    bm, bn, bk = block
    if m <= 0 or n <= 0 or k <= 0 or k % cfg.m or bk <= 0:
        return None
    if decode:
        return PadPlan(m=m, n=n, k=k, pm=decode_rows(m),
                       pn=_round_up(n, bn), pk=k, block=tuple(block))
    return PadPlan(m=m, n=n, k=k, pm=_round_up(m, bm), pn=_round_up(n, bn),
                   pk=_round_up(k, bk), block=tuple(block))
