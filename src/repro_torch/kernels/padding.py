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
* ``nm_spmm_decode`` and ``nm_spmm_decode_q``: M rows taken as they are
  (1, 2, 4 or 8 rows per launch), 32 threads x ``vec`` columns per block,
  x staged in K chunks of at most 1024 rows. ``vec`` follows the item
  size of ``vals`` (not of x): one 16-byte load of float values, or
  one 8-byte load of 8 int8 values (``nm_spmm_decode_q.cu`` says why
  not 16), when N allows it.
* ``indexmac_gather`` and ``indexmac_gather_q`` (the paper's
  orientation C[Mr, Nc] = A @ B): 32 x 64 tiles of C, K walked in steps
  of whole m-blocks, at most 64 dense rows each.
"""
from __future__ import annotations

import dataclasses
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
DECODE_K_ROWS = 1024
GATHER_TILE = (32, 64)
GATHER_K_ROWS = 64


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def decode_vec(n: int, itemsize: int) -> int:
    """Columns per thread of the decode kernels for ``vals`` of
    ``itemsize`` bytes: one 16-byte load of float values, or one 8-byte
    load of int8 values, when every row of N starts aligned to that load;
    else 1."""
    vec = 8 if itemsize == 1 else 16 // itemsize
    return vec if n % vec == 0 else 1


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


def decode_block(cfg: NMConfig, n: int, itemsize: int) -> tuple[int, int, int]:
    """The (rows, block_n, block_k) of the decode kernels for this N and
    ``vals`` of ``itemsize`` bytes."""
    return (DECODE_ROWS[-1], 32 * decode_vec(n, itemsize),
            (DECODE_K_ROWS // cfg.m) * cfg.m)


def gather_block(cfg: NMConfig) -> tuple[int, int, int]:
    """The (block_m, block_n, block_k) of the gather kernels: block_m rows
    of A, block_n columns of B, block_k dense rows of B per K step (0
    when an m-block does not fit a step: no kernel)."""
    return (*GATHER_TILE, (GATHER_K_ROWS // cfg.m) * cfg.m)


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
