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

* ``nm_spmm`` and ``nm_spmm_q`` (prefill families): 64 x 64 output
  tiles, K walked in chunks of whole m-blocks, at most 32 dense rows
  each.
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

from repro_torch.core.sparsity import NMConfig

PREFILL_TILE = (64, 64)
PREFILL_K_ROWS = 32
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


def prefill_block(cfg: NMConfig) -> tuple[int, int, int]:
    """The (block_m, block_n, block_k) ``nm_spmm`` / ``nm_spmm_q`` are
    compiled for."""
    return (*PREFILL_TILE, (PREFILL_K_ROWS // cfg.m) * cfg.m)


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
