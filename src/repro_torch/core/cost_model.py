"""The paper's cost model (port of the paper-facing part of
``repro.core.cost_model``; plain Python arithmetic).

:class:`VectorCoreModel` is a calibrated instruction and memory-stall
model of the paper's simulated RISC-V decoupled vector core (Table I:
512-bit / 16-lane engine, L2 8-cycle hit). It counts the exact vector
instruction streams of Algorithm 2 (Row-Wise-SpMM) and Algorithm 3
(vindexmac) and charges a calibrated average exposed stall per indexed
vector load. One constant (``stall_indexed``) is calibrated once so the
ResNet50 1:4 average speedup matches the paper; the per-layer trends,
2:4 and the other CNNs are then predicted.

Per-nonzero instruction streams (per output column tile):
  Alg. 2:  vload B[row] | smove idx->addr | vmacc | slide vals | slide idx
  Alg. 3:  smove idx | vindexmac | slide vals | slide idx
Row overheads: vload vals/idx strips, C handling (Alg. 3 reloads/stores C
once per stationary B tile; Alg. 2 stores once), B-tile preloads (Alg. 3).

The JAX package's TPU roofline functions model a TPU and are not ported.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.sparse_matmul import (
    indexmac_traffic,
    rowwise_spmm_traffic,
)
from repro_torch.core.sparsity import NMConfig

VLEN = 16  # 32-bit lanes (512-bit vector engine)
L_ROWS = 16  # stationary B-tile rows (paper section IV-A)


@dataclasses.dataclass(frozen=True)
class VectorCoreModel:
    """Cycle model with one calibrated constant.

    *Streaming* loads (A value/idx strips, C rows, B-tile preloads:
    sequential addresses) issue at 1 cycle; *indexed* loads (Alg. 2's
    per-nonzero B[row,:]) expose ``stall_indexed`` extra cycles on
    average (L2 hit is 8 cycles; the OoO core and unrolling hide part).
    """

    stall_indexed: float = 3.5

    def _tiles(self, n_cols: int) -> int:
        return -(-n_cols // VLEN)

    def cycles_rowwise(self, m: int, k: int, n: int, cfg: NMConfig) -> float:
        """Algorithm 2, B-stationary (the paper's best baseline dataflow)."""
        nnz = k * cfg.n // cfg.m
        ct = self._tiles(n)
        a_strips = -(-nnz // VLEN)
        # per nonzero: vload B (indexed) + smove + vmacc + 2 slides
        per_nnz = 5.0 + self.stall_indexed
        per_row = nnz * per_nnz + 2 * a_strips + 1  # A strips + C store
        return m * ct * per_row

    def cycles_indexmac(self, m: int, k: int, n: int,
                        cfg: NMConfig) -> float:
        """Algorithm 3: vindexmac + stationary B tiles."""
        nnz = k * cfg.n // cfg.m
        ct = self._tiles(n)
        a_strips = -(-nnz // VLEN)
        btiles = -(-k // L_ROWS)
        per_nnz = 4.0  # smove + vindexmac + 2 slides, no memory access
        per_row = nnz * per_nnz + 2 * a_strips + 2 * btiles + 1  # C ld/st
        preload = btiles * L_ROWS  # streaming, once per column tile
        return m * ct * per_row + ct * preload

    def speedup(self, m: int, k: int, n: int, cfg: NMConfig) -> float:
        return (self.cycles_rowwise(m, k, n, cfg)
                / self.cycles_indexmac(m, k, n, cfg))

    def memory_reduction(self, m: int, k: int, n: int,
                         cfg: NMConfig) -> float:
        base = rowwise_spmm_traffic(m, k, n, cfg, VLEN).total
        prop = indexmac_traffic(m, k, n, cfg, VLEN, L_ROWS).total
        return 1.0 - prop / base


def conv_gemm_dims(c_out: int, c_in: int, kh: int, kw: int,
                   h_out: int, w_out: int) -> tuple[int, int, int]:
    """(M, K, N) of the im2col GEMM: M=C_out, K=C_in*kh*kw, N=H_out*W_out."""
    return c_out, c_in * kh * kw, h_out * w_out
