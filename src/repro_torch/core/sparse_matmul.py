"""Algorithm-level references for the paper's three matmul formulations
(port of ``repro.core.sparse_matmul``).

Semantic models in plain PyTorch of the paper's Algorithms 1-3: all three
compute the same C = A @ B and differ in which operand representation
they touch and how often, which is what the paper's evaluation measures.
The traffic functions count those touches (plain Python arithmetic).

Orientation follows the paper: A is the structured-sparse left operand,
compressed along its rows (the contraction dim, ``compress_nm(axis=1)``);
B is dense.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.sparsity import NMConfig

__all__ = [
    "rowwise_dense_matmul",
    "rowwise_spmm",
    "indexmac_spmm",
    "TrafficReport",
    "rowwise_spmm_traffic",
    "indexmac_traffic",
]


def rowwise_dense_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Algorithm 1 (dense row-wise): C[i,:] = sum_k A[i,k] * B[k,:]."""
    return torch.einsum("ik,kn->in", a, b)


def _block_base(knm: int, cfg: NMConfig, device) -> torch.Tensor:
    """First dense row of the m-block each compressed slot belongs to."""
    nblocks = knm // cfg.n
    return torch.arange(nblocks, device=device).repeat_interleave(cfg.n) * cfg.m


def rowwise_spmm(values: torch.Tensor, col_idx: torch.Tensor,
                 b: torch.Tensor, cfg: NMConfig) -> torch.Tensor:
    """Algorithm 2: row-wise sparse-dense matmul from the compressed form.

    values/col_idx: (rows, K*n/m) as ``compress_nm(axis=1)`` makes them.
    Nonzero j of block bl addresses the *global* row bl*m + col_idx of B
    (the paper adds B's base address, its line 5); the rows are gathered,
    one per nonzero: the per-nonzero "vload B[row,:]" of its line 8.
    """
    gidx = col_idx.long() + _block_base(values.shape[1], cfg,
                                        values.device)[None, :]
    b_rows = b[gidx]  # (rows, knm, N): one vload per nonzero
    return torch.einsum("rj,rjn->rn", values.to(b.dtype), b_rows)


def indexmac_spmm(values: torch.Tensor, col_idx: torch.Tensor,
                  b: torch.Tensor, cfg: NMConfig,
                  l_rows: int = 16) -> torch.Tensor:
    """Algorithm 3 semantics: B is loaded tile by tile (L rows at a time)
    and the bounded indices select rows *from the tile* (the vindexmac
    indirect register read). Numerically Algorithm 2; structured as a
    loop over stationary tiles of B to model the dataflow. ``l_rows``
    must be a multiple of m (paper section III)."""
    if l_rows % cfg.m != 0:
        raise ValueError("L must be a multiple of M")
    k = b.shape[0]
    if k % l_rows != 0:
        raise ValueError(f"K={k} not divisible by L={l_rows}")
    rows = values.shape[0]
    blocks_per_tile = l_rows // cfg.m
    nz_per_tile = blocks_per_tile * cfg.n
    ntiles = k // l_rows
    vt = values.reshape(rows, ntiles, nz_per_tile)
    it = col_idx.reshape(rows, ntiles, nz_per_tile).long()
    # index *within the stationary tile*: block-within-tile * m + col_idx
    tile_idx = it + _block_base(nz_per_tile, cfg, values.device)[None, None]
    bt = b.reshape(ntiles, l_rows, -1)
    c = torch.zeros((rows, b.shape[1]),
                    dtype=torch.promote_types(values.dtype, b.dtype),
                    device=b.device)
    for t in range(ntiles):
        # vrf[tile_idx]: an indirect read of the stationary tile, no B
        # memory traffic; the one-hot keeps it a select (bounded index)
        sel = F.one_hot(tile_idx[:, t], l_rows).to(bt.dtype)
        c = c + torch.einsum("rj,rjl,ln->rn", vt[:, t].to(bt.dtype), sel,
                             bt[t])
    return c


# ---------------------------------------------------------------------------
# Operand-traffic accounting (paper Fig. 6). Counts *vector memory
# accesses* as the paper's gem5 runs do: one access per vector-register-
# width load or store, in units of vector-length rows.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrafficReport:
    loads_a: float  # values + col_idx vector loads
    loads_b: float
    loads_c: float
    stores_c: float

    @property
    def total(self) -> float:
        return self.loads_a + self.loads_b + self.loads_c + self.stores_c


def _common(k: int, n_cols: int, cfg: NMConfig, vlen: int):
    nnz_row = k * cfg.n // cfg.m  # non-zeros per row of A
    a_vec_loads = 2 * -(-nnz_row // vlen)  # values + col_idx per row of A
    c_tiles = -(-n_cols // vlen)  # vector tiles per row of C
    return nnz_row, a_vec_loads, c_tiles


def rowwise_spmm_traffic(rows_a: int, k: int, n_cols: int, cfg: NMConfig,
                         vlen: int = 16) -> TrafficReport:
    """Algorithm 2, B-stationary over column tiles (the paper's best
    baseline dataflow): per column tile of B/C every row of A re-streams
    its values/idx and loads one vector of B per nonzero; the C row is
    stored once per tile."""
    nnz_row, a_vec_loads, c_tiles = _common(k, n_cols, cfg, vlen)
    loads_a = rows_a * a_vec_loads * c_tiles
    loads_b = rows_a * nnz_row * c_tiles  # one vload B[row,:] per nonzero
    stores_c = rows_a * c_tiles
    return TrafficReport(loads_a, loads_b, 0.0, stores_c)


def indexmac_traffic(rows_a: int, k: int, n_cols: int, cfg: NMConfig,
                     vlen: int = 16, l_rows: int = 16) -> TrafficReport:
    """Algorithm 3: B loaded exactly once (tile preloads); C reloaded and
    stored once per (row, B tile), because the accumulator register is
    reused across stationary tiles (the paper's lines 8 and 15)."""
    nnz_row, a_vec_loads, c_tiles = _common(k, n_cols, cfg, vlen)
    ntiles_b = -(-k // l_rows)
    loads_b = ntiles_b * l_rows * c_tiles  # each row of B once per tile col
    loads_a = rows_a * a_vec_loads * c_tiles  # same A streaming as Alg. 2
    loads_c = rows_a * c_tiles * ntiles_b
    stores_c = rows_a * c_tiles * ntiles_b
    return TrafficReport(loads_a, loads_b, loads_c, stores_c)
