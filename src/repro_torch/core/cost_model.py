"""Cost models (port of ``repro.core.cost_model``; plain Python
arithmetic): the paper's vector core, and the H100's kernel costs.

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

The card's kernel costs (the counterparts of the JAX package's TPU
kernel accounting, ``tpu_*_cost``): :class:`KernelCost` holds the HBM
bytes a kernel must move and the operations it must do, and its bound at
the card's rates, the larger of the two times. Bytes follow the JAX
package's stream accounting: the activation read once, each kept value
plus its 1-byte idx, an int8 weight's f32 scale row, the output written
once. Operations differ from JAX's on purpose: 2 M a kept non-zero (the
card does the kept values' work; a TPU's MXU multiplies the zeros it
re-materializes), or what ``nnz`` says where the data has fewer
non-zeros. The rates are the NVIDIA H100 80GB HBM3's (SXM, 700 W)
spec-sheet peaks, not measurements: every bound, every roofline term
and every ITL floor of the port reads them from here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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


# ---------------------------------------------------------------------------
# the card's kernel costs (NVIDIA H100 80GB HBM3, SXM, 700 W: spec-sheet
# peaks, not measured)
# ---------------------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12  # HBM3
# dense peaks by operand type: bf16 on the tensor cores; for f32 the
# 3xTF32 rate, 495 / 3 TFLOP/s: an f32-accurate product on the tensor
# cores takes three TF32 products (one pass misses the f32 tolerance), so
# a bound sits below what such a kernel can reach, and above the 67
# TFLOP/s of the f32 CUDA cores
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}


def _ops_dtype(dtype_bytes: float, dtype) -> torch.dtype:
    """The type whose peak bounds a kernel's operations: ``dtype``, else
    f32 for 4-byte activations and bf16 otherwise."""
    if dtype is not None:
        return dtype
    return torch.float32 if dtype_bytes == 4 else torch.bfloat16


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """What a kernel must move and do: ``hbm_bytes`` (each input read
    once, each output written once) and ``flops``, bounded by the peak
    of ``dtype``."""

    hbm_bytes: float
    flops: float
    dtype: torch.dtype = torch.bfloat16

    def t_mem(self, hbm_bw: float = HBM_BYTES_PER_S) -> float:
        return self.hbm_bytes / hbm_bw

    def t_compute(self, peak: Optional[float] = None) -> float:
        return self.flops / (peak or PEAK_OPS_PER_S[self.dtype])

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / self.hbm_bytes

    def bound_ms(self) -> tuple[float, str]:
        """(ms, "bytes" or "operations"): the least time on the card, the
        larger of :meth:`t_mem` and :meth:`t_compute`, and which it is."""
        t_bytes, t_ops = self.t_mem(), self.t_compute()
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")


def roofline_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """:meth:`KernelCost.bound_ms` of ``nbytes`` and ``ops`` at ``dtype``'s
    peak."""
    return KernelCost(nbytes, ops, dtype).bound_ms()


def kept_values(k: int, n: int, cfg: NMConfig) -> int:
    """The kept values of a (k, n) weight compressed along k."""
    return k * n * cfg.n // cfg.m


def dense_cost(m: int, k: int, n: int, dtype_bytes: int = 2,
               out_reread: int = 1, dtype=None) -> KernelCost:
    """x(m,k) @ w(k,n): each operand read once, the output written once."""
    return KernelCost(
        hbm_bytes=(m * k + k * n) * dtype_bytes
        + m * n * dtype_bytes * out_reread,
        flops=2.0 * m * k * n, dtype=_ops_dtype(dtype_bytes, dtype))


def indexmac_cost(m: int, k: int, n: int, cfg: NMConfig,
                  dtype_bytes: int = 2,
                  w_value_bytes: Optional[int] = None,
                  scale_bytes: float = 0.0, *, bias_bytes: float = 0.0,
                  nnz: Optional[int] = None, dtype=None) -> KernelCost:
    """x(m,k) @ W(k,n) with W compressed along k at ``cfg``: x read once,
    each kept value (``w_value_bytes``, default x's) and its idx byte,
    ``scale_bytes`` / ``bias_bytes`` of f32 rows, the output written once
    (the bytes of the JAX ``tpu_indexmac_cost``); 2 m a kept non-zero
    (``nnz``, default every kept value)."""
    if w_value_bytes is None:
        w_value_bytes = dtype_bytes
    kept = kept_values(k, n, cfg)
    return KernelCost(
        hbm_bytes=m * k * dtype_bytes + kept * (w_value_bytes + 1)
        + scale_bytes + bias_bytes + m * n * dtype_bytes,
        flops=2 * m * (kept if nnz is None else nnz),
        dtype=_ops_dtype(dtype_bytes, dtype))


def indexmac_q_cost(m: int, k: int, n: int, cfg: NMConfig,
                    dtype_bytes: int = 2, *, bias_bytes: float = 0.0,
                    nnz: Optional[int] = None, dtype=None) -> KernelCost:
    """The int8 family: one byte a kept value and the f32 scale row (the
    kernels dequantize at writeback, on the same operations)."""
    return indexmac_cost(m, k, n, cfg, dtype_bytes=dtype_bytes,
                         w_value_bytes=1, scale_bytes=4.0 * n,
                         bias_bytes=bias_bytes, nnz=nnz, dtype=dtype)


def gather_cost(mr: int, k: int, nc: int, cfg: NMConfig,
                b_bytes: int = 4, w_value_bytes: Optional[int] = None, *,
                quantized: bool = False, nnz: Optional[int] = None,
                dtype=None) -> KernelCost:
    """C(mr,nc) = A_sp(mr,k) @ B(k,nc), A compressed along k (the gather
    kernels, the paper's orientation): each kept value and its idx byte,
    B and C once, the f32 row scales of an int8 A; 2 nc a kept
    non-zero."""
    if w_value_bytes is None:
        w_value_bytes = 1 if quantized else b_bytes
    kept = kept_values(k, mr, cfg)
    return KernelCost(
        hbm_bytes=kept * (w_value_bytes + 1) + k * nc * b_bytes
        + mr * nc * b_bytes + 4 * mr * int(quantized),
        flops=2 * nc * (kept if nnz is None else nnz),
        dtype=_ops_dtype(b_bytes, dtype))


def attention_cost(b: int, sq: int, hq: int, dk: int, skv: int, hkv: int,
                   dv: int, plan, dtype_bytes: int = 2,
                   dtype=None) -> KernelCost:
    """Block-sparse attention (``bs_attention``): q, k, v and the output
    once each, the mask plan's live tiles at a byte a token pair; 2 (dk +
    dv) a live token pair and q head."""
    nbytes = ((b * sq * hq * dk + b * skv * hkv * (dk + dv)
               + b * sq * hq * dv) * dtype_bytes
              + plan.n_live * plan.bq * plan.bk)
    return KernelCost(nbytes, 2 * (dk + dv) * b * hq * plan.live_tokens,
                      _ops_dtype(dtype_bytes, dtype))


def conv_cost(c_out: int, c_in: int, kh: int, kw: int, h_out: int,
              w_out: int, cfg: NMConfig, *, dtype_bytes: int = 2,
              quantized: bool = False,
              fused_im2col: bool = False) -> KernelCost:
    """One conv as its im2col GEMM in the forward orientation the port's
    conv runs: patches (h_out w_out, c_in kh kw) x the compressed weight
    (c_in kh kw, c_out). ``fused_im2col`` charges the activation once
    (h_out w_out c_in bytes, a fused-gather lower bound) instead of the
    materialized patches (the JAX ``tpu_conv_cost``)."""
    m, k, n_pix = c_out, c_in * kh * kw, h_out * w_out
    fn = indexmac_q_cost if quantized else indexmac_cost
    cost = fn(n_pix, k, m, cfg, dtype_bytes=dtype_bytes)
    if fused_im2col and kh * kw > 1:
        saved = (n_pix * k - n_pix * c_in) * dtype_bytes
        cost = dataclasses.replace(cost, hbm_bytes=cost.hbm_bytes - saved)
    return cost
