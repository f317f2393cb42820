"""Wrappers of the Hopper kernels ``nm_spmm_decode``
(``csrc/nm_spmm_decode.cu``) and ``nm_spmm_decode_q``
(``csrc/nm_spmm_decode_q.cu``), the skinny-M N:M products with the
epilogue fused in; they replace the TPU kernels
``repro.kernels.indexmac.decode_kernel.nm_spmm_pallas_decode`` and
``nm_spmm_pallas_decode_q``.

``nm_spmm_decode(x, vals, idx, bias, cfg, activation)`` computes
act(x @ decompress(vals, idx) + bias); ``nm_spmm_decode_q(x, vals, idx,
scales, bias, cfg, activation)`` takes int8 ``vals`` and f32 per-column
``scales`` and computes act((x @ decompress(vals, idx)) * scales + bias).
On a CUDA tensor each launches its kernel (or raises), on a CPU tensor it
runs its plain version (``*_plain``). ``KERNEL.launches`` /
``KERNEL_Q.launches`` count the wrapper's launches (one per call of at
most 8 rows; the split-K finishing pass rides in the same call).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.sparsity import NMConfig
from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.epilogue import ACTIVATION_CODES
from repro_torch.kernels.indexmac.kernel import KERNEL_DTYPES, check_operands
from repro_torch.kernels.indexmac.ref import (
    nm_matmul_decode_q_ref,
    nm_matmul_decode_ref,
)
from repro_torch.kernels.padding import (
    DECODE_K_ROWS,
    DECODE_ROWS,
    decode_vec,
    sm_count,
)

__all__ = ["KERNEL", "KERNEL_Q", "nm_spmm_decode", "nm_spmm_decode_plain",
           "nm_spmm_decode_q", "nm_spmm_decode_q_plain", "split_k"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("nm_spmm_decode",
                    (_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _I, _I, _P))
KERNEL_Q = CudaKernel("nm_spmm_decode_q",
                      (_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _I, _I, _I, _I, _P))
# fewest m-blocks a split of K takes: below this the staging of x and the
# partial sums cost more than the extra blocks win
_MIN_SPLIT_BLOCKS = 32


def nm_spmm_decode_plain(x: torch.Tensor, vals: torch.Tensor,
                         idx: torch.Tensor, bias: Optional[torch.Tensor],
                         cfg: NMConfig,
                         activation: Optional[str]) -> torch.Tensor:
    """Plain version: f32 product, + bias, activation, cast to x's dtype."""
    return nm_matmul_decode_ref(x, vals, idx, bias, cfg, activation)


def nm_spmm_decode_q_plain(x: torch.Tensor, vals: torch.Tensor,
                           idx: torch.Tensor, scales: torch.Tensor,
                           bias: Optional[torch.Tensor], cfg: NMConfig,
                           activation: Optional[str]) -> torch.Tensor:
    """Plain version: f32 product, x scales, + bias, activation, cast."""
    return nm_matmul_decode_q_ref(x, vals, idx, scales, bias, cfg,
                                  activation)


def split_k(kc: int, n_col_blocks: int, cfg: NMConfig, sms: int):
    """(rows_per_split, splits): split the Kc compressed rows so that the
    grid holds about two blocks per SM, each split whole m-blocks and at
    least ``_MIN_SPLIT_BLOCKS`` of them."""
    if kc == 0:
        return cfg.n, 1
    want = math.ceil(2 * sms / n_col_blocks)
    most = max(1, kc // (cfg.n * _MIN_SPLIT_BLOCKS))
    splits = max(1, min(want, most))
    rows = math.ceil(math.ceil(kc / splits) / cfg.n) * cfg.n
    return rows, math.ceil(kc / rows)


def _launch(kern: CudaKernel, name: str, x, vals, idx, scales, bias,
            cfg: NMConfig, activation) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{x.device}")
    check_operands(x, vals, idx, cfg, scales)
    if cfg.m > DECODE_K_ROWS:
        raise ValueError(f"{name} takes m <= {DECODE_K_ROWS}, got {cfg.tag}")
    mm, kk = x.shape
    kc, nn = vals.shape
    if bias is not None:
        if bias.shape != (nn,) or bias.device != x.device:
            raise ValueError(f"bias must be ({nn},) on {x.device}, got "
                             f"{tuple(bias.shape)} on {bias.device}")
        bias = bias.to(torch.float32).contiguous()
    y = torch.empty((mm, nn), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    # the vector width follows vals' item size; the loads need vals and
    # idx rows aligned to it
    vec = decode_vec(nn, vals.element_size())
    if vals.data_ptr() % (vec * vals.element_size()) or idx.data_ptr() % vec:
        vec = 1
    n_col_blocks = math.ceil(nn / (32 * vec))
    weights = [vals.data_ptr(), idx.data_ptr()]
    if scales is not None:
        weights.append(scales.data_ptr())
    with torch.cuda.device(x.device):
        rows, splits = split_k(kc, n_col_blocks, cfg,
                               sm_count(x.device.index or 0))
        stream = torch.cuda.current_stream().cuda_stream
        step = DECODE_ROWS[-1]
        for r0 in range(0, mm, step):
            xg, yg = x[r0:r0 + step], y[r0:r0 + step]
            partial = torch.empty((splits, xg.shape[0], nn),
                                  dtype=torch.float32, device=x.device)
            kern(KERNEL_DTYPES[x.dtype], ACTIVATION_CODES[activation],
                 xg.data_ptr(), *weights,
                 bias.data_ptr() if bias is not None else None,
                 yg.data_ptr(), partial.data_ptr(), xg.shape[0], kk, nn,
                 cfg.n, cfg.m, vec, rows, splits, stream)
    return y


def nm_spmm_decode(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                   bias: Optional[torch.Tensor], cfg: NMConfig,
                   activation: Optional[str] = None) -> torch.Tensor:
    """y[M, N] = act(x[M, K] @ decompress(vals, idx) + bias), x's dtype."""
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if x.device.type == "cpu":
        return nm_spmm_decode_plain(x, vals, idx, bias, cfg, activation)
    return _launch(KERNEL, "nm_spmm_decode", x, vals, idx, None, bias, cfg,
                   activation)


def nm_spmm_decode_q(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                     scales: torch.Tensor, bias: Optional[torch.Tensor],
                     cfg: NMConfig,
                     activation: Optional[str] = None) -> torch.Tensor:
    """y[M, N] = act((x[M, K] @ decompress(int8 vals, idx)) * scales
    + bias), in x's dtype (f32 or bf16)."""
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if x.device.type == "cpu":
        return nm_spmm_decode_q_plain(x, vals, idx, scales, bias, cfg,
                                      activation)
    return _launch(KERNEL_Q, "nm_spmm_decode_q", x, vals, idx, scales, bias,
                   cfg, activation)
