"""Wrappers of the Hopper kernels ``nm_spmm`` (``csrc/nm_spmm.cu``) and
``nm_spmm_q`` (``csrc/nm_spmm_q.cu``), the prefill-shaped N:M products;
they replace the TPU kernels ``nm_spmm_pallas`` and ``nm_spmm_pallas_q``
of ``repro.kernels.indexmac.kernel``.

``nm_spmm(x, vals, idx, cfg)`` computes y = x @ decompress(vals, idx);
``nm_spmm_q(x, vals, idx, scales, cfg)`` takes int8 ``vals`` and f32
per-column ``scales`` and computes y = (x @ decompress(vals, idx)) *
scales. On a CUDA tensor each launches its kernel (or raises), on a CPU
tensor it runs its plain PyTorch version (``*_plain``).
``KERNEL.launches`` / ``KERNEL_Q.launches`` count the launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.sparsity import NMConfig
from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.indexmac.ref import nm_matmul_q_ref, nm_matmul_ref
from repro_torch.kernels.padding import PREFILL_K_ROWS

__all__ = ["KERNEL", "KERNEL_DTYPES", "KERNEL_Q", "check_operands",
           "nm_spmm", "nm_spmm_plain", "nm_spmm_q", "nm_spmm_q_plain"]

# x's dtype codes of the C interface (csrc/common.cuh, DType)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("nm_spmm", (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P))
KERNEL_Q = CudaKernel("nm_spmm_q",
                      (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P))


def nm_spmm_plain(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                  cfg: NMConfig) -> torch.Tensor:
    """Plain version: decompress, f32 product, cast to x's dtype."""
    return nm_matmul_ref(x, vals, idx, cfg)


def nm_spmm_q_plain(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                    scales: torch.Tensor, cfg: NMConfig) -> torch.Tensor:
    """Plain version: decompress int8, f32 product, x scales, cast."""
    return nm_matmul_q_ref(x, vals, idx, scales, cfg)


def check_operands(x, vals, idx, cfg: NMConfig,
                   scales: Optional[torch.Tensor] = None) -> None:
    """Device, dtype, shape and contiguity checks shared by the kernels.
    Without ``scales``: a float family (vals in x's dtype). With them: an
    int8 family (vals int8, scales f32 of shape (N,))."""
    if x.dim() != 2 or vals.dim() != 2:
        raise ValueError(f"x and vals must be 2D, got {tuple(x.shape)} and "
                         f"{tuple(vals.shape)}")
    ops = (x, vals, idx) if scales is None else (x, vals, idx, scales)
    if len({t.device for t in ops}) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{[str(t.device) for t in ops]}")
    if scales is None:
        if x.dtype not in KERNEL_DTYPES or vals.dtype != x.dtype:
            raise ValueError(f"the kernels take f32 or bf16 x and vals of "
                             f"one dtype, got {x.dtype} and {vals.dtype}")
    else:
        if x.dtype not in KERNEL_DTYPES or vals.dtype != torch.int8:
            raise ValueError(f"the int8 kernels take f32 or bf16 x and int8 "
                             f"vals, got {x.dtype} and {vals.dtype}")
        if scales.dtype != torch.float32 or scales.shape != vals.shape[1:]:
            raise ValueError(f"scales must be f32 of shape "
                             f"({vals.shape[1]},), got {scales.dtype} "
                             f"{tuple(scales.shape)}")
    if idx.dtype != torch.int8 or idx.shape != vals.shape:
        raise ValueError(f"idx must be int8 of vals' shape, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    k = x.shape[1]
    if k % cfg.m or vals.shape[0] * cfg.m != k * cfg.n:
        raise ValueError(f"vals rows {vals.shape[0]} inconsistent with "
                         f"K={k} and {cfg.tag}")
    names = ("x", "vals", "idx", "scales")
    for name, t in zip(names, ops):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(kern: CudaKernel, name: str, x, vals, idx, scales,
            cfg: NMConfig) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{x.device}")
    check_operands(x, vals, idx, cfg, scales)
    if cfg.m > PREFILL_K_ROWS:  # a K chunk holds at least one m-block
        raise ValueError(f"{name} takes m <= {PREFILL_K_ROWS}, got "
                         f"{cfg.tag}")
    mm, kk = x.shape
    nn = vals.shape[1]
    y = torch.empty((mm, nn), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    ptrs = [x.data_ptr(), vals.data_ptr(), idx.data_ptr()]
    if scales is not None:
        ptrs.append(scales.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        kern(KERNEL_DTYPES[x.dtype], *ptrs, y.data_ptr(), mm, kk, nn, cfg.n,
             cfg.m, stream)
    return y


def nm_spmm(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
            cfg: NMConfig) -> torch.Tensor:
    """y[M, N] = x[M, K] @ decompress(vals, idx), in x's dtype."""
    if x.device.type == "cpu":
        return nm_spmm_plain(x, vals, idx, cfg)
    return _launch(KERNEL, "nm_spmm", x, vals, idx, None, cfg)


def nm_spmm_q(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
              scales: torch.Tensor, cfg: NMConfig) -> torch.Tensor:
    """y[M, N] = (x[M, K] @ decompress(int8 vals, idx)) * scales[col],
    in x's dtype (f32 or bf16)."""
    if x.device.type == "cpu":
        return nm_spmm_q_plain(x, vals, idx, scales, cfg)
    return _launch(KERNEL_Q, "nm_spmm_q", x, vals, idx, scales, cfg)
