"""Wrapper of the Hopper kernel ``nm_spmm`` (``csrc/nm_spmm.cu``), the
prefill-shaped N:M product; it replaces the TPU kernel
``repro.kernels.indexmac.kernel.nm_spmm_pallas``.

``nm_spmm(x, vals, idx, cfg)`` computes y = x @ decompress(vals, idx):
on a CUDA tensor it launches the kernel (or raises), on a CPU tensor it
runs :func:`nm_spmm_plain`, the same function in plain PyTorch.
``KERNEL.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sparsity import NMConfig
from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.indexmac.ref import nm_matmul_ref
from repro_torch.kernels.padding import PREFILL_K_ROWS

__all__ = ["KERNEL", "KERNEL_DTYPES", "nm_spmm", "nm_spmm_plain"]

# dtype codes of the C interface (csrc/common.cuh, DType)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("nm_spmm", (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P))


def nm_spmm_plain(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                  cfg: NMConfig) -> torch.Tensor:
    """Plain version: decompress, f32 product, cast to x's dtype."""
    return nm_matmul_ref(x, vals, idx, cfg)


def check_operands(x, vals, idx, cfg: NMConfig) -> None:
    """Device, dtype, shape and contiguity checks shared by both kernels."""
    if x.dim() != 2 or vals.dim() != 2:
        raise ValueError(f"x and vals must be 2D, got {tuple(x.shape)} and "
                         f"{tuple(vals.shape)}")
    if not (x.device == vals.device == idx.device):
        raise ValueError(f"operands on different devices: {x.device}, "
                         f"{vals.device}, {idx.device}")
    if x.dtype not in KERNEL_DTYPES or vals.dtype != x.dtype:
        raise ValueError(f"the kernels take f32 or bf16 x and vals of one "
                         f"dtype, got {x.dtype} and {vals.dtype}")
    if idx.dtype != torch.int8 or idx.shape != vals.shape:
        raise ValueError(f"idx must be int8 of vals' shape, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    k = x.shape[1]
    if k % cfg.m or vals.shape[0] * cfg.m != k * cfg.n:
        raise ValueError(f"vals rows {vals.shape[0]} inconsistent with "
                         f"K={k} and {cfg.tag}")
    for name, t in (("x", x), ("vals", vals), ("idx", idx)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def nm_spmm(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
            cfg: NMConfig) -> torch.Tensor:
    """y[M, N] = x[M, K] @ decompress(vals, idx), in x's dtype."""
    if x.device.type == "cpu":
        return nm_spmm_plain(x, vals, idx, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"nm_spmm runs on cuda or cpu tensors, not "
                         f"{x.device}")
    check_operands(x, vals, idx, cfg)
    if cfg.m > PREFILL_K_ROWS:  # a K chunk holds at least one m-block
        raise ValueError(f"nm_spmm takes m <= {PREFILL_K_ROWS}, got "
                         f"{cfg.tag}")
    mm, kk = x.shape
    nn = vals.shape[1]
    y = torch.empty((mm, nn), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL(KERNEL_DTYPES[x.dtype], x.data_ptr(), vals.data_ptr(),
               idx.data_ptr(), y.data_ptr(), mm, kk, nn, cfg.n, cfg.m, stream)
    return y
