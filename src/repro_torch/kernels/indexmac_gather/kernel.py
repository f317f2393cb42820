"""Wrappers of the Hopper kernels ``indexmac_gather``
(``csrc/indexmac_gather.cu``) and ``indexmac_gather_q``
(``csrc/indexmac_gather_q.cu``), the paper's Algorithm 3 (vindexmac)
taken literally; they replace the TPU kernels ``indexmac_gather_pallas``
and ``indexmac_gather_pallas_q`` of
``repro.kernels.indexmac_gather.kernel``.

``indexmac_gather(vals, idx, b, cfg)`` computes C = A @ b with A
compressed along its rows (``vals``/``idx`` of shape (Mr, K*n/m));
``indexmac_gather_q(vals, idx, scales, b, cfg)`` takes int8 ``vals`` and
f32 per-row ``scales`` and computes C = (A8 @ b) * scales[row]. C is in
b's dtype. On a CUDA tensor each launches its kernel (or raises), on a
CPU tensor it runs its plain PyTorch version (``*_plain``).
``KERNEL.launches`` / ``KERNEL_Q.launches`` count the launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.sparsity import NMConfig
from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.indexmac.kernel import KERNEL_DTYPES
from repro_torch.kernels.indexmac_gather.ref import (
    indexmac_gather_q_ref,
    indexmac_gather_ref,
)
from repro_torch.kernels.padding import GATHER_K_ROWS

__all__ = ["KERNEL", "KERNEL_Q", "check_operands", "indexmac_gather",
           "indexmac_gather_plain", "indexmac_gather_q",
           "indexmac_gather_q_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("indexmac_gather",
                    (_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P))
KERNEL_Q = CudaKernel("indexmac_gather_q",
                      (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P))


def indexmac_gather_plain(vals: torch.Tensor, idx: torch.Tensor,
                          b: torch.Tensor, cfg: NMConfig) -> torch.Tensor:
    """Plain version: decompress A, f32 product, cast to b's dtype."""
    return indexmac_gather_ref(vals, idx, b, cfg)


def indexmac_gather_q_plain(vals: torch.Tensor, idx: torch.Tensor,
                            scales: torch.Tensor, b: torch.Tensor,
                            cfg: NMConfig) -> torch.Tensor:
    """Plain version: decompress int8 A, f32 product, x row scales, cast."""
    return indexmac_gather_q_ref(vals, idx, scales, b, cfg)


def check_operands(vals, idx, b, cfg: NMConfig,
                   scales: Optional[torch.Tensor] = None) -> None:
    """Device, dtype, shape and contiguity checks of both kernels. Without
    ``scales``: vals f32 or bf16; with them: vals int8 and scales f32 of
    shape (Mr,). b is f32 or bf16 either way."""
    if vals.dim() != 2 or b.dim() != 2:
        raise ValueError(f"vals and b must be 2D, got {tuple(vals.shape)} "
                         f"and {tuple(b.shape)}")
    ops = (vals, idx, b) if scales is None else (vals, idx, b, scales)
    if len({t.device for t in ops}) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{[str(t.device) for t in ops]}")
    if b.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the gather kernels take f32 or bf16 b, got "
                         f"{b.dtype}")
    if scales is None:
        if vals.dtype not in KERNEL_DTYPES:
            raise ValueError(f"the gather kernel takes f32 or bf16 vals, "
                             f"got {vals.dtype}")
    else:
        if vals.dtype != torch.int8:
            raise ValueError(f"the int8 gather kernel takes int8 vals, got "
                             f"{vals.dtype}")
        if scales.dtype != torch.float32 or scales.shape != vals.shape[:1]:
            raise ValueError(f"scales must be f32 of shape "
                             f"({vals.shape[0]},), got {scales.dtype} "
                             f"{tuple(scales.shape)}")
    if idx.dtype != torch.int8 or idx.shape != vals.shape:
        raise ValueError(f"idx must be int8 of vals' shape, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    k = b.shape[0]
    if k % cfg.m or vals.shape[1] * cfg.m != k * cfg.n:
        raise ValueError(f"vals columns {vals.shape[1]} inconsistent with "
                         f"K={k} and {cfg.tag}")
    for name, t in zip(("vals", "idx", "b", "scales"), ops):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(kern: CudaKernel, name: str, vals, idx, scales, b,
            cfg: NMConfig) -> torch.Tensor:
    if b.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{b.device}")
    check_operands(vals, idx, b, cfg, scales)
    if cfg.m > GATHER_K_ROWS:  # a K step holds at least one m-block
        raise ValueError(f"{name} takes m <= {GATHER_K_ROWS}, got "
                         f"{cfg.tag}")
    mr = vals.shape[0]
    k, nc = b.shape
    c = torch.empty((mr, nc), dtype=b.dtype, device=b.device)
    if c.numel() == 0:
        return c
    if scales is None:
        head = (KERNEL_DTYPES[b.dtype], KERNEL_DTYPES[vals.dtype],
                vals.data_ptr(), idx.data_ptr())
    else:
        head = (KERNEL_DTYPES[b.dtype], vals.data_ptr(), idx.data_ptr(),
                scales.data_ptr())
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        kern(*head, b.data_ptr(), c.data_ptr(), mr, k, nc, cfg.n, cfg.m,
             stream)
    return c


def indexmac_gather(vals: torch.Tensor, idx: torch.Tensor, b: torch.Tensor,
                    cfg: NMConfig) -> torch.Tensor:
    """C[Mr, Nc] = decompress(vals, idx, axis=1) @ b[K, Nc], in b's dtype."""
    if b.device.type == "cpu":
        return indexmac_gather_plain(vals, idx, b, cfg)
    return _launch(KERNEL, "indexmac_gather", vals, idx, None, b, cfg)


def indexmac_gather_q(vals: torch.Tensor, idx: torch.Tensor,
                      scales: torch.Tensor, b: torch.Tensor,
                      cfg: NMConfig) -> torch.Tensor:
    """C[Mr, Nc] = (decompress(int8 vals, idx, axis=1) @ b) * scales[row],
    in b's dtype (f32 or bf16)."""
    if b.device.type == "cpu":
        return indexmac_gather_q_plain(vals, idx, scales, b, cfg)
    return _launch(KERNEL_Q, "indexmac_gather_q", vals, idx, scales, b, cfg)
