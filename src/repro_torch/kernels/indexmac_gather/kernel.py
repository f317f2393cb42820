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
``KERNEL.launches`` / ``KERNEL_Q.launches`` count the launches: one a
call. The launch geometry (tile, K steps, split-K) is
:func:`repro_torch.kernels.padding.gather_plan`'s, or the ``plan`` a
caller passes to time another (``launch/profile_gather.py``); with more
than one split the wrapper hands the kernel an f32 partial per split
(``torch.empty``) and the tiles' arrival counters (zeroed once per
device and stream, and left zeroed by the kernel), and the last CTA of
each tile adds the partials in split order. :func:`occupancy` reads the
CTAs per SM of a launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.sparsity import NMConfig
from repro_torch.kernels.build import CudaKernel, load
from repro_torch.kernels.indexmac.kernel import KERNEL_DTYPES
from repro_torch.kernels.indexmac_gather.ref import (
    indexmac_gather_q_ref,
    indexmac_gather_ref,
)
from repro_torch.kernels.padding import (
    GATHER_M_MAX,
    GATHER_TILES,
    GatherPlan,
    gather_plan,
    sm_count,
)

__all__ = ["KERNEL", "KERNEL_Q", "check_operands", "indexmac_gather",
           "indexmac_gather_plain", "indexmac_gather_q",
           "indexmac_gather_q_plain", "occupancy"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_TAIL = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)
KERNEL = CudaKernel("indexmac_gather", (_I, _I, _P, _P) + _TAIL)
KERNEL_Q = CudaKernel("indexmac_gather_q", (_I, _P, _P, _P) + _TAIL)
_COUNTERS: dict = {}  # (device index, stream) -> int32 zeros, one a tile


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


def occupancy(b_dtype: torch.dtype, v_dtype: torch.dtype, cfg: NMConfig,
              tile: tuple[int, int]) -> dict:
    """CTAs per SM, threads and dynamic shared memory per CTA of the
    gather kernel (int8 ``v_dtype``: ``indexmac_gather_q``) that a call
    with these dtypes, pattern and tile launches on the current device
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    code = GATHER_TILES.index(tuple(tile))
    out = (ctypes.c_int * 3)()
    if v_dtype == torch.int8:
        fn = getattr(load(KERNEL_Q.name), "indexmac_gather_q_occupancy")
        args = (KERNEL_DTYPES[b_dtype], code, cfg.n, cfg.m, out)
    else:
        fn = getattr(load(KERNEL.name), "indexmac_gather_occupancy")
        args = (KERNEL_DTYPES[b_dtype], KERNEL_DTYPES[v_dtype], code, cfg.n,
                cfg.m, out)
    fn.argtypes = [_I] * (len(args) - 1) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = _I
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"gather occupancy failed with CUDA error {rc}")
    return {"ctas_per_sm": out[0], "threads": out[1], "smem_bytes": out[2]}


def _counters(device: torch.device, stream: int, tiles: int) -> torch.Tensor:
    """The tiles' arrival counters on ``device`` for launches on
    ``stream``: zeros, grown when a launch needs more; every launch leaves
    them zeroed."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def _launch(kern: CudaKernel, name: str, vals, idx, scales, b,
            cfg: NMConfig, plan: Optional[GatherPlan]) -> torch.Tensor:
    if b.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{b.device}")
    check_operands(vals, idx, b, cfg, scales)
    if cfg.m > GATHER_M_MAX:
        raise ValueError(f"{name} takes m <= {GATHER_M_MAX}, got "
                         f"{cfg.tag}")
    mr = vals.shape[0]
    k, nc = b.shape
    c = torch.empty((mr, nc), dtype=b.dtype, device=b.device)
    if c.numel() == 0:
        return c
    if k == 0:
        return c.zero_()
    if scales is None:
        head = (KERNEL_DTYPES[b.dtype], KERNEL_DTYPES[vals.dtype],
                vals.data_ptr(), idx.data_ptr())
    else:
        head = (KERNEL_DTYPES[b.dtype], vals.data_ptr(), idx.data_ptr(),
                scales.data_ptr())
    with torch.cuda.device(b.device):
        if plan is None:
            plan = gather_plan(mr, k, nc, cfg, b.dtype, vals.dtype,
                               sm_count(b.device.index or 0))
        stream = torch.cuda.current_stream().cuda_stream
        partial = counters = None
        if plan.splits > 1:
            bm, bn = plan.tile
            partial = torch.empty(plan.blocks * bm * bn,
                                  dtype=torch.float32, device=b.device)
            counters = _counters(b.device, stream, plan.tiles)
        kern(*head, b.data_ptr(), c.data_ptr(),
             None if partial is None else partial.data_ptr(),
             None if counters is None else counters.data_ptr(),
             mr, k, nc, cfg.n, cfg.m, plan.code, plan.per, plan.splits,
             stream)
    return c


def indexmac_gather(vals: torch.Tensor, idx: torch.Tensor, b: torch.Tensor,
                    cfg: NMConfig, *,
                    plan: Optional[GatherPlan] = None) -> torch.Tensor:
    """C[Mr, Nc] = decompress(vals, idx, axis=1) @ b[K, Nc], in b's dtype;
    on the card at ``plan``'s launch where one is given (its K steps must
    be this call's), else at the host rule's."""
    if b.device.type == "cpu":
        return indexmac_gather_plain(vals, idx, b, cfg)
    return _launch(KERNEL, "indexmac_gather", vals, idx, None, b, cfg, plan)


def indexmac_gather_q(vals: torch.Tensor, idx: torch.Tensor,
                      scales: torch.Tensor, b: torch.Tensor, cfg: NMConfig,
                      *, plan: Optional[GatherPlan] = None) -> torch.Tensor:
    """C[Mr, Nc] = (decompress(int8 vals, idx, axis=1) @ b) * scales[row],
    in b's dtype (f32 or bf16); ``plan`` as for :func:`indexmac_gather`."""
    if b.device.type == "cpu":
        return indexmac_gather_q_plain(vals, idx, scales, b, cfg)
    return _launch(KERNEL_Q, "indexmac_gather_q", vals, idx, scales, b, cfg,
                   plan)
