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
``KERNEL_Q.launches`` count the launches: one per call of at most 8
rows, the split-K sum included. The launch geometry is
:func:`repro_torch.kernels.padding.decode_plan`'s, or the ``plan`` a
caller passes to time another; with more than one split the wrapper
hands the kernel an f32 workspace for the splits' partials and the
column tiles' arrival counters, both kept per device and stream (the
counters zeroed once and left zeroed by the kernel), so a call
allocates, clears and synchronises nothing beyond its output. A step
captured as a CUDA graph owns its own (``kernels.capture.scope``).
:func:`occupancy` reads the CTAs per SM of a launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.sparsity import NMConfig
from repro_torch.kernels import capture
from repro_torch.kernels.build import CudaKernel, load
from repro_torch.kernels.epilogue import ACTIVATION_CODES
from repro_torch.kernels.indexmac.kernel import KERNEL_DTYPES, check_operands
from repro_torch.kernels.indexmac.ref import (
    nm_matmul_decode_q_ref,
    nm_matmul_decode_ref,
)
from repro_torch.kernels.padding import (
    DECODE_K_ROWS,
    DECODE_ROWS,
    DecodePlan,
    decode_plan,
    sm_count,
)

__all__ = ["KERNEL", "KERNEL_Q", "nm_spmm_decode", "nm_spmm_decode_plain",
           "nm_spmm_decode_q", "nm_spmm_decode_q_plain", "occupancy"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_TAIL = (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)
KERNEL = CudaKernel("nm_spmm_decode", (_I, _I, _P, _P, _P, _P) + _TAIL)
KERNEL_Q = CudaKernel("nm_spmm_decode_q",
                      (_I, _I, _P, _P, _P, _P, _P) + _TAIL)
# (device index, stream) -> int32 zeros, one a column tile; f32 workspace
_COUNTERS: dict = {}
_WORKSPACE: dict = {}


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


def occupancy(x_dtype: torch.dtype, v_dtype: torch.dtype,
              rows: int) -> dict:
    """CTAs per SM, threads, dynamic shared memory per CTA, registers and
    local memory (spills) per thread of the decode kernel (int8
    ``v_dtype``: ``nm_spmm_decode_q``) that computes ``rows`` rows (1, 2,
    4 or 8) for x in ``x_dtype``, on the current device
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``,
    ``cudaFuncGetAttributes``)."""
    kern = KERNEL_Q if v_dtype == torch.int8 else KERNEL
    fn = getattr(load(kern.name), kern.name + "_occupancy")
    fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = _I
    out = (ctypes.c_int * 5)()
    rc = fn(KERNEL_DTYPES[x_dtype], rows, out)
    if rc != 0:
        raise RuntimeError(f"decode occupancy failed with CUDA error {rc}")
    return {"ctas_per_sm": out[0], "threads": out[1], "smem_bytes": out[2],
            "registers": out[3], "local_bytes": out[4]}


def _scratch(cache: dict, device: torch.device, stream: int, numel: int,
             dtype: torch.dtype) -> torch.Tensor:
    """A buffer of at least ``numel`` elements kept for launches on
    ``device`` and ``stream`` (zeros when made; grown when a launch needs
    more); inside a capture scope, the scope's own
    (:mod:`repro_torch.kernels.capture`)."""
    cache = capture.scratch_cache(cache)
    key = (device.index, stream)
    buf = cache.get(key)
    if buf is None or buf.numel() < numel:
        buf = torch.zeros(max(numel, 1024), dtype=dtype, device=device)
        cache[key] = buf
    return buf


def _launch(kern: CudaKernel, name: str, x, vals, idx, scales, bias,
            cfg: NMConfig, activation,
            plan: Optional[DecodePlan]) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{x.device}")
    check_operands(x, vals, idx, cfg, scales)
    if cfg.m > DECODE_K_ROWS:
        raise ValueError(f"{name} takes m <= {DECODE_K_ROWS}, got {cfg.tag}")
    mm, kk = x.shape
    nn = vals.shape[1]
    if bias is not None:
        if bias.shape != (nn,) or bias.device != x.device:
            raise ValueError(f"bias must be ({nn},) on {x.device}, got "
                             f"{tuple(bias.shape)} on {bias.device}")
        bias = bias.to(torch.float32).contiguous()
    y = torch.empty((mm, nn), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    weights = [vals.data_ptr(), idx.data_ptr()]
    if scales is not None:
        weights.append(scales.data_ptr())
    with torch.cuda.device(x.device):
        sms = sm_count(x.device.index or 0)
        stream = torch.cuda.current_stream().cuda_stream
        step = DECODE_ROWS[-1]
        for r0 in range(0, mm, step):
            xg, yg = x[r0:r0 + step], y[r0:r0 + step]
            mg = xg.shape[0]
            p = plan or decode_plan(mg, kk, nn, cfg, vals.element_size(), sms)
            ws = counters = None
            if p.splits > 1:
                ws = _scratch(_WORKSPACE, x.device, stream,
                              p.splits * mg * nn, torch.float32).data_ptr()
                counters = _scratch(_COUNTERS, x.device, stream, p.tiles,
                                    torch.int32).data_ptr()
            kern(KERNEL_DTYPES[x.dtype], ACTIVATION_CODES[activation],
                 xg.data_ptr(), *weights,
                 bias.data_ptr() if bias is not None else None,
                 yg.data_ptr(), ws, counters, mg, kk, nn, cfg.n, cfg.m,
                 p.cols, p.per, p.splits, stream)
    return y


def nm_spmm_decode(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                   bias: Optional[torch.Tensor], cfg: NMConfig,
                   activation: Optional[str] = None, *,
                   plan: Optional[DecodePlan] = None) -> torch.Tensor:
    """y[M, N] = act(x[M, K] @ decompress(vals, idx) + bias), x's dtype;
    on the card at ``plan``'s launch where one is given (for every group
    of 8 rows), else at the host rule's."""
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if x.device.type == "cpu":
        return nm_spmm_decode_plain(x, vals, idx, bias, cfg, activation)
    return _launch(KERNEL, "nm_spmm_decode", x, vals, idx, None, bias, cfg,
                   activation, plan)


def nm_spmm_decode_q(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                     scales: torch.Tensor, bias: Optional[torch.Tensor],
                     cfg: NMConfig, activation: Optional[str] = None, *,
                     plan: Optional[DecodePlan] = None) -> torch.Tensor:
    """y[M, N] = act((x[M, K] @ decompress(int8 vals, idx)) * scales
    + bias), in x's dtype (f32 or bf16); ``plan`` as for
    :func:`nm_spmm_decode`."""
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if x.device.type == "cpu":
        return nm_spmm_decode_q_plain(x, vals, idx, scales, bias, cfg,
                                      activation)
    return _launch(KERNEL_Q, "nm_spmm_decode_q", x, vals, idx, scales, bias,
                   cfg, activation, plan)
