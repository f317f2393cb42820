"""Wrapper of the Hopper kernel ``bs_attention``
(``csrc/bs_attention.cu``): block-sparse prefill attention over the live
(q-block, k-block) pairs of a :class:`MaskPlan`. It replaces the TPU
kernel ``_bs_attn_call`` of ``repro.kernels.blocksparse_attn.kernel``.

``bs_attention(q, k, v, plan, scale)`` takes q (B, Sq, Hq, Dk) and k/v
(B, Skv, Hkv, D*) in the layout of the model, read in place through
their strides (the last dimension contiguous), and returns (B, Sq, Hq,
Dv) in q's dtype. On a CUDA tensor it launches the kernel (or raises);
on a CPU tensor it runs its plain PyTorch version, the block-gather
lowering ``ref.blocksparse_torch`` over the same plan.
``KERNEL.launches`` counts the launches. bf16 calls run the
tensor-core kernel, which stages each K/V chunk once for
:func:`heads_per_cta` q heads of one KV head; f32 calls run the exact-f32
kernel on the CUDA cores.

The plan's operands (CSR row pointers, the live k-blocks, the (n_live,
bq, bk) mask tiles as bytes) are uploaded once per (plan, device) and
kept (:func:`device_plan`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.blocksparse_attn.mask import (
    MaskPlan,
    pair_masks,
    row_pointers,
)
from repro_torch.kernels.blocksparse_attn.ref import blocksparse_torch
from repro_torch.kernels import capture
from repro_torch.kernels.build import CudaKernel, load
from repro_torch.kernels.indexmac.kernel import KERNEL_DTYPES

__all__ = ["KERNEL", "MAX_DK", "MAX_DV", "bs_attention", "check_operands",
           "device_plan", "has_build", "heads_per_cta", "occupancy"]

# head dims the kernels are built for (csrc BS_MAXDK, BS_MAXDV): the bf16
# kernel is instantiated at (dk, dv) <= (128, 128) and (192, 128), MLA's
MAX_DK, MAX_DV = 192, 128
ROWS = 64  # query rows of one head per CTA (csrc BS_TQ, BM_ROWS)
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("bs_attention", (
    _I, _P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong),
    _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P))


def has_build(dtype: torch.dtype, dk: int, dv: int) -> bool:
    """Whether a kernel is built for a call in ``dtype`` with these head
    dims (f32 or bf16, 1 <= dk <= MAX_DK, 1 <= dv <= MAX_DV)."""
    return dtype in KERNEL_DTYPES and 1 <= dk <= MAX_DK and 1 <= dv <= MAX_DV


def heads_per_cta(hq: int, hkv: int, batch: int, plan: MaskPlan,
                  sms: int) -> int:
    """G', the q heads of one KV head that a CTA of the bf16 kernel
    serves (csrc BM_GROUP_MAX = 2): each K/V chunk it stages serves G'
    64-row parts, so L2 reads of K, V and the masks fall by G'. 2 where
    Hq / Hkv is even and the grid at G' = 2 still gives each of the
    card's ``sms`` SMs a CTA; else 1, whose grid is twice as large."""
    ctas = batch * plan.nqb * -(-plan.bq // ROWS) * (hq // 2)
    return 2 if (hq // hkv) % 2 == 0 and ctas >= sms else 1


def occupancy(dtype: torch.dtype, group: int, dk: int, dv: int) -> dict:
    """CTAs per SM, threads and dynamic shared memory per CTA of the
    kernel a call in ``dtype`` with these head dims launches on the
    current device (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``):
    in bf16 the ``<128, 128>`` instantiation up to dk 128, else
    ``<192, 128>``."""
    fn = getattr(load(KERNEL.name), "bs_attention_occupancy")
    fn.argtypes = [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = _I
    out = (ctypes.c_int * 3)()
    rc = fn(KERNEL_DTYPES[dtype], group, dk, dv, out)
    if rc != 0:
        raise RuntimeError(f"bs_attention_occupancy failed with CUDA error "
                           f"{rc}")
    return {"ctas_per_sm": out[0], "threads": out[1], "smem_bytes": out[2]}


@functools.lru_cache(maxsize=64)
def device_plan(plan: MaskPlan, device: torch.device) -> tuple:
    """(row_ptr int32, pair_k int32, masks uint8) of ``plan`` on
    ``device``, uploaded once (plans are cached by ``compile_mask``)."""
    return (torch.as_tensor(row_pointers(plan), device=device),
            torch.as_tensor(plan.pair_k, device=device),
            torch.as_tensor(pair_masks(plan).astype(np.uint8),
                            device=device))


def check_operands(q, k, v, plan: MaskPlan) -> None:
    """Device, dtype and shape checks of the kernel."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"bs_attention expects (B, S, H, D) operands, got "
                         f"q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v on different devices")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"the kernel takes q, k and v in one dtype, f32 or "
                         f"bf16; got {q.dtype}, {k.dtype}, {v.dtype}")
    b, sq, hq, dk = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    if k.shape[0] != b or v.shape[:3] != k.shape[:3] or k.shape[3] != dk:
        raise ValueError(f"inconsistent shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if not has_build(q.dtype, dk, dv):
        raise ValueError(f"the kernel takes dk up to {MAX_DK} and dv up to "
                         f"{MAX_DV}, got dk={dk} dv={dv}")
    if (sq, skv) != (plan.sq, plan.skv):
        raise ValueError(f"plan for Sq={plan.sq} Skv={plan.skv}, operands "
                         f"Sq={sq} Skv={skv}")


def bs_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 plan: MaskPlan, scale: Optional[float] = None
                 ) -> torch.Tensor:
    """out[b, i, h] = softmax over the plan's live keys of row i (f32
    scores of q against k, times the scale), times v; (B, Sq, Hq, Dv) in
    q's dtype."""
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    if q.device.type == "cpu":
        return blocksparse_torch(q, k, v, plan=plan, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"bs_attention runs on cuda or cpu tensors, not "
                         f"{q.device}")
    check_operands(q, k, v, plan)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    b, sq, hq, _ = q.shape
    out = torch.empty((b, sq, hq, v.shape[-1]), dtype=q.dtype,
                      device=q.device)
    if out.numel() == 0:
        return out
    group = 1 if q.dtype == torch.float32 else heads_per_cta(
        hq, k.shape[2], b, plan,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    row_ptr, pair_k, masks = device_plan(plan, q.device)
    capture.hold(row_ptr, pair_k, masks)  # a graph outlives the LRU entry
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL(KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), row_ptr.data_ptr(),
               pair_k.data_ptr(), masks.data_ptr(), strides, b, sq,
               plan.skv, hq, k.shape[2], q.shape[-1], v.shape[-1], plan.bq,
               plan.bk, plan.nqb, scale, group, stream)
    return out
