"""Plain PyTorch versions of the gather port (port of
``repro.kernels.indexmac_gather.ref``): the paper's orientation
C = A_sp @ B, with A compressed along its rows (axis 1), and the plain
twin of the Hopper kernels' split-K summation order
(:func:`indexmac_gather_split_ref`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dots import acc_dot
from repro_torch.core.sparsity import NMConfig, decompress_nm
from repro_torch.kernels.padding import NUM_SMS, gather_plan


def indexmac_gather_ref(vals: torch.Tensor, idx: torch.Tensor,
                        b: torch.Tensor, cfg: NMConfig) -> torch.Tensor:
    """Decompress A along axis 1, f32 product, cast to B's dtype."""
    a = decompress_nm(vals, idx, cfg, axis=1)  # (Mr, K)
    return acc_dot(a, b).to(b.dtype)


def indexmac_gather_q_ref(vals: torch.Tensor, idx: torch.Tensor,
                          scales: torch.Tensor, b: torch.Tensor,
                          cfg: NMConfig) -> torch.Tensor:
    """int8: f32 product on the exact int8 lattice, then one multiply by
    the output row's scale (C[i, :] *= scales[i]), cast to B's dtype."""
    a8 = decompress_nm(vals, idx, cfg, axis=1)  # (Mr, K) int8
    y = acc_dot(a8, b) * scales.float()[:, None]
    return y.to(b.dtype)


def indexmac_gather_split_ref(vals: torch.Tensor, idx: torch.Tensor,
                              b: torch.Tensor, cfg: NMConfig,
                              scales: Optional[torch.Tensor] = None, *,
                              sms: int = NUM_SMS) -> torch.Tensor:
    """Plain twin of the Hopper gather kernels' summation order: an f32
    partial per split over the dense rows ``gather_plan`` gives it (on a
    card of ``sms`` SMs), the partials added in split order, then (int8
    vals) one multiply by the row's scale, cast to B's dtype."""
    a = decompress_nm(vals, idx, cfg, axis=1)  # (Mr, K)
    mr, k = a.shape
    plan = gather_plan(mr, k, b.shape[1], cfg, b.dtype, vals.dtype, sms)
    total = None
    for k0, k1 in plan.k_ranges(k):
        part = acc_dot(a[:, k0:k1], b[k0:k1])
        total = part if total is None else total + part
    if total is None:  # K == 0
        total = torch.zeros(mr, b.shape[1], device=b.device)
    if scales is not None:
        total = total * scales.float()[:, None]
    return total.to(b.dtype)
