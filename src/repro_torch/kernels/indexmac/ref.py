"""Plain PyTorch versions of the N:M matmul (port of
``repro.kernels.indexmac.ref`` and of the decode reference compositions
in ``repro.kernels.indexmac.ops``).

y = x @ W with W stored compressed along K: vals (K*n/m, N), idx int8.
The int8 versions take int8 vals and f32 per-column scales (N,).

Plain statements of what the kernels do on the card, for the tests:
:func:`canonical_groups` (the prefill sparse path's form of every group
of four before ``mma.sp``), :func:`matmul_3xtf32` (the prefill dense
path's f32 product on TF32 tensor cores) and :func:`nm_decode_split_ref`
(the decode kernels' split-K summation order).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dots import acc_dot
from repro_torch.core.sparsity import NMConfig, decompress_nm
from repro_torch.kernels.epilogue import apply_epilogue_f32
from repro_torch.kernels.padding import (
    DECODE_ROWS,
    NUM_SMS,
    DecodePlan,
    decode_plan,
)


def nm_matmul_ref(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                  cfg: NMConfig) -> torch.Tensor:
    """Decompress W in the stored dtype, f32 product, cast to x's dtype."""
    w = decompress_nm(vals, idx, cfg, axis=0)
    return acc_dot(x, w).to(x.dtype)


def nm_matmul_decode_ref(x: torch.Tensor, vals: torch.Tensor,
                         idx: torch.Tensor, bias: Optional[torch.Tensor],
                         cfg: NMConfig,
                         activation: Optional[str]) -> torch.Tensor:
    """The decode composition: f32 product, + bias, activation, cast."""
    w = decompress_nm(vals, idx, cfg, axis=0)
    y32 = acc_dot(x, w)
    return apply_epilogue_f32(y32, bias, activation).to(x.dtype)


def nm_matmul_q_ref(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                    scales: torch.Tensor, cfg: NMConfig) -> torch.Tensor:
    """int8: decompress the int8 values, cast to f32 (exact, |q| <= 127),
    f32 product, one multiply by the column scale, cast to x's dtype."""
    w8 = decompress_nm(vals, idx, cfg, axis=0)
    y32 = acc_dot(x, w8) * scales.float()[None, :]
    return y32.to(x.dtype)


def nm_matmul_decode_q_ref(x: torch.Tensor, vals: torch.Tensor,
                           idx: torch.Tensor, scales: torch.Tensor,
                           bias: Optional[torch.Tensor], cfg: NMConfig,
                           activation: Optional[str]) -> torch.Tensor:
    """The int8 decode composition: f32 product, x scales, + bias,
    activation, cast to x's dtype."""
    w8 = decompress_nm(vals, idx, cfg, axis=0)
    y32 = acc_dot(x, w8) * scales.float()[None, :]
    return apply_epilogue_f32(y32, bias, activation).to(x.dtype)


def nm_decode_split_ref(x: torch.Tensor, vals: torch.Tensor,
                        idx: torch.Tensor, scales: Optional[torch.Tensor],
                        bias: Optional[torch.Tensor], cfg: NMConfig,
                        activation: Optional[str],
                        plan: Optional[DecodePlan] = None, *,
                        sms: int = NUM_SMS) -> torch.Tensor:
    """Plain twin of the Hopper decode kernels' summation order: per
    group of at most 8 rows, an f32 partial per split over the dense rows
    ``plan`` gives it (by default ``decode_plan``'s on a card of ``sms``
    SMs), the partials added in split order; then (int8 vals) one
    multiply by the column scale, + bias, the activation, and the cast to
    x's dtype, as :func:`nm_matmul_decode_q_ref` composes them."""
    w = decompress_nm(vals, idx, cfg, axis=0)  # (K, N)
    k, nn = w.shape
    out = []
    for r0 in range(0, x.shape[0], DECODE_ROWS[-1]):
        xg = x[r0:r0 + DECODE_ROWS[-1]]
        p = plan or decode_plan(xg.shape[0], k, nn, cfg, vals.element_size(),
                                sms)
        total = None
        for k0, k1 in p.k_ranges(k):
            part = acc_dot(xg[:, k0:k1], w[k0:k1])
            total = part if total is None else total + part
        if scales is not None:
            total = total * scales.float()[None, :]
        out.append(apply_epilogue_f32(total, bias, activation).to(x.dtype))
    if not out:
        return torch.empty((0, nn), dtype=x.dtype, device=x.device)
    return torch.cat(out)


def canonical_groups(vals: torch.Tensor, idx: torch.Tensor,
                     cfg: NMConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The 2:4 pairs the sparse path feeds ``mma.sp``: per group of four,
    two distinct ascending indices. An index outside [0, 4) adds nothing;
    values that share an index are added (in f32, rounded once); a free
    slot holds a zero at an unused index (index 1 when the kept one is 0,
    else 0). Takes 2:4 or 1:4 pairs; values stay in their float dtype,
    int8 values become bf16 (exact). ``decompress_nm`` of the result with
    2:4 equals that of the input."""
    if cfg.m != 4 or cfg.n > 2:
        raise ValueError(f"the sparse path takes 2:4 and 1:4, not {cfg.tag}")
    out = torch.bfloat16 if vals.dtype == torch.int8 else vals.dtype
    nn = vals.shape[1]
    v = vals.reshape(-1, cfg.n, nn).float()
    i = idx.reshape(-1, cfg.n, nn).long()
    if cfg.n == 1:
        v = torch.cat([v, torch.zeros_like(v)], 1)
        i = torch.cat([i, torch.full_like(i, -1)], 1)
    ok0, ok1 = (i[:, 0] >= 0) & (i[:, 0] < 4), (i[:, 1] >= 0) & (i[:, 1] < 4)
    v0 = torch.where(ok0, v[:, 0], 0.0)
    v1 = torch.where(ok1, v[:, 1], 0.0)
    j0 = torch.where(ok0, i[:, 0], torch.where(ok1, i[:, 1], 0))
    j1 = torch.where(ok1, i[:, 1], j0)
    total = (v0 + v1).to(out).float()
    same, first, swap = j0 == j1, j0 == 0, j0 > j1
    zero = torch.zeros_like(total)
    lo = torch.where(same, torch.where(first, total, zero),
                     torch.where(swap, v1, v0))
    hi = torch.where(same, torch.where(first, zero, total),
                     torch.where(swap, v0, v1))
    ilo = torch.where(same, 0, torch.where(swap, j1, j0))
    ihi = torch.where(same, torch.where(first, 1, j0),
                      torch.where(swap, j0, j1))
    return (torch.stack([lo, hi], 1).reshape(-1, nn).to(out),
            torch.stack([ilo, ihi], 1).reshape(-1, nn).to(torch.int8))


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (``cvt.rna.tf32.f32``)."""
    bits = a.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(x: torch.Tensor, w: torch.Tensor,
                  passes: int = 3) -> torch.Tensor:
    """The dense path's f32 product on TF32 tensor cores: a = a_hi + a_lo
    with a_hi = rna(a), a_lo = rna(a - a_hi); the sum of a_hi b_lo, a_lo
    b_hi and a_hi b_hi (``passes=1``: a_hi b_hi alone, one TF32 pass).
    Products of TF32 numbers are exact in f64, which sums them here."""
    xh, wh = tf32_round(x), tf32_round(w)
    y = xh.double() @ wh.double()
    if passes == 3:
        xl, wl = tf32_round(x.float() - xh), tf32_round(w.float() - wh)
        y = y + xh.double() @ wl.double() + xl.double() @ wh.double()
    return y
