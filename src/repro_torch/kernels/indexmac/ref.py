"""Plain PyTorch versions of the N:M matmul (port of
``repro.kernels.indexmac.ref`` and of the decode reference compositions
in ``repro.kernels.indexmac.ops``).

y = x @ W with W stored compressed along K: vals (K*n/m, N), idx int8.
The int8 versions take int8 vals and f32 per-column scales (N,).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dots import acc_dot
from repro_torch.core.sparsity import NMConfig, decompress_nm
from repro_torch.kernels.epilogue import apply_epilogue_f32


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
