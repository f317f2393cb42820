"""Plain PyTorch versions of the N:M matmul (port of
``repro.kernels.indexmac.ref`` and of the decode reference composition
in ``repro.kernels.indexmac.ops``).

y = x @ W with W stored compressed along K: vals (K*n/m, N), idx int8.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dots import acc_dot
from repro_torch.core.sparsity import NMConfig, decompress_nm
from repro_torch.kernels.epilogue import apply_epilogue_f32


def nm_matmul_ref(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                  cfg: NMConfig, out_dtype=None) -> torch.Tensor:
    """Decompress W in the stored dtype, f32 product, cast to x's dtype."""
    w = decompress_nm(vals, idx, cfg, axis=0)
    return acc_dot(x, w).to(out_dtype or x.dtype)


def nm_matmul_decode_ref(x: torch.Tensor, vals: torch.Tensor,
                         idx: torch.Tensor, bias: Optional[torch.Tensor],
                         cfg: NMConfig,
                         activation: Optional[str]) -> torch.Tensor:
    """The decode composition: f32 product, + bias, activation, cast."""
    w = decompress_nm(vals, idx, cfg, axis=0)
    y32 = acc_dot(x, w)
    return apply_epilogue_f32(y32, bias, activation).to(x.dtype)
