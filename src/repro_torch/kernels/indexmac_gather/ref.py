"""Plain PyTorch versions of the gather port (port of
``repro.kernels.indexmac_gather.ref``): the paper's orientation
C = A_sp @ B, with A compressed along its rows (axis 1).
"""
from __future__ import annotations

import torch

from repro_torch.core.dots import acc_dot
from repro_torch.core.sparsity import NMConfig, decompress_nm


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
