"""N:M structured sparsity primitives (PyTorch port of ``repro.core.sparsity``).

Within every block of M consecutive elements along the compressed axis
at most N are non-zero. The compressed form stores, per block, exactly N
``values`` and N int8 ``idx`` entries in ``[0, M)`` relative to the
block. For ``y = x @ W`` the weight is compressed along axis 0 (the
contraction dim K).

Padding rule of :func:`compress_nm`: a block with fewer than N non-zeros
is filled up with value 0 at the index of a *zero position* of that
block, the first ones in ascending order (the stable sort puts the
non-zeros first, then the zeros). ``[0, 0, 3, 0]`` at 2:4 gives idx
``[2, 0]``; an all-zero block gives ``[0, 1]``.

:func:`decompress_nm` is a one-hot sum: entries that repeat an index in
one block *add up*, which is what the zero-padded pairs of
:func:`pad_compressed_kn` rely on.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "NMConfig",
    "prune_mask_nm",
    "apply_mask",
    "compress_nm",
    "decompress_nm",
    "check_nm_pattern",
    "pad_compressed_kn",
]


@dataclasses.dataclass(frozen=True)
class NMConfig:
    """N:M structured sparsity configuration.

    n: max non-zeros per block.
    m: block size (consecutive elements along the compressed axis).
    """

    n: int = 2
    m: int = 4

    def __post_init__(self):
        if not (1 <= self.n < self.m):
            raise ValueError(f"need 1 <= n < m, got {self.n}:{self.m}")

    @property
    def tag(self) -> str:
        return f"{self.n}:{self.m}"


def _blocks_last(w: torch.Tensor, m: int, axis: int) -> torch.Tensor:
    if w.shape[axis] % m != 0:
        raise ValueError(
            f"axis {axis} size {w.shape[axis]} not divisible by M={m}")
    wl = torch.movedim(w, axis, -1)
    return wl.reshape(*wl.shape[:-1], wl.shape[-1] // m, m)


def prune_mask_nm(w: torch.Tensor, cfg: NMConfig, axis: int = 0) -> torch.Tensor:
    """Magnitude N:M mask: keep the top-``n`` |w| of every ``m``-block.

    Boolean, w's shape. Ties go to the lower position (stable argsort on
    -|w|, then the rank of each position).
    """
    blocks = _blocks_last(w, cfg.m, axis)
    order = torch.argsort(-blocks.abs(), dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    mask = (ranks < cfg.n).reshape(*blocks.shape[:-2], -1)
    return torch.movedim(mask, -1, axis)


def apply_mask(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, w, torch.zeros_like(w))


def compress_nm(w: torch.Tensor, cfg: NMConfig, axis: int = 0):
    """Compress an (already N:M-sparse) tensor to ``(values, idx)``.

    values: w's dtype, ``axis`` shrunk by n/m. idx: int8 in ``[0, m)``.
    Kept entries are in ascending position; short blocks are padded as
    the module docstring says.
    """
    blocks = _blocks_last(w, cfg.m, axis)
    pos = torch.arange(cfg.m, device=w.device)
    key = torch.where(blocks != 0, pos, pos + cfg.m)
    take = torch.argsort(key, dim=-1, stable=True)[..., : cfg.n]
    values = torch.gather(blocks, -1, take).reshape(*blocks.shape[:-2], -1)
    idx = take.to(torch.int8).reshape(*blocks.shape[:-2], -1)
    return (torch.movedim(values, -1, axis).contiguous(),
            torch.movedim(idx, -1, axis).contiguous())


def decompress_nm(values: torch.Tensor, idx: torch.Tensor, cfg: NMConfig,
                  axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`compress_nm`: a one-hot sum in the values' dtype
    (repeated indices add up; an index outside ``[0, m)`` adds nothing)."""
    vl = torch.movedim(values, axis, -1)
    il = torch.movedim(idx, axis, -1)
    lead = vl.shape[:-1]
    nblocks = vl.shape[-1] // cfg.n
    v = vl.reshape(*lead, nblocks, cfg.n, 1)
    i = il.reshape(*lead, nblocks, cfg.n, 1).to(torch.int64)
    onehot = i == torch.arange(cfg.m, device=values.device)
    dense = torch.where(onehot, v, torch.zeros((), dtype=v.dtype,
                                               device=v.device)).sum(-2)
    dense = dense.to(values.dtype).reshape(*lead, nblocks * cfg.m)
    return torch.movedim(dense, -1, axis)


def pad_compressed_kn(values: torch.Tensor, idx: torch.Tensor, *,
                      kc_pad: int, n_pad: int):
    """Zero-pad a compressed (Kc, N) pair to (kc_pad, n_pad). Appended
    blocks hold value 0 at index 0, repeated n times per block."""
    kc, nn = values.shape
    if kc_pad < kc or n_pad < nn:
        raise ValueError(
            f"pad target ({kc_pad}, {n_pad}) smaller than ({kc}, {nn})")
    if (kc_pad, n_pad) == (kc, nn):
        return values, idx
    pad = (0, n_pad - nn, 0, kc_pad - kc)
    return F.pad(values, pad), F.pad(idx, pad)


def check_nm_pattern(w, cfg: NMConfig, axis: int = 0) -> bool:
    """True iff every M-block along ``axis`` has at most N non-zeros."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().float().numpy()
    w = np.asarray(w)
    wl = np.moveaxis(w, axis, -1)
    blocks = wl.reshape(*wl.shape[:-1], wl.shape[-1] // cfg.m, cfg.m)
    return bool(((blocks != 0).sum(-1) <= cfg.n).all())
