"""Compressed N:M weight (port of ``repro.core.nmweight``).

:class:`NMWeight` is a plain dataclass of two tensors, ``vals`` and
``idx``, plus the metadata its consumer needs: the :class:`NMConfig`,
the compressed axis and the :class:`KernelPolicy`. The weight, not the
call site, decides how its matmuls dispatch.

:class:`MaskedNMWeight` is the dense-storage sibling of the
prune->fine-tune training flow: the weight stays dense and the top-N:M
mask is re-derived every forward.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import torch

from repro_torch.core.sparsity import (
    NMConfig,
    apply_mask,
    decompress_nm,
    prune_mask_nm,
)

__all__ = ["BACKENDS", "KernelPolicy", "MaskedNMWeight", "NMWeight"]

KernelMode = Literal["off", "auto", "force"]
Backend = Literal["auto", "cuda", "cpu"]
BACKENDS = ("auto", "cuda", "cpu")


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """How a compressed weight's matmuls pick an implementation.

    mode:
      off   - always the plain PyTorch reference (the caller's choice).
      auto  - the hand-written kernel. On the CPU backend a call the
              kernel cannot take (its dtype or N:M pattern) runs the
              reference, and the dispatch record says why; on the CUDA
              backend ``auto`` is ``force``.
      force - the kernel whenever the call is legal at all; raises
              :class:`repro_torch.kernels.registry.KernelForceError`
              when it is not.
    block: optional ``(block_m, block_n, block_k)`` of the prefill
      families (``nm_matmul``, ``nm_matmul_q``) that pins their launch:
      one of ``padding.prefill_candidates``. ``None`` consults the
      autotune cache, then the host rule (``padding.prefill_block``).
    decode_block: the same for the decode families, ``(rows, columns a
      CTA, dense rows of K a split)``: one of ``padding.decode_candidates``
      (``padding.decode_block`` is the rule's). A pinned block that names
      no compiled launch raises ``KernelForceError`` on the CUDA backend
      (and under ``force``); under ``auto`` on the CPU backend the call
      runs the reference, with the reason on the record.
    backend: ``auto`` (``$REPRO_TORCH_BACKEND``, then the tensor's
      device), ``cuda`` (the hand-written kernels) or ``cpu`` (the plain
      PyTorch versions). A backend that does not match the tensor's
      device raises ``KernelForceError``; nothing falls back silently.
    """

    mode: KernelMode = "off"
    block: Optional[tuple[int, int, int]] = None
    decode_block: Optional[tuple[int, int, int]] = None
    backend: Backend = "auto"

    def __post_init__(self):
        if self.mode not in ("off", "auto", "force"):
            raise ValueError(f"kernel policy mode {self.mode!r} not in "
                             "('off', 'auto', 'force')")
        if self.backend not in BACKENDS:
            raise ValueError(f"kernel policy backend {self.backend!r} not "
                             f"in {BACKENDS}")
        if self.block is not None:
            object.__setattr__(self, "block", tuple(self.block))
        if self.decode_block is not None:
            object.__setattr__(self, "decode_block", tuple(self.decode_block))


@dataclasses.dataclass(frozen=True)
class NMWeight:
    """Compressed N:M weight.

    vals: kept values, ``axis`` shrunk by n/m (the model dtype).
    idx:  int8 in-block positions in ``[0, m)``, same shape as ``vals``.
    nm:   the N:M pattern. axis: the compressed axis (0 = K of x @ W).
    kernel_policy: see :class:`KernelPolicy`.
    """

    vals: torch.Tensor
    idx: torch.Tensor
    nm: NMConfig
    axis: int = 0
    kernel_policy: KernelPolicy = KernelPolicy()

    def to(self, device=None, dtype=None) -> "NMWeight":
        """Move both tensors; ``dtype`` casts ``vals`` only (idx is
        pattern, not payload, and stays int8)."""
        return dataclasses.replace(
            self, vals=self.vals.to(device=device, dtype=dtype),
            idx=self.idx.to(device=device))

    def to_dense(self) -> torch.Tensor:
        """Materialize the dense weight (tests / export)."""
        return decompress_nm(self.vals, self.idx, self.nm, axis=self.axis)


@dataclasses.dataclass(frozen=True)
class MaskedNMWeight:
    """Dense-storage N:M weight (port of ``repro.core.nmweight``'s).

    ``w`` is stored dense; :meth:`project` re-derives the top-N:M mask of
    the current values, so a pruned entry can come back between steps.
    The mask is applied with ``torch.where``, as the JAX package applies
    it: a pruned entry gets a zero gradient (the JAX docstrings call the
    gradient straight-through, but its code is not).
    """

    w: torch.Tensor
    nm: NMConfig
    axis: int = 0

    def project(self) -> torch.Tensor:
        """The dense weight projected onto the N:M constraint set."""
        return apply_mask(self.w, prune_mask_nm(self.w, self.nm,
                                                axis=self.axis))

    def to_dense(self) -> torch.Tensor:
        """What the forward multiplies by: :meth:`project`."""
        return self.project()
