"""Quantized compressed N:M weight (port of ``repro.quant.qnmweight``):
int8 kept values, int8 in-block indices and one f32 scale per output
channel.

A decode step streams one byte per kept value instead of two (bf16);
the scale is constant over the contraction, so the kernels multiply the
f32 accumulator by it once, at writeback. Quantization is symmetric (no
zero point): a zero stays exactly zero, which the N:M padding needs.

Scale layout: one scale per index of the *non-compressed* axis,
``vals.shape[1 - axis]``: ``axis=0`` (``y = x @ W``, W compressed along
K) gives ``vals`` (Kc, N) and ``scales`` (N,), one per output column.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.nmweight import KernelPolicy, NMWeight
from repro_torch.core.sparsity import NMConfig, decompress_nm

__all__ = ["QMAX", "QNMWeight"]

QMAX = 127  # symmetric int8 range [-127, 127]; -128 is never produced


@dataclasses.dataclass(frozen=True)
class QNMWeight:
    """Quantized compressed N:M weight.

    vals:   int8 quantized kept values (``axis`` shrunk by n/m).
    idx:    int8 in-block positions in ``[0, m)``, same shape as vals.
    scales: f32 per-output-channel scales, ``(vals.shape[1 - axis],)``.
    nm, axis, kernel_policy: as :class:`NMWeight`.

    No validation here; :func:`repro_torch.quant.calibrate.quantize_nm`
    is the validating producer.
    """

    vals: torch.Tensor
    idx: torch.Tensor
    scales: torch.Tensor
    nm: NMConfig
    axis: int = 0
    kernel_policy: KernelPolicy = KernelPolicy()

    def _scale_bcast(self) -> torch.Tensor:
        """Scales broadcast against the compressed (vals) layout."""
        if self.axis == 0:
            return self.scales[None, :]
        return self.scales[:, None]

    def dequantize(self, dtype=torch.float32) -> NMWeight:
        """Float :class:`NMWeight` with the same pattern."""
        vals = self.vals.float() * self._scale_bcast()
        return NMWeight(vals=vals.to(dtype), idx=self.idx, nm=self.nm,
                        axis=self.axis, kernel_policy=self.kernel_policy)

    def to_dense(self, dtype=torch.float32) -> torch.Tensor:
        """Materialize the dense float weight (tests / export)."""
        d8 = decompress_nm(self.vals, self.idx, self.nm, axis=self.axis)
        return (d8.float() * self._scale_bcast()).to(dtype)

    def to(self, device=None) -> "QNMWeight":
        """Move the three tensors; the payload stays int8, scales f32."""
        return dataclasses.replace(
            self, vals=self.vals.to(device), idx=self.idx.to(device),
            scales=self.scales.to(device))
