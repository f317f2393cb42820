"""Shared model building blocks (port of ``repro.models.common``):
linear (dense or N:M-compressed), RMSNorm, rotary embeddings, token
embedding, and the device rule of the port's entry points.

Weights are stored in the model dtype once, when they are made or
loaded (the JAX package keeps f32 params and casts them on every call).
The dense ``lm_head`` is the exception: it is computed in f32, so it is
stored in f32. A compressed linear holds an :class:`NMWeight` or an
int8 :class:`QNMWeight` whose policy decides between the hand-written
kernels and the reference.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from repro_torch.configs.base import SparsityConfig
from repro_torch.core.nmweight import KernelPolicy, NMWeight
from repro_torch.core.sparsity import apply_mask, compress_nm, prune_mask_nm
from repro_torch.kernels.epilogue import (
    Epilogue,
    apply_epilogue_f32,
    resolve_epilogue,
)
from repro_torch.kernels.indexmac.ops import nm_matmul
from repro_torch.quant.calibrate import quantize_nm
from repro_torch.quant.qnmweight import QNMWeight

QUANTIZE = (None, "int8")  # the load-time weight quantization options


def check_quantize(quantize) -> None:
    if quantize not in QUANTIZE:
        raise ValueError(f"quantize must be None or 'int8', got "
                         f"{quantize!r}")


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` is the default of
    every entry point; without a card it raises instead of dropping to
    the CPU. Tests pass ``"cpu"`` explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "asks for device='cpu'")
    return dev


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------


def sparse_applies(sp: Optional[SparsityConfig], target: str,
                   in_dim: int) -> bool:
    return (sp is not None and target in sp.targets
            and in_dim % sp.nm_for(target).m == 0)


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
                sp: Optional[SparsityConfig] = None, target: str = "dense",
                dtype=torch.float32, scale: Optional[float] = None,
                quantize: Optional[str] = None):
    """A random ``(in_dim, out_dim)`` weight on ``gen``'s device: an
    :class:`NMWeight` (pruned to the target's N:M and compressed, values
    in ``dtype``) when ``sp`` covers ``target``, else a dense tensor.
    ``quantize="int8"`` makes the compressed weight a
    :class:`QNMWeight`, quantized from its f32 values (never from a
    ``dtype`` copy); dense weights are not quantized."""
    check_quantize(quantize)
    scale = scale if scale is not None else in_dim ** -0.5
    w = torch.randn(in_dim, out_dim, generator=gen, device=gen.device) * scale
    if not sparse_applies(sp, target, in_dim):
        return w.to(dtype)
    nm = sp.nm_for(target)
    vals, idx = compress_nm(apply_mask(w, prune_mask_nm(w, nm)), nm)
    nw = NMWeight(vals=vals, idx=idx, nm=nm, axis=0,
                  kernel_policy=KernelPolicy(
                      "auto" if sp.use_kernel else "off"))
    if quantize == "int8":
        return quantize_nm(nw)
    return nw.to(dtype=dtype)


def linear_apply(weight, x: torch.Tensor, *, compute_dtype=None,
                 epilogue: Optional[Epilogue] = None) -> torch.Tensor:
    """y = epilogue(x @ W). An :class:`NMWeight` goes through
    ``nm_matmul`` (its own nm and policy; the decode family fuses the
    epilogue), a :class:`QNMWeight` through the int8 families, a dense
    tensor through a plain product with the same f32 epilogue
    composition. ``compute_dtype`` defaults to the weight's value dtype;
    for an int8 weight x keeps its own (the model dtype) and the int8
    payload is never cast."""
    if isinstance(weight, QNMWeight):
        xc = x.to(compute_dtype) if compute_dtype is not None else x
        return nm_matmul(xc, weight, epilogue=epilogue)
    if isinstance(weight, NMWeight):
        xc = x.to(compute_dtype or weight.vals.dtype)
        return nm_matmul(xc, weight, epilogue=epilogue)
    if not isinstance(weight, torch.Tensor):
        raise TypeError(f"linear_apply expects an NMWeight, a QNMWeight "
                        f"or a dense tensor, got {type(weight).__name__}")
    dt = compute_dtype or weight.dtype
    y = torch.matmul(x.to(dt), weight.to(dt))
    bias, activation = resolve_epilogue(epilogue)
    if bias is None and activation is None:
        return y
    return apply_epilogue_f32(y.float(), bias, activation).to(y.dtype)


class Linear(nn.Module):
    """A linear layer holding a dense weight, an :class:`NMWeight` or an
    int8 :class:`QNMWeight` as buffers (inference: nothing here takes
    gradients)."""

    def __init__(self, weight):
        super().__init__()
        self.hold(weight)

    def hold(self, weight) -> None:
        """Hold ``weight`` in place of the current one (its buffers are
        dropped: quantizing a model in place frees the float values)."""
        for name in ("w", "vals", "idx", "scales"):
            self._buffers.pop(name, None)
        self.quantized = isinstance(weight, QNMWeight)
        if isinstance(weight, (NMWeight, QNMWeight)):
            self.register_buffer("vals", weight.vals)
            self.register_buffer("idx", weight.idx)
            if self.quantized:
                self.register_buffer("scales", weight.scales)
            self.nm, self.axis = weight.nm, weight.axis
            self.kernel_policy = weight.kernel_policy
        else:
            self.register_buffer("w", weight)
            self.nm = None

    @property
    def weight(self):
        if self.nm is None:
            return self.w
        if self.quantized:
            return QNMWeight(self.vals, self.idx, self.scales, self.nm,
                             self.axis, self.kernel_policy)
        return NMWeight(self.vals, self.idx, self.nm, self.axis,
                        self.kernel_policy)

    def forward(self, x, *, compute_dtype=None, epilogue=None):
        return linear_apply(self.weight, x, compute_dtype=compute_dtype,
                            epilogue=epilogue)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    """f32 statistics, cast back to x's dtype, then the scale."""
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * scale.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor, eps: float = 1e-5):
        super().__init__()
        self.register_buffer("scale", scale)
        self.eps = eps

    def forward(self, x):
        return rmsnorm(self.scale, x, self.eps)


# ---------------------------------------------------------------------------
# rotary position embedding (llama-style half rotation)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) for :func:`apply_rope_tables`, f32, shaped
    (..., seq, 1, head_dim): cos repeated over both halves, sin negated
    on the first. ``LM.forward`` makes them once for all layers."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., :, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    return (torch.cat([cos, cos], -1)[..., :, None, :],
            torch.cat([-sin, sin], -1)[..., :, None, :])


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """The half rotation [x1 cos - x2 sin, x2 cos + x1 sin] in f32 (the
    same products and sums as the JAX package: a + (-b) is a - b)."""
    xf = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). f32 math."""
    return apply_rope_tables(x, *rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------


class Embedding(nn.Module):
    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.register_buffer("table", table)

    @classmethod
    def init(cls, gen: torch.Generator, vocab: int, d: int, dtype):
        e = torch.randn(vocab, d, generator=gen, device=gen.device)
        return cls((e * d ** -0.5).to(dtype))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table[tokens]

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied output head: f32 logits = x @ E^T."""
        return torch.matmul(x.float(), self.table.float().t())
