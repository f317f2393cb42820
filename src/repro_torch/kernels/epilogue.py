"""Fused-epilogue spec for the compressed GEMM (port of
``repro.kernels.epilogue``).

The composition every implementation follows::

    y32 = f32(x) @ f32(densify(w))          # f32 accumulation
    y32 = y32 + f32(bias)                   # when bias is not None
    y32 = ACTIVATIONS[activation](y32)      # when activation is not None
    y   = y32.to(out_dtype)

``activation`` is a name; the decode kernel compiles one variant per
name (``ACTIVATION_CODES`` is the switch it takes). ``gelu`` is the tanh
form, as ``jax.nn.gelu`` defaults to.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["ACTIVATIONS", "ACTIVATION_CODES", "Epilogue",
           "apply_epilogue_f32", "resolve_epilogue"]

ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": lambda y: F.gelu(y, approximate="tanh"),
    "silu": F.silu,
    "relu_sq": lambda y: torch.square(torch.relu(y)),
}

# the decode kernel's compile-time switch (kernels/csrc/common.cuh, Act)
ACTIVATION_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "relu_sq": 4}


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """What a projection fuses into the GEMM writeback.

    bias: optional ``(N,)`` tensor added to the f32 accumulator.
    activation: optional name from :data:`ACTIVATIONS`, applied after
      the bias add, in f32, before the cast to the output dtype.
    """

    bias: Optional[torch.Tensor] = None
    activation: Optional[str] = None

    def __post_init__(self):
        if self.activation is not None and self.activation not in ACTIVATIONS:
            raise ValueError(
                f"unknown epilogue activation {self.activation!r}; known: "
                f"{sorted(ACTIVATIONS)}")


def resolve_epilogue(epilogue: Optional[Epilogue]):
    """``(bias, activation)``; ``None`` is the identity epilogue."""
    if epilogue is None:
        return None, None
    if not isinstance(epilogue, Epilogue):
        raise TypeError(
            f"epilogue must be an Epilogue or None, got "
            f"{type(epilogue).__name__}")
    return epilogue.bias, epilogue.activation


def apply_epilogue_f32(y32: torch.Tensor, bias: Optional[torch.Tensor],
                       activation: Optional[str]) -> torch.Tensor:
    """The shared f32 composition of the reference and the prefill path."""
    if bias is not None:
        y32 = y32 + bias.float()
    if activation is not None:
        y32 = ACTIVATIONS[activation](y32)
    return y32
