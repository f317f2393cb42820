"""Dot precision policy (port of ``repro.core.dots``).

Every dot the models take outside the N:M kernels accumulates in f32.
PyTorch has no ``preferred_element_type``, so the operands are cast to
f32 first: the same arithmetic the JAX package runs on the CPU. TF32 is
switched off for matmuls and cuDNN alike, so an f32 product on the card
is a full f32 product.
"""
from __future__ import annotations

import torch


def strict_f32() -> None:
    """Turn TF32 off for matmuls and cuDNN (both default to allowing it
    somewhere); call before any product whose accuracy a test states."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def acc_einsum(subs: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with f32 operands and f32 result."""
    return torch.einsum(subs, a.float(), b.float())


def acc_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())
