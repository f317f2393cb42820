"""Public facade for the compressed N:M representation (port of the typed
part of ``repro.api``).

  sparsify(w, nm)   dense (K, N) tensor -> NMWeight (prune + compress)
  quantize(w)       NMWeight / dense tensor -> int8 QNMWeight (+ scales)
  dequantize(qw)    QNMWeight -> float NMWeight
  quantize_tree / dequantize_tree
                    every compressed weight of a module (in place) or
                    of a tree of dicts, lists and tuples
  densify(w)        any weight node / {"w": ...} -> dense tensor
  nm_matmul(x, w, epilogue=...)
                    y = epilogue(x @ densify(w)), dispatched by w's own
                    policy and *type* (QNMWeight -> the int8 families);
                    skinny-M calls take the fused decode families
  explain_dispatch(x_shape, w)
                    the DispatchRecord nm_matmul would write, running
                    nothing
  is_sparse(obj)    True for the typed compressed weight nodes
  resolve_backend   the backend a call on a device resolves to

Kernel policy (``KernelPolicy.mode``): ``off`` pins the plain reference;
``force`` runs the hand-written kernel or raises
:class:`KernelForceError`; ``auto`` is ``force`` on the CUDA backend and
gives a call without a kernel to the reference only on the CPU backend.
Backends (``KernelPolicy.backend`` / ``backend=``): ``auto`` (then
``$REPRO_TORCH_BACKEND``, then the tensor's device), ``cuda`` or
``cpu``. Attention, convolution and the gather port come with their
slices of the port.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.nmweight import KernelPolicy, NMWeight
from repro_torch.core.sparsity import (
    NMConfig,
    apply_mask,
    compress_nm,
    decompress_nm,
    prune_mask_nm,
)
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.indexmac.ops import (
    explain_dispatch as _explain_dispatch,
)
from repro_torch.kernels.indexmac.ops import nm_matmul as _nm_matmul
from repro_torch.kernels.registry import (  # noqa: F401 (re-export)
    DispatchRecord,
    KernelForceError,
    resolve_backend,
)
from repro_torch.quant import QNMWeight
from repro_torch.quant import dequantize as _dequantize
from repro_torch.quant import dequantize_tree, quantize_tree  # noqa: F401
from repro_torch.quant import quantize_nm as _quantize_nm

__all__ = [
    "DispatchRecord",
    "Epilogue",
    "KernelForceError",
    "KernelPolicy",
    "NMConfig",
    "NMWeight",
    "QNMWeight",
    "densify",
    "dequantize",
    "dequantize_tree",
    "explain_dispatch",
    "is_sparse",
    "nm_matmul",
    "quantize",
    "quantize_tree",
    "resolve_backend",
    "sparsify",
]


def _as_policy(kernel_policy) -> KernelPolicy:
    if isinstance(kernel_policy, KernelPolicy):
        return kernel_policy
    if isinstance(kernel_policy, str):
        return KernelPolicy(mode=kernel_policy)
    raise TypeError(
        f"kernel_policy must be a KernelPolicy or a mode string "
        f"('off' | 'auto' | 'force'), got {type(kernel_policy).__name__}")


def sparsify(w: torch.Tensor, nm: NMConfig, *, axis: int = 0,
             kernel_policy: Union[KernelPolicy, str] = KernelPolicy("auto"),
             ) -> NMWeight:
    """Prune a dense 2D weight to top-|w| N:M along ``axis`` and
    compress it. An N:M-sparse ``w`` passes through losslessly. ``axis=0``
    is the contraction dim of ``y = x @ W``, what ``nm_matmul`` takes."""
    if w.dim() != 2:
        raise ValueError(f"sparsify expects a 2D weight, got shape "
                         f"{tuple(w.shape)}")
    if w.shape[axis] % nm.m != 0:
        raise ValueError(
            f"axis {axis} size {w.shape[axis]} not divisible by M={nm.m}")
    policy = _as_policy(kernel_policy)
    pruned = apply_mask(w, prune_mask_nm(w, nm, axis=axis))
    vals, idx = compress_nm(pruned, nm, axis=axis)
    return NMWeight(vals=vals, idx=idx, nm=nm, axis=axis,
                    kernel_policy=policy)


def quantize(w, nm: Optional[NMConfig] = None, *, method="absmax",
             axis: int = 0, kernel_policy=None) -> QNMWeight:
    """int8-quantize a weight (symmetric, per output channel): an
    :class:`NMWeight`, or a dense 2D tensor (``nm`` required; pruned and
    compressed first). ``method`` is ``"absmax"``, ``"percentile"`` or an
    observer from :mod:`repro_torch.quant.calibrate`."""
    return _quantize_nm(w, nm, method=method, axis=axis,
                        kernel_policy=kernel_policy)


def dequantize(qw: QNMWeight, dtype=None) -> NMWeight:
    """Float :class:`NMWeight` with the same pattern (f32 by default)."""
    return _dequantize(qw, dtype=dtype or torch.float32)


def densify(w) -> torch.Tensor:
    """The dense tensor behind any linear-weight node."""
    if isinstance(w, NMWeight):
        return decompress_nm(w.vals, w.idx, w.nm, axis=w.axis)
    if isinstance(w, QNMWeight):
        return w.to_dense()
    if isinstance(w, dict) and "w" in w:
        return w["w"]
    return w


def is_sparse(obj) -> bool:
    """True for the typed compressed weight nodes."""
    return isinstance(obj, (NMWeight, QNMWeight))


def nm_matmul(x: torch.Tensor, w, *, epilogue: Optional[Epilogue] = None,
              backend: Optional[str] = None) -> torch.Tensor:
    """y = epilogue(x @ densify(w)) for an :class:`NMWeight` or int8
    :class:`QNMWeight`; the family (float or int8, prefill or decode),
    the kernel and the backend follow the weight's policy, its type and
    the flattened row count (see the module docstring)."""
    return _nm_matmul(x, w, epilogue=epilogue, backend=backend)


def explain_dispatch(x_shape, w, *, epilogue: Optional[Epilogue] = None,
                     dtype=None, backend: Optional[str] = None,
                     device=None) -> DispatchRecord:
    """The :class:`DispatchRecord` ``nm_matmul(x, w)`` would write for an
    ``x`` of shape ``x_shape``, running nothing; the same typed errors as
    the call."""
    return _explain_dispatch(x_shape, w, epilogue=epilogue, dtype=dtype,
                             backend=backend, device=device)
