"""Public facade for the compressed N:M representation (port of the typed
part of ``repro.api``).

  sparsify(w, nm)   dense (K, N) tensor -> NMWeight (prune + compress)
  quantize(w)       NMWeight / dense tensor -> int8 QNMWeight (+ scales)
  dequantize(qw)    QNMWeight -> float NMWeight
  quantize_tree / dequantize_tree
                    every compressed weight of a module (in place) or
                    of a tree of dicts, lists and tuples
  densify(w)        any weight node / {"w": ...} -> dense tensor (a
                    MaskedNMWeight -> its N:M projection)
  nm_matmul(x, w, epilogue=...)
                    y = epilogue(x @ densify(w)), dispatched by w's own
                    policy and *type* (QNMWeight -> the int8 families);
                    skinny-M calls take the fused decode families
  explain_dispatch(x_shape, w)
                    the DispatchRecord nm_matmul would write, running
                    nothing (for a weight compressed along axis 1: the
                    one indexmac_gather would write for B of x_shape)
  indexmac_gather(w, b)
                    C = densify(w) @ b for A compressed along its rows
                    (w.axis == 1): the paper's Algorithm 3, dispatched
                    by w's policy and type (QNMWeight -> int8 family)
  attention(q, k, v, mask=...)
                    block-sparse attention under a MaskSpec; the family
                    follows ``cache`` (None: prefill/train, the
                    hand-written kernel on the card; a decode/chunk
                    CacheView: the mask-aware decode path)
  explain_dispatch_attention(q_shape, kv_shape, mask=...)
                    the DispatchRecord attention would write, running
                    nothing
  sparsify_conv(w, nm)
                    an HWIO conv kernel -> NMWeight over K = kh*kw*C_in
  conv2d(x, w, kh=, kw=)
                    NHWC conv through the im2col GEMM, dispatched as
                    nm_matmul
  CacheView         how a forward call addresses the KV cache (slot or
                    paged layout)
  is_sparse(obj)    True for the typed compressed weight nodes
  resolve_backend   the backend a call on a device resolves to
  MambaConfig, Mamba, RWKVConfig, RWKV
                    the recurrent mixers' configs and modules (Mamba-1's
                    selective scan, RWKV-6's time-mix and channel-mix);
                    whole models are ``repro_torch.models.transformer.LM``

Kernel policy (``KernelPolicy.mode``): ``off`` pins the plain reference;
``force`` runs the hand-written kernel or raises
:class:`KernelForceError`; ``auto`` is ``force`` on the CUDA backend and
gives a call without a kernel to the reference only on the CPU backend.
Backends (``KernelPolicy.backend`` / ``backend=``): ``auto`` (then
``$REPRO_TORCH_BACKEND``, then the tensor's device), ``cuda`` or
``cpu``. Attention takes the same policies: ``auto`` on the card runs
the block-sparse kernel or raises :class:`MaskForceError`.
Conv layers and whole backbones are ``repro_torch.models.conv``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import MambaConfig, RWKVConfig
from repro_torch.core.nmweight import KernelPolicy, MaskedNMWeight, NMWeight
from repro_torch.core.sparsity import (
    NMConfig,
    apply_mask,
    compress_nm,
    decompress_nm,
    prune_mask_nm,
)
from repro_torch.kernels.blocksparse_attn.mask import MaskSpec
from repro_torch.kernels.blocksparse_attn.ops import MaskForceError
from repro_torch.kernels.blocksparse_attn.ops import (
    bs_attention as _bs_attention,
)
from repro_torch.kernels.blocksparse_attn.ops import (
    bs_attention_decode as _bs_attention_decode,
)
from repro_torch.kernels.blocksparse_attn.ops import (
    explain_dispatch_attention as _explain_dispatch_attention,
)
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.indexmac.ops import (
    explain_dispatch as _explain_dispatch,
)
from repro_torch.kernels.indexmac.ops import nm_matmul as _nm_matmul
from repro_torch.kernels.indexmac_gather.ops import (
    indexmac_gather as _indexmac_gather,
)
from repro_torch.kernels.registry import (  # noqa: F401 (re-export)
    DispatchRecord,
    KernelForceError,
    resolve_backend,
)
from repro_torch.models.cache import CacheView
from repro_torch.models.conv import conv2d as _conv2d
from repro_torch.models.mamba import Mamba
from repro_torch.models.rwkv import RWKV
from repro_torch.quant import QNMWeight
from repro_torch.quant import dequantize as _dequantize
from repro_torch.quant import dequantize_tree, quantize_tree  # noqa: F401
from repro_torch.quant import quantize_nm as _quantize_nm

__all__ = [
    "CacheView",
    "DispatchRecord",
    "Epilogue",
    "KernelForceError",
    "KernelPolicy",
    "Mamba",
    "MambaConfig",
    "MaskForceError",
    "MaskSpec",
    "MaskedNMWeight",
    "NMConfig",
    "NMWeight",
    "QNMWeight",
    "RWKV",
    "RWKVConfig",
    "attention",
    "conv2d",
    "densify",
    "dequantize",
    "dequantize_tree",
    "explain_dispatch",
    "explain_dispatch_attention",
    "indexmac_gather",
    "is_sparse",
    "nm_matmul",
    "quantize",
    "quantize_tree",
    "resolve_backend",
    "sparsify",
    "sparsify_conv",
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


def sparsify_conv(w: torch.Tensor, nm: NMConfig, *,
                  kernel_policy: Union[KernelPolicy, str] = KernelPolicy(
                      "auto")) -> NMWeight:
    """Prune and compress a conv kernel for the im2col GEMM path. ``w``
    is HWIO ``(kh, kw, C_in, C_out)``; the N:M pattern runs along the
    flattened contraction axis K = kh*kw*C_in, the axis :func:`conv2d`
    contracts over, so the result is the weight a
    ``repro_torch.models.conv.SparseConv2D`` holds."""
    if w.dim() != 4:
        raise ValueError(
            f"sparsify_conv expects an HWIO (kh, kw, C_in, C_out) kernel, "
            f"got shape {tuple(w.shape)}")
    kh, kw, c_in, c_out = w.shape
    return sparsify(w.reshape(kh * kw * c_in, c_out), nm, axis=0,
                    kernel_policy=kernel_policy)


def conv2d(x: torch.Tensor, w, *, kh: int, kw: int, stride=1,
           padding: str = "SAME", compute_dtype=None) -> torch.Tensor:
    """y = conv(x, densify(w)) through the im2col GEMM on the kernel
    path; ``w`` is a weight from :func:`sparsify_conv` (or its quantized
    or dense sibling), x is NHWC."""
    return _conv2d(x, w, kh=kh, kw=kw, stride=stride, padding=padding,
                   compute_dtype=compute_dtype)


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
    """The dense tensor behind any linear-weight node (for a
    :class:`MaskedNMWeight` what its forward multiplies by: the N:M
    projection of its storage)."""
    if isinstance(w, NMWeight):
        return decompress_nm(w.vals, w.idx, w.nm, axis=w.axis)
    if isinstance(w, (QNMWeight, MaskedNMWeight)):
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


def indexmac_gather(w, b: torch.Tensor, *,
                    backend: Optional[str] = None) -> torch.Tensor:
    """C = densify(w) @ b for a row-compressed A (``w.axis == 1``): the
    paper's literal gather orientation. Takes an :class:`NMWeight` or an
    int8 :class:`QNMWeight` (scales per row); ``backend`` overrides the
    policy's."""
    return _indexmac_gather(w, b, backend=backend)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              mask: MaskSpec, cache: Optional[CacheView] = None, scale=None,
              policy="auto", backend: Optional[str] = None,
              tile: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """Block-sparse attention under a declared :class:`MaskSpec`.

    ``cache=None`` is the prefill / train case (q and k/v cover the same
    absolute positions from 0): the ``bs_attention`` family, the
    hand-written kernel on the card and the block-gather lowering (or,
    under the density / waste budgets, the dense reference) on the CPU.
    A :class:`CacheView` in decode or chunk mode means k/v are
    fixed-size cache views: the ``bs_attention_decode`` family with the
    valid extent ``cache_len + Sq`` (chunk mode masks by the queries'
    absolute positions). ``policy`` / ``backend`` / ``tile`` as for
    :func:`nm_matmul`; a forced (on the card: automatic) call whose mask
    does not tile raises :class:`MaskForceError`."""
    if cache is None:
        return _bs_attention(q, k, v, spec=mask, scale=scale, policy=policy,
                             backend=backend, tile=tile)
    if not isinstance(cache, CacheView):
        raise TypeError(
            f"cache must be a CacheView (or None for prefill/train), got "
            f"{type(cache).__name__}")
    if not cache.offset_mode:
        raise ValueError(
            f"a {cache.mode!r} CacheView carries no cache offset: pass "
            f"cache=None for prefill/train attention")
    sq = q.shape[1]
    cl = cache.cache_len.to(q.device)
    q_positions = None
    if cache.mode == "chunk":
        q_positions = cache.positions
        if q_positions is None:
            ar = torch.arange(sq, device=q.device)
            q_positions = cl[:, None] + ar if cl.dim() == 1 else ar + cl
    return _bs_attention_decode(
        q, k, v, spec=mask, length=cl + sq, q_positions=q_positions,
        scale=scale, policy=policy, backend=backend)


def explain_dispatch_attention(q_shape, kv_shape, *, mask: MaskSpec,
                               decode: bool = False, dtype=None,
                               policy="auto", backend: Optional[str] = None,
                               tile: Optional[tuple[int, int]] = None,
                               device=None) -> DispatchRecord:
    """The :class:`DispatchRecord` :func:`attention` would write for
    operands of these shapes (``decode=True`` for the cache-view family)
    on ``device`` (default: the named backend's, else the card), running
    nothing; it shares the route with the call, so it raises the same
    typed errors, :class:`MaskForceError` included."""
    return _explain_dispatch_attention(
        q_shape, kv_shape, mask=mask, decode=decode,
        dtype=dtype if dtype is not None else torch.float32, policy=policy,
        backend=backend, tile=tile, device=device)
