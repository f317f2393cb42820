"""The compressed-GEMM op layer (port of ``repro.kernels.indexmac.ops``):
one typed entry point, four dispatch families, fused epilogues.

``nm_matmul(x, w, *, epilogue=None)`` takes an :class:`NMWeight` or an
int8 :class:`QNMWeight`; the weight's ``nm``, its :class:`KernelPolicy`
and its *type* drive dispatch. ``off`` pins the plain reference (the
caller's choice). ``force`` takes the hand-written kernel and raises
:class:`KernelForceError` when the call has no kernel (no kernel
geometry for its N:M pattern, or an x dtype the kernels are not built
for). ``auto`` is ``force`` on the CUDA backend: a tensor on the card
runs the kernel or raises. Only on the CPU backend does ``auto`` give
such a call to the reference, with the reason on the record.

Families (chosen by the weight's type and the flattened row count M,
never by falling back):

  nm_matmul           float vals, M > REPRO_DECODE_M_MAX: the tiled
                      kernel ``nm_spmm``; the epilogue after the GEMM
  nm_matmul_q         int8 vals, same M: ``nm_spmm_q`` (scales at
                      writeback); the epilogue after the GEMM, on the
                      output cast to x's dtype
  nm_matmul_decode    float vals, M <= REPRO_DECODE_M_MAX (default 8):
                      the skinny-M kernel ``nm_spmm_decode``, epilogue
                      fused
  nm_matmul_decode_q  int8 decode sibling ``nm_spmm_decode_q``: scales,
                      bias and activation fused, in that order

An int8 payload is never cast: only x follows the caller's dtype, and
the kernels widen the int8 values themselves. The kernels take their
operands as they are: ragged edges are masked in the kernel, so no
padded copy of the weight is made per call. ``explain_dispatch``
answers which family and implementation a call would take, through the
same router, without running anything. The int8 families are inference
only, as in the JAX package.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch

from repro_torch.core.nmweight import NMWeight
from repro_torch.kernels import registry
from repro_torch.kernels.epilogue import apply_epilogue_f32, resolve_epilogue
from repro_torch.kernels.indexmac.decode_kernel import (
    nm_spmm_decode,
    nm_spmm_decode_q,
)
from repro_torch.kernels.indexmac.kernel import (
    KERNEL_DTYPES,
    nm_spmm,
    nm_spmm_q,
)
from repro_torch.kernels.indexmac.ref import (
    nm_matmul_decode_q_ref,
    nm_matmul_decode_ref,
    nm_matmul_q_ref,
    nm_matmul_ref,
)
from repro_torch.kernels.padding import (
    decode_block,
    plan_nm_matmul,
    prefill_block,
)
from repro_torch.quant.qnmweight import QNMWeight

__all__ = ["decode_m_max", "explain_dispatch", "nm_matmul", "nm_matmul_q"]


def decode_m_max() -> int:
    """Largest M (flattened row count) routed to the decode family."""
    return int(os.environ.get("REPRO_DECODE_M_MAX", 8))


def _validate_pair(vals, idx, k, cfg):
    if vals.shape[0] * cfg.m != k * cfg.n:
        raise ValueError(
            f"vals rows {vals.shape[0]} inconsistent with K={k} and {cfg.tag}")
    if idx.shape != vals.shape:
        raise ValueError("idx/vals shape mismatch")


# ---------------------------------------------------------------------------
# routing: (M, K, N) + policy -> family + kernel geometry
# ---------------------------------------------------------------------------


def _route(mm, nn, kk, cfg, dtype, pol, backend, quantized=False):
    """Family, kernel geometry and dispatch context of one call, shared by
    :func:`nm_matmul` and :func:`explain_dispatch`. ``dtype`` is x's:
    the gate of every family (the int8 families' vals are int8 by type,
    and their vector width follows that one byte)."""
    decode = mm <= decode_m_max()
    op = ("nm_matmul_decode" if decode else "nm_matmul") + (
        "_q" if quantized else "")
    use_kernel = pol.mode != "off"
    plan = None
    if use_kernel:
        itemsize = 1 if quantized else dtype.itemsize
        tile = (decode_block(cfg, nn, itemsize) if decode
                else prefill_block(cfg))
        plan = plan_nm_matmul(mm, nn, kk, cfg, tile, decode=decode)
        strict = pol.mode == "force" or backend == "cuda"
        if strict and (plan is None or dtype not in KERNEL_DTYPES):
            kind = "QNMWeight" if quantized else "NMWeight"
            raise registry.KernelForceError(
                f"KernelPolicy({pol.mode!r}) on backend {backend!r} for a "
                f"{kind} with pattern {cfg.tag}: M={mm} K={kk} N={nn} with "
                f"x in {dtype} has no kernel, and the reference may run "
                f"only under policy 'off' (or 'auto' on the cpu backend)")
    ctx = registry.make_ctx((mm, kk, nn), nm=cfg, use_kernel=use_kernel,
                            plan=plan, dtype=dtype, backend=backend)
    return op, plan, ctx


def _kernel_supports(ctx: dict) -> Optional[str]:
    if not ctx["use_kernel"]:
        return "use_kernel=False"
    if ctx["plan"] is None:
        return "shape has no kernel geometry"
    if ctx["dtype"] not in KERNEL_DTYPES:
        return f"no kernel build for {ctx['dtype']}"
    return None


@registry.register("nm_matmul", "nm_spmm", priority=100,
                   supports=_kernel_supports, uses_plan=True)
def _run_nm_spmm(x2, vals, idx, *, cfg):
    return nm_spmm(x2, vals, idx, cfg)


@registry.register("nm_matmul", "reference", priority=0)
def _run_ref(x2, vals, idx, *, cfg):
    return nm_matmul_ref(x2, vals, idx, cfg)


@registry.register("nm_matmul_decode", "nm_spmm_decode", priority=100,
                   supports=_kernel_supports, uses_plan=True)
def _run_nm_spmm_decode(x2, vals, idx, bias, *, cfg, activation):
    return nm_spmm_decode(x2, vals, idx, bias, cfg, activation)


@registry.register("nm_matmul_decode", "reference_decode", priority=0)
def _run_ref_decode(x2, vals, idx, bias, *, cfg, activation):
    return nm_matmul_decode_ref(x2, vals, idx, bias, cfg, activation)


@registry.register("nm_matmul_q", "nm_spmm_q", priority=100,
                   supports=_kernel_supports, uses_plan=True)
def _run_nm_spmm_q(x2, vals, idx, scales, *, cfg):
    return nm_spmm_q(x2, vals, idx, scales, cfg)


@registry.register("nm_matmul_q", "reference_q", priority=0)
def _run_ref_q(x2, vals, idx, scales, *, cfg):
    return nm_matmul_q_ref(x2, vals, idx, scales, cfg)


@registry.register("nm_matmul_decode_q", "nm_spmm_decode_q", priority=100,
                   supports=_kernel_supports, uses_plan=True)
def _run_nm_spmm_decode_q(x2, vals, idx, scales, bias, *, cfg, activation):
    return nm_spmm_decode_q(x2, vals, idx, scales, bias, cfg, activation)


@registry.register("nm_matmul_decode_q", "reference_decode_q", priority=0)
def _run_ref_decode_q(x2, vals, idx, scales, bias, *, cfg, activation):
    return nm_matmul_decode_q_ref(x2, vals, idx, scales, bias, cfg,
                                  activation)


# ---------------------------------------------------------------------------
# typed entry point
# ---------------------------------------------------------------------------


def _epilogue_after(y, bias, activation):
    """The prefill families apply the epilogue composition after the GEMM,
    on the output already cast to x's dtype (the decode kernels fuse it
    into the f32 writeback; the same arithmetic in f32)."""
    if bias is None and activation is None:
        return y
    return apply_epilogue_f32(y.float(), bias, activation).to(y.dtype)


def _check_weight(w, name):
    if not isinstance(w, (NMWeight, QNMWeight)):
        raise TypeError(f"{name} expects an NMWeight or QNMWeight, got "
                        f"{type(w).__name__}")
    if w.axis != 0:
        raise ValueError(
            f"{name} needs the weight compressed along axis 0 (the "
            f"contraction dim of y = x @ W); got axis={w.axis}")


def nm_matmul(x: torch.Tensor, w, *, epilogue=None,
              backend: Optional[str] = None) -> torch.Tensor:
    """y = epilogue(x @ densify(w)); x: (..., K), w an :class:`NMWeight`
    or :class:`QNMWeight` compressed along K.

    ``backend`` overrides the policy's (``auto``/``cuda``/``cpu``). A
    float weight stored in another dtype than x is cast for the call
    (the models store their weights in the model dtype so that never
    happens on the served path); an int8 weight is never cast.
    """
    bias, activation = resolve_epilogue(epilogue)
    _check_weight(w, "nm_matmul")
    quantized = isinstance(w, QNMWeight)
    pol = w.kernel_policy
    be = registry.resolve_backend(backend or pol.backend, x.device)
    k = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    vals, idx = w.vals, w.idx
    if not quantized and vals.dtype != x.dtype:
        vals = vals.to(x.dtype)
    nn = vals.shape[1]
    _validate_pair(vals, idx, k, w.nm)
    op, _, ctx = _route(x2.shape[0], nn, k, w.nm, x.dtype, pol, be,
                        quantized)
    weight = (vals, idx, w.scales) if quantized else (vals, idx)
    if op.startswith("nm_matmul_decode"):
        y2 = registry.dispatch(op, ctx, x2, *weight, bias, cfg=w.nm,
                               activation=activation)
    else:
        y2 = registry.dispatch(op, ctx, x2, *weight, cfg=w.nm)
        y2 = _epilogue_after(y2, bias, activation)
    return y2.reshape(*lead, nn)


def nm_matmul_q(x: torch.Tensor, w: QNMWeight, *, epilogue=None,
                backend: Optional[str] = None) -> torch.Tensor:
    """:func:`nm_matmul` for a weight that must be int8 (the entry point
    dispatches on the type; this name asserts it)."""
    if not isinstance(w, QNMWeight):
        raise TypeError(f"nm_matmul_q expects a QNMWeight, got "
                        f"{type(w).__name__}; make one with "
                        f"repro_torch.api.quantize")
    return nm_matmul(x, w, epilogue=epilogue, backend=backend)


def explain_dispatch(x_shape, w, *, epilogue=None, dtype=None,
                     backend: Optional[str] = None, device=None):
    """The :class:`DispatchRecord` ``nm_matmul(x, w)`` would write for an
    ``x`` of shape ``x_shape``, in ``dtype`` and on ``device``, running
    nothing. ``dtype`` defaults to the weight's value dtype, or f32 for
    an int8 weight (its scales' dtype); ``device`` to the weight's.
    Raises the same typed errors as the call."""
    _check_weight(w, "explain_dispatch")
    resolve_epilogue(epilogue)  # validates; the epilogue never routes
    quantized = isinstance(w, QNMWeight)
    k = x_shape[-1]
    mm = math.prod(x_shape[:-1]) if len(x_shape) > 1 else 1
    nn = w.vals.shape[1]
    _validate_pair(w.vals, w.idx, k, w.nm)
    pol = w.kernel_policy
    device = torch.device(device) if device is not None else w.vals.device
    be = registry.resolve_backend(backend or pol.backend, device)
    dtype = dtype or (torch.float32 if quantized else w.vals.dtype)
    op, _, ctx = _route(mm, nn, k, w.nm, dtype, pol, be, quantized)
    return registry.explain(op, ctx)
