"""The compressed-GEMM op layer (port of ``repro.kernels.indexmac.ops``,
float families): one typed entry point, two dispatch families, fused
epilogues.

``nm_matmul(x, w, *, epilogue=None)`` takes an :class:`NMWeight`; its
``nm`` and :class:`KernelPolicy` drive dispatch. ``off`` pins the plain
reference (the caller's choice). ``force`` takes the hand-written kernel
and raises :class:`KernelForceError` when the call has no kernel (no
kernel geometry for its N:M pattern, or a dtype the kernels are not
built for). ``auto`` is ``force`` on the CUDA backend: a tensor on the
card runs the kernel or raises. Only on the CPU backend does ``auto``
give such a call to the reference, with the reason on the record.

Families (chosen by the flattened row count M, never by falling back):

  nm_matmul         M > REPRO_DECODE_M_MAX: the tiled kernel ``nm_spmm``;
                    the epilogue is applied after the GEMM
  nm_matmul_decode  M <= REPRO_DECODE_M_MAX (default 8): the skinny-M
                    kernel ``nm_spmm_decode`` with the epilogue fused

Both kernels take their operands as they are: ragged edges are masked in
the kernel, so no padded copy of the weight is made per call.
``explain_dispatch`` answers which family and implementation a call
would take, through the same router, without running anything.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch

from repro_torch.core.nmweight import NMWeight
from repro_torch.kernels import registry
from repro_torch.kernels.epilogue import apply_epilogue_f32, resolve_epilogue
from repro_torch.kernels.indexmac.decode_kernel import nm_spmm_decode
from repro_torch.kernels.indexmac.kernel import KERNEL_DTYPES, nm_spmm
from repro_torch.kernels.indexmac.ref import nm_matmul_decode_ref, nm_matmul_ref
from repro_torch.kernels.padding import (
    decode_block,
    plan_nm_matmul,
    prefill_block,
)

__all__ = ["decode_m_max", "explain_dispatch", "nm_matmul"]


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


def _route(mm, nn, kk, cfg, dtype, pol, backend):
    """Family, kernel geometry and dispatch context of one call, shared by
    :func:`nm_matmul` and :func:`explain_dispatch`."""
    decode = mm <= decode_m_max()
    op = "nm_matmul_decode" if decode else "nm_matmul"
    use_kernel = pol.mode != "off"
    plan = None
    if use_kernel:
        tile = (decode_block(cfg, nn, dtype.itemsize) if decode
                else prefill_block(cfg))
        plan = plan_nm_matmul(mm, nn, kk, cfg, tile, decode=decode)
        strict = pol.mode == "force" or backend == "cuda"
        if strict and (plan is None or dtype not in KERNEL_DTYPES):
            raise registry.KernelForceError(
                f"KernelPolicy({pol.mode!r}) on backend {backend!r} for an "
                f"NMWeight with pattern {cfg.tag}: M={mm} K={kk} N={nn} in "
                f"{dtype} has no kernel, and the reference may run only "
                f"under policy 'off' (or 'auto' on the cpu backend)")
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


# ---------------------------------------------------------------------------
# typed entry point
# ---------------------------------------------------------------------------


def _epilogue_after(y, bias, activation):
    """The prefill family applies the epilogue composition after the GEMM
    (the decode kernel fuses it; same arithmetic either way)."""
    if bias is None and activation is None:
        return y
    return apply_epilogue_f32(y.float(), bias, activation).to(y.dtype)


def _check_weight(w, name):
    if not isinstance(w, NMWeight):
        raise TypeError(f"{name} expects an NMWeight, got {type(w).__name__}")
    if w.axis != 0:
        raise ValueError(
            f"{name} needs the weight compressed along axis 0 (the "
            f"contraction dim of y = x @ W); got axis={w.axis}")


def nm_matmul(x: torch.Tensor, w: NMWeight, *, epilogue=None,
              backend: Optional[str] = None) -> torch.Tensor:
    """y = epilogue(x @ densify(w)); x: (..., K), w compressed along K.

    ``backend`` overrides the policy's (``auto``/``cuda``/``cpu``). A
    weight stored in another dtype than x is cast for the call; the
    models store their weights in the model dtype so that never happens
    on the served path.
    """
    bias, activation = resolve_epilogue(epilogue)
    _check_weight(w, "nm_matmul")
    pol = w.kernel_policy
    be = registry.resolve_backend(backend or pol.backend, x.device)
    k = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    vals, idx = w.vals, w.idx
    if vals.dtype != x.dtype:
        vals = vals.to(x.dtype)
    nn = vals.shape[1]
    _validate_pair(vals, idx, k, w.nm)
    op, _, ctx = _route(x2.shape[0], nn, k, w.nm, x.dtype, pol, be)
    if op == "nm_matmul_decode":
        y2 = registry.dispatch(op, ctx, x2, vals, idx, bias, cfg=w.nm,
                               activation=activation)
    else:
        y2 = registry.dispatch(op, ctx, x2, vals, idx, cfg=w.nm)
        y2 = _epilogue_after(y2, bias, activation)
    return y2.reshape(*lead, nn)


def explain_dispatch(x_shape, w: NMWeight, *, epilogue=None, dtype=None,
                     backend: Optional[str] = None, device=None):
    """The :class:`DispatchRecord` ``nm_matmul(x, w)`` would write for an
    ``x`` of shape ``x_shape`` (and ``dtype``, default the weight's, on
    ``device``, default the weight's), running nothing. Raises the same
    typed errors as the call."""
    _check_weight(w, "explain_dispatch")
    resolve_epilogue(epilogue)  # validates; the epilogue never routes
    k = x_shape[-1]
    mm = math.prod(x_shape[:-1]) if len(x_shape) > 1 else 1
    nn = w.vals.shape[1]
    _validate_pair(w.vals, w.idx, k, w.nm)
    pol = w.kernel_policy
    device = torch.device(device) if device is not None else w.vals.device
    be = registry.resolve_backend(backend or pol.backend, device)
    op, _, ctx = _route(mm, nn, k, w.nm, dtype or w.vals.dtype, pol, be)
    return registry.explain(op, ctx)
