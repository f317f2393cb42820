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

Launches. The launch each kernel runs is the one its dispatch record
names (``block``): the policy's pinned ``block`` / ``decode_block``,
else the autotune cache's entry for the call's shape, else (with
``REPRO_AUTOTUNE=1``, and no CUDA graph being captured) a sweep's
winner, else the host rule's (``padding.prefill_block`` /
``decode_block``); see :mod:`repro_torch.kernels.autotune`.

An int8 payload is never cast: only x follows the caller's dtype, and
the kernels widen the int8 values themselves. The kernels take their
operands as they are: ragged edges are masked in the kernel, so no
padded copy of the weight is made per call. ``explain_dispatch``
answers which family and implementation a call would take, through the
same router, without running anything. The float families train: under
autograd a call runs :class:`_NMMatmul`, whose backward is the JAX
package's reference composition in f32. The int8 families are inference
only, as in the JAX package, and raise when autograd would record them.
A weight compressed along axis 1 (the paper's A orientation) belongs to
the gather port,
``repro_torch.kernels.indexmac_gather``: ``nm_matmul`` rejects it and
``explain_dispatch`` hands it to ``explain_gather``.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch

from repro_torch.core.nmweight import NMWeight
from repro_torch.kernels import autotune, registry
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
from repro_torch.kernels.indexmac_gather.ops import explain_gather
from repro_torch.kernels.indexmac.ref import (
    nm_matmul_decode_q_ref,
    nm_matmul_decode_ref,
    nm_matmul_q_ref,
    nm_matmul_ref,
)
from repro_torch.kernels.padding import (
    decode_launch,
    plan_nm_matmul,
    prefill_candidates,
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


def _launches(block, decode, mm, nn, kk, cfg, dtype, vals_dtype) -> bool:
    """Whether ``block`` names a compiled launch of the family."""
    if decode:
        return decode_launch(block, mm, kk, nn, cfg,
                             vals_dtype.itemsize) is not None
    return tuple(block) in prefill_candidates(cfg, mm, nn, dtype, vals_dtype)


def _route(mm, nn, kk, cfg, dtype, pol, backend, quantized=False,
           device=None):
    """Family, kernel geometry and dispatch context of one call, shared by
    :func:`nm_matmul` and :func:`explain_dispatch`. ``dtype`` is x's:
    the gate of every family (the int8 families' vals are int8 by type,
    and their vector width follows that one byte). The block is the
    policy's, else the autotune cache's or the rule's for ``device``'s
    card (module docstring). On meta (the dry-run) the block is the
    policy's or the rule's, and the card's checks apply: a call the card
    refuses raises there too."""
    decode = mm <= decode_m_max()
    op = ("nm_matmul_decode" if decode else "nm_matmul") + (
        "_q" if quantized else "")
    use_kernel = pol.mode != "off"
    plan, notes = None, []
    if use_kernel:
        vals_dtype = torch.int8 if quantized else dtype
        strict = pol.mode == "force" or backend in ("cuda", "meta")
        block = pol.decode_block if decode else pol.block
        family = "decode" if decode else "prefill"
        if block is not None:
            if not _launches(block, decode, mm, nn, kk, cfg, dtype,
                             vals_dtype):
                if strict:
                    raise registry.KernelForceError(
                        f"KernelPolicy({pol.mode!r}) pins "
                        f"{'decode_block' if decode else 'block'}={block}, "
                        f"which names no compiled launch of {op} for "
                        f"{cfg.tag} at M={mm} K={kk} N={nn} with x in "
                        f"{dtype}")
                notes.append(f"pinned block {block} names no launch")
                block = None
        elif backend != "meta" and dtype in KERNEL_DTYPES and \
                kk % cfg.m == 0 and min(mm, nn, kk) > 0:
            block = autotune.best_block(mm, nn, kk, cfg, vals_dtype, family,
                                        x_dtype=dtype, device=device,
                                        notes=notes)
        else:  # the dry-run, or no kernel for the call: the rule's
            block = autotune.default_block(mm, nn, kk, cfg, vals_dtype,
                                           family, x_dtype=dtype,
                                           device=device)
        if block is not None:
            plan = plan_nm_matmul(mm, nn, kk, cfg, block, decode=decode)
        if strict and (plan is None or dtype not in KERNEL_DTYPES):
            kind = "QNMWeight" if quantized else "NMWeight"
            raise registry.KernelForceError(
                f"KernelPolicy({pol.mode!r}) on backend {backend!r} for a "
                f"{kind} with pattern {cfg.tag}: M={mm} K={kk} N={nn} with "
                f"x in {dtype} has no kernel, and the reference may run "
                f"only under policy 'off' (or 'auto' on the cpu backend)")
    ctx = registry.make_ctx((mm, kk, nn), nm=cfg, use_kernel=use_kernel,
                            plan=plan, dtype=dtype, backend=backend)
    ctx["note"] = "; ".join(notes)
    return op, plan, ctx


def _kernel_supports(ctx: dict) -> Optional[str]:
    if not ctx["use_kernel"]:
        return "use_kernel=False"
    if ctx["plan"] is None:
        return "shape has no kernel geometry"
    if ctx["dtype"] not in KERNEL_DTYPES:
        return f"no kernel build for {ctx['dtype']}"
    return None


def _decode_plan(x2, vals, cfg, plan):
    """The decode launch of the record's block (rows, columns, span)."""
    return decode_launch(plan.block, x2.shape[0], x2.shape[1],
                         vals.shape[1], cfg, vals.element_size())


# the kernel implementations launch the plan the record names (``plan``,
# the PadPlan of the route); the references take it and ignore it


@registry.register("nm_matmul", "nm_spmm", priority=100,
                   supports=_kernel_supports, uses_plan=True)
def _run_nm_spmm(x2, vals, idx, *, cfg, plan):
    return nm_spmm(x2, vals, idx, cfg, tile=plan.block[:2])


@registry.register("nm_matmul", "reference", priority=0)
def _run_ref(x2, vals, idx, *, cfg, plan):
    return nm_matmul_ref(x2, vals, idx, cfg)


@registry.register("nm_matmul_decode", "nm_spmm_decode", priority=100,
                   supports=_kernel_supports, uses_plan=True)
def _run_nm_spmm_decode(x2, vals, idx, bias, *, cfg, activation, plan):
    return nm_spmm_decode(x2, vals, idx, bias, cfg, activation,
                          plan=_decode_plan(x2, vals, cfg, plan))


@registry.register("nm_matmul_decode", "reference_decode", priority=0)
def _run_ref_decode(x2, vals, idx, bias, *, cfg, activation, plan):
    return nm_matmul_decode_ref(x2, vals, idx, bias, cfg, activation)


@registry.register("nm_matmul_q", "nm_spmm_q", priority=100,
                   supports=_kernel_supports, uses_plan=True)
def _run_nm_spmm_q(x2, vals, idx, scales, *, cfg, plan):
    return nm_spmm_q(x2, vals, idx, scales, cfg, tile=plan.block[:2])


@registry.register("nm_matmul_q", "reference_q", priority=0)
def _run_ref_q(x2, vals, idx, scales, *, cfg, plan):
    return nm_matmul_q_ref(x2, vals, idx, scales, cfg)


@registry.register("nm_matmul_decode_q", "nm_spmm_decode_q", priority=100,
                   supports=_kernel_supports, uses_plan=True)
def _run_nm_spmm_decode_q(x2, vals, idx, scales, bias, *, cfg, activation,
                          plan):
    return nm_spmm_decode_q(x2, vals, idx, scales, bias, cfg, activation,
                            plan=_decode_plan(x2, vals, cfg, plan))


@registry.register("nm_matmul_decode_q", "reference_decode_q", priority=0)
def _run_ref_decode_q(x2, vals, idx, scales, bias, *, cfg, activation,
                      plan):
    return nm_matmul_decode_q_ref(x2, vals, idx, scales, bias, cfg,
                                  activation)


# meta tensors (the dry-run): the kernel's output, empty; x's dtype


@registry.register_meta("nm_matmul")
@registry.register_meta("nm_matmul_q")
@registry.register_meta("nm_matmul_decode")
@registry.register_meta("nm_matmul_decode_q")
def _run_meta(x2, vals, *_, **__):
    return x2.new_empty((x2.shape[0], vals.shape[1]))


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


def _dispatch(x, vals, idx, scales, bias, cfg, pol, activation, backend):
    """One call through the router and the registry: the forward of every
    family (``scales`` is None for a float weight)."""
    quantized = scales is not None
    be = registry.resolve_backend(backend or pol.backend, x.device)
    k = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    nn = vals.shape[1]
    _validate_pair(vals, idx, k, cfg)
    op, plan, ctx = _route(x2.shape[0], nn, k, cfg, x.dtype, pol, be,
                           quantized, x.device)
    weight = (vals, idx, scales) if quantized else (vals, idx)
    if op.startswith("nm_matmul_decode"):
        y2 = registry.dispatch(op, ctx, x2, *weight, bias, cfg=cfg,
                               activation=activation, plan=plan)
    else:
        y2 = registry.dispatch(op, ctx, x2, *weight, cfg=cfg, plan=plan)
        y2 = _epilogue_after(y2, bias, activation)
    return y2.reshape(*lead, nn)


def _dense_rows(idx: torch.Tensor, cfg):
    """(rows, valid): the dense row ``block * m + idx`` of every kept
    value of a (Kc, N) pair, and whether its index lies in ``[0, m)``
    (:func:`decompress_nm` adds nothing for one that does not)."""
    block = torch.arange(idx.shape[0], device=idx.device) // cfg.n
    i = idx.long()
    valid = (i >= 0) & (i < cfg.m)
    rows = block[:, None] * cfg.m + i.clamp(0, cfg.m - 1)
    return rows, valid


class _NMMatmul(torch.autograd.Function):
    """The float families with a backward (port of ``_nm_matmul_core``'s
    ``custom_vjp``). The forward is the dispatch, unchanged: on the card
    a hand-written kernel. The backward is the reference composition in
    f32 on the logical shapes, as the JAX package's ``_core_bwd``:
    y = epilogue(f32(x) @ f32(decompress(vals, idx))), with the pre-
    epilogue product recomputed from x and the weight when an activation
    is fused (the kernel's output is never differentiated). dx is cast
    to x's dtype, dvals (the dense dW gathered at the kept rows
    ``block * m + idx``: a repeated index gets the dW of its position,
    as the one-hot sum's vjp gives) to vals', dbias to the bias'. idx
    gets no gradient."""

    @staticmethod
    def forward(ctx, x, vals, bias, idx, cfg, pol, activation, backend):
        ctx.save_for_backward(x, vals, bias, idx)
        ctx.cfg, ctx.activation = cfg, activation
        return _dispatch(x, vals, idx, None, bias, cfg, pol, activation,
                         backend)

    @staticmethod
    def backward(ctx, dy):
        x, vals, bias, idx = ctx.saved_tensors
        cfg, activation = ctx.cfg, ctx.activation
        k, nn = x.shape[-1], vals.shape[1]
        rows, valid = _dense_rows(idx, cfg)
        w = torch.zeros(k, nn, dtype=torch.float32, device=vals.device)
        w.scatter_add_(0, rows, torch.where(valid, vals.float(), 0.0))
        x2 = x.reshape(-1, k).float()
        dyp = dy.reshape(-1, nn).float()
        dbias = None
        if activation is not None:
            with torch.enable_grad():
                y = torch.matmul(x2, w).requires_grad_()
                b = (bias.detach().requires_grad_() if bias is not None
                     else None)
                out = apply_epilogue_f32(y, b, activation)
                grads = torch.autograd.grad(
                    out, [y] + ([b] if b is not None else []), dyp)
            dyp = grads[0]
            if b is not None:
                dbias = grads[1].to(bias.dtype)
        elif bias is not None:
            dbias = dyp.sum(0).to(bias.dtype)
        dx = dvals = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(dyp, w.t()).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x2.t(), dyp)
            dvals = torch.where(valid, dw.gather(0, rows), 0.0).to(
                vals.dtype)
        if not ctx.needs_input_grad[2]:
            dbias = None
        return dx, dvals, dbias, None, None, None, None, None


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def nm_matmul(x: torch.Tensor, w, *, epilogue=None,
              backend: Optional[str] = None) -> torch.Tensor:
    """y = epilogue(x @ densify(w)); x: (..., K), w an :class:`NMWeight`
    or :class:`QNMWeight` compressed along K.

    ``backend`` overrides the policy's (``auto``/``cuda``/``cpu``). A
    float weight stored in another dtype than x is cast for the call (a
    differentiable cast: a model that trains f32 weights in a bf16
    compute dtype gets its gradient back in f32); an int8 weight is
    never cast. When autograd records the call (grad mode on and x,
    the values or the bias requiring grad) a float weight runs through
    :class:`_NMMatmul`, whose forward is the same dispatch; an int8
    weight raises, as int8 weights are inference only.
    """
    bias, activation = resolve_epilogue(epilogue)
    _check_weight(w, "nm_matmul")
    vals = w.vals
    if isinstance(w, QNMWeight):
        if _wants_grad(x, bias):
            raise RuntimeError(
                "nm_matmul: an int8 QNMWeight is inference only and has no "
                "backward; run it under torch.no_grad() / inference_mode, "
                "or train the float NMWeight it was quantized from")
        return _dispatch(x, vals, w.idx, w.scales, bias, w.nm,
                         w.kernel_policy, activation, backend)
    if vals.dtype != x.dtype:
        vals = vals.to(x.dtype)
    if _wants_grad(x, vals, bias):
        return _NMMatmul.apply(x, vals, bias, w.idx, w.nm, w.kernel_policy,
                               activation, backend)
    return _dispatch(x, vals, w.idx, None, bias, w.nm, w.kernel_policy,
                     activation, backend)


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
    Raises the same typed errors as the call. A gather-port weight
    (``w.axis == 1``) is explained as ``indexmac_gather(w, b)`` with B of
    shape ``x_shape`` = (K, N) in ``dtype``."""
    if isinstance(w, (NMWeight, QNMWeight)) and w.axis == 1:
        return explain_gather(x_shape, w, dtype=dtype, backend=backend,
                              device=device)
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
    op, _, ctx = _route(mm, nn, k, w.nm, dtype, pol, be, quantized, device)
    return registry.explain(op, ctx)
