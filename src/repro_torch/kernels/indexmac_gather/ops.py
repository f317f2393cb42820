"""The gather port's op layer (port of ``repro.kernels.indexmac_gather.ops``).

``indexmac_gather(w, b)`` takes an :class:`NMWeight` whose rows are
compressed along axis 1 (the paper's A orientation, C = A @ B) or an
int8 :class:`QNMWeight` with one scale per row; the weight's ``nm``,
policy and *type* drive dispatch, through the same registry as
``nm_matmul``:

  indexmac_gather     float vals: the hand-written kernel
                      ``indexmac_gather`` (impl of the same name) or the
                      plain reference
  indexmac_gather_q   int8 vals: ``indexmac_gather_q`` or ``reference_q``

Policies as for ``nm_matmul``: ``off`` pins the reference; ``force``
takes the kernel or raises :class:`KernelForceError`; ``auto`` is
``force`` on the CUDA backend, and gives a call the kernel cannot take
(its dtypes or its N:M pattern) to the reference only on the CPU
backend. The JAX package sends every shape its TPU tile does not divide
to the reference; the Hopper kernels mask ragged edges, so on the card
every shape runs the kernel. ``explain_gather`` answers which family and
implementation a call would take, running nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.nmweight import KernelPolicy, NMWeight
from repro_torch.core.sparsity import NMConfig
from repro_torch.kernels import registry
from repro_torch.kernels.indexmac.kernel import KERNEL_DTYPES
from repro_torch.kernels.indexmac_gather.kernel import (
    indexmac_gather as _gather_kernel,
)
from repro_torch.kernels.indexmac_gather.kernel import (
    indexmac_gather_q as _gather_q_kernel,
)
from repro_torch.kernels.indexmac_gather.ref import (
    indexmac_gather_q_ref,
    indexmac_gather_ref,
)
from repro_torch.kernels.padding import gather_block, plan_nm_matmul
from repro_torch.quant.qnmweight import QNMWeight

__all__ = ["explain_gather", "indexmac_gather", "indexmac_gather_positional"]


def _route(mr, k, nc, cfg, b_dtype, v_dtype, mode, backend, quantized):
    """Family, kernel geometry and dispatch context of one call, shared by
    :func:`indexmac_gather` and :func:`explain_gather`. On meta (the
    dry-run) the card's checks apply."""
    op = "indexmac_gather_q" if quantized else "indexmac_gather"
    use_kernel = mode != "off"
    plan = None
    if use_kernel:
        plan = plan_nm_matmul(mr, nc, k, cfg, gather_block(cfg, mr, nc))
        typed = b_dtype in KERNEL_DTYPES and (quantized
                                              or v_dtype in KERNEL_DTYPES)
        strict = mode == "force" or backend in ("cuda", "meta")
        if strict and (plan is None or not typed):
            kind = "QNMWeight" if quantized else "NMWeight"
            raise registry.KernelForceError(
                f"KernelPolicy({mode!r}) on backend {backend!r} for a "
                f"{kind} with pattern {cfg.tag}: Mr={mr} K={k} Nc={nc} with "
                f"b in {b_dtype} and vals in {v_dtype} has no gather "
                f"kernel, and the reference may run only under policy "
                f"'off' (or 'auto' on the cpu backend)")
    ctx = registry.make_ctx((mr, k, nc), nm=cfg, use_kernel=use_kernel,
                            plan=plan, dtype=b_dtype, backend=backend)
    ctx["vals_dtype"] = v_dtype
    return op, ctx


def _kernel_supports(ctx: dict) -> Optional[str]:
    if not ctx["use_kernel"]:
        return "use_kernel=False"
    if ctx["plan"] is None:
        return "shape has no kernel geometry"
    if ctx["dtype"] not in KERNEL_DTYPES:
        return f"no kernel build for b in {ctx['dtype']}"
    if ctx["vals_dtype"] not in (torch.int8, *KERNEL_DTYPES):
        return f"no kernel build for vals in {ctx['vals_dtype']}"
    return None


@registry.register("indexmac_gather", "indexmac_gather", priority=100,
                   supports=_kernel_supports, uses_plan=True)
def _run_kernel(vals, idx, b, *, cfg):
    return _gather_kernel(vals, idx, b, cfg)


@registry.register("indexmac_gather", "reference", priority=0)
def _run_ref(vals, idx, b, *, cfg):
    return indexmac_gather_ref(vals, idx, b, cfg)


@registry.register("indexmac_gather_q", "indexmac_gather_q", priority=100,
                   supports=_kernel_supports, uses_plan=True)
def _run_kernel_q(vals, idx, scales, b, *, cfg):
    return _gather_q_kernel(vals, idx, scales, b, cfg)


@registry.register("indexmac_gather_q", "reference_q", priority=0)
def _run_ref_q(vals, idx, scales, b, *, cfg):
    return indexmac_gather_q_ref(vals, idx, scales, b, cfg)


@registry.register_meta("indexmac_gather")
@registry.register_meta("indexmac_gather_q")
def _run_meta(vals, *args, **_):  # the dry-run: C (Mr, Nc) in b's dtype
    b = args[-1]
    return b.new_empty((vals.shape[0], b.shape[1]))


def _check_weight(w, name):
    if not isinstance(w, (NMWeight, QNMWeight)):
        raise TypeError(f"{name} expects an NMWeight or QNMWeight, got "
                        f"{type(w).__name__}")
    if w.axis != 1:
        raise ValueError(
            "the gather port consumes the paper's A-orientation: rows "
            f"compressed along axis 1; got axis={w.axis}")


def _check_k(vals, k: int, cfg: NMConfig) -> None:
    if k % cfg.m or vals.shape[1] * cfg.m != k * cfg.n:
        raise ValueError(f"compressed width {vals.shape[1]} inconsistent "
                         f"with K={k} and {cfg.tag}")


def indexmac_gather(w, b: torch.Tensor, *,
                    backend: Optional[str] = None) -> torch.Tensor:
    """C = densify(w) @ b for a row-compressed A (``w.axis == 1``), in b's
    dtype. An int8 :class:`QNMWeight` routes to the ``indexmac_gather_q``
    family (scales per output row). ``backend`` overrides the policy's
    (``auto``/``cuda``/``cpu``)."""
    _check_weight(w, "indexmac_gather")
    quantized = isinstance(w, QNMWeight)
    k, nc = b.shape
    _check_k(w.vals, k, w.nm)
    pol = w.kernel_policy
    be = registry.resolve_backend(backend or pol.backend, b.device)
    op, ctx = _route(w.vals.shape[0], k, nc, w.nm, b.dtype, w.vals.dtype,
                     pol.mode, be, quantized)
    b = b.contiguous()
    if quantized:
        return registry.dispatch(op, ctx, w.vals, w.idx, w.scales, b,
                                 cfg=w.nm)
    return registry.dispatch(op, ctx, w.vals, w.idx, b, cfg=w.nm)


def explain_gather(b_shape, w, *, dtype=None, backend: Optional[str] = None,
                   device=None) -> registry.DispatchRecord:
    """The :class:`DispatchRecord` ``indexmac_gather(w, b)`` would write
    for a B of shape ``b_shape``, in ``dtype`` (default: the weight's
    value dtype, or f32 for an int8 weight) and on ``device`` (default:
    the weight's), running nothing: the ``w.axis == 1`` arm of
    ``explain_dispatch``. Raises the same typed errors as the call."""
    _check_weight(w, "explain_gather")
    quantized = isinstance(w, QNMWeight)
    k, nc = b_shape
    _check_k(w.vals, k, w.nm)
    device = torch.device(device) if device is not None else w.vals.device
    be = registry.resolve_backend(backend or w.kernel_policy.backend, device)
    dtype = dtype or (torch.float32 if quantized else w.vals.dtype)
    op, ctx = _route(w.vals.shape[0], k, nc, w.nm, dtype, w.vals.dtype,
                     w.kernel_policy.mode, be, quantized)
    return registry.explain(op, ctx)


def indexmac_gather_positional(vals: torch.Tensor, idx: torch.Tensor,
                               b: torch.Tensor, cfg: NMConfig,
                               use_kernel: bool = True) -> torch.Tensor:
    """Positional surface for kernel-level tests: the float family with
    policy ``auto`` (or ``off`` with ``use_kernel=False``)."""
    w = NMWeight(vals, idx, cfg, axis=1,
                 kernel_policy=KernelPolicy("auto" if use_kernel else "off"))
    return indexmac_gather(w, b)
