"""The block-sparse attention op layer (port of
``repro.kernels.blocksparse_attn.ops``): two dispatch families behind
one shared route.

``bs_attention`` (prefill / train shapes: q and k/v cover the same
absolute positions from 0):

  cuda_bs_attention    priority 100, the cuda backend: the hand-written
                       pair-list kernel (:mod:`.kernel`).
  torch_bs_attention   priority 50, the cpu backend: the block-gather
                       lowering (``blocksparse_torch``).
  masked_reference     priority 0: dense ``torch.where``-masked
                       attention, the parity oracle.

``bs_attention_decode`` (cache-view shapes: queries at absolute
positions against a fixed-size cache):

  masked_decode        priority 0: the spec predicate inside the decode
                       softmax, the family's only lowering (as in the
                       JAX package: block skipping buys nothing at Sq in
                       {1, chunk} against a cache view).

Policies: ``off`` pins the dense reference; ``force`` runs the sparse
lowering of the backend or raises :class:`MaskForceError`; ``auto`` is
``force`` on the cuda backend, so the card runs the kernel for every
plan that compiles and raises when the mask does not tile (empty
problem, misaligned tile, a query row with no visible token) or the
call has no kernel build (dtype other than f32 / bf16, dk above 192 or
dv above 128). On the cpu backend ``auto`` routes by the budgets
``REPRO_BS_DENSITY_LIMIT`` / ``REPRO_BS_WASTE_LIMIT`` between the gather
lowering and the dense reference, and gives an untileable mask to the
reference, as the JAX package does. Without a tile the plan takes the
``bs_attn`` family's autotune entry for the call's shape, else (with
``REPRO_AUTOTUNE=1``, and no CUDA graph being captured) a sweep's
winner, else :func:`default_tile` (:mod:`repro_torch.kernels.autotune`).

``explain_dispatch_attention`` shares :func:`_route` with the executing
entries, so the explanation cannot drift from the real routing.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import autotune, registry
from repro_torch.kernels.blocksparse_attn.kernel import (
    MAX_DK,
    MAX_DV,
    has_build,
)
from repro_torch.kernels.blocksparse_attn.kernel import (
    bs_attention as _bs_kernel,
)
from repro_torch.kernels.blocksparse_attn.mask import (
    MaskSpec,
    compile_mask,
    default_tile,
    density_limit,
    waste_limit,
)
from repro_torch.kernels.blocksparse_attn.ref import (
    blocksparse_torch,
    masked_decode,
    masked_reference,
)
__all__ = ["MaskForceError", "bs_attention", "bs_attention_decode",
           "explain_dispatch_attention"]


class MaskForceError(registry.KernelForceError):
    """A forced (or, on the cuda backend, automatic) block-sparse call
    cannot run its sparse lowering: the MaskSpec does not compile to a
    tileable plan for this shape, or the kernel has no build for the
    call. Raised instead of serving the dense path."""


# ---------------------------------------------------------------------------
# supports predicates
# ---------------------------------------------------------------------------


def _cuda_supports(ctx: dict) -> Optional[str]:
    if not ctx["use_kernel"]:
        return "use_kernel=False"
    if ctx["backend"] != "cuda":
        return f"the kernel serves the cuda backend, not {ctx['backend']!r}"
    if ctx["plan"] is None:
        return "mask does not tile"
    if not has_build(ctx["dtype"], ctx["shape"][2], ctx["dv"]):
        return "no kernel build for this dtype and head dims"
    return None


def _torch_supports(ctx: dict) -> Optional[str]:
    if not ctx["use_kernel"]:
        return "use_kernel=False"
    if ctx["backend"] != "cpu":
        return (f"the gather lowering serves the cpu backend, not "
                f"{ctx['backend']!r}")
    plan = ctx["plan"]
    if plan is None:
        return "mask does not tile"
    if ctx["force"]:
        return None
    limit = density_limit()
    if plan.density > limit:
        return (f"block density {plan.density:.2f} > limit {limit:.2f} "
                f"(near-dense mask)")
    wlimit = waste_limit()
    if plan.waste > wlimit:
        return f"block waste {plan.waste:.2f}x > limit {wlimit:.2f}x"
    return None


# ---------------------------------------------------------------------------
# registered implementations
# ---------------------------------------------------------------------------


@registry.register("bs_attention", "cuda_bs_attention", priority=100,
                   supports=_cuda_supports, uses_plan=True)
def _run_kernel(q, k, v, *, spec, plan, scale):
    return _bs_kernel(q, k, v, plan, scale)


@registry.register("bs_attention", "torch_bs_attention", priority=50,
                   supports=_torch_supports, uses_plan=True)
def _run_gather(q, k, v, *, spec, plan, scale):
    return blocksparse_torch(q, k, v, plan=plan, scale=scale)


@registry.register("bs_attention", "masked_reference", priority=0)
def _run_ref(q, k, v, *, spec, plan, scale):
    return masked_reference(q, k, v, spec=spec, scale=scale)


@registry.register_meta("bs_attention")
def _run_meta(q, k, v, **_):  # the dry-run: (B, Sq, Hq, Dv) in q's dtype
    return q.new_empty((*q.shape[:3], v.shape[-1]))


@registry.register("bs_attention_decode", "masked_decode", priority=0)
def _run_decode(q, k, v, *, spec, length, q_positions, scale):
    return masked_decode(q, k, v, spec=spec, length=length,
                         q_positions=q_positions, scale=scale)


# ---------------------------------------------------------------------------
# routing: shape + spec + policy -> family, plan, ctx
# ---------------------------------------------------------------------------


def _route(sq, skv, dk, dv, spec, *, decode, dtype, mode, tile, backend,
           device=None):
    """Family, mask plan and dispatch context of one call, shared by the
    executing entries and :func:`explain_dispatch_attention`. ``backend``
    is the resolved backend (``cuda``, ``cpu`` or ``meta``: the card's
    checks); a call without a tile takes the autotune cache's for
    ``device``'s card, else (and always on meta) the rule's."""
    if not isinstance(spec, MaskSpec):
        raise TypeError(
            f"mask must be a MaskSpec, got {type(spec).__name__}")
    op = "bs_attention_decode" if decode else "bs_attention"
    use_kernel, force = mode != "off", mode == "force"
    plan, notes = None, []
    if not decode and use_kernel:
        if tile is None and backend == "meta":  # the dry-run: the rule's
            tile = default_tile(spec, sq, skv)
        elif tile is None:
            tile = (autotune.best_attn_tile(sq, skv, dk, spec, dtype,
                                            dv=dv, device=device,
                                            notes=notes)
                    if sq > 0 and skv > 0 and has_build(dtype, dk, dv)
                    else default_tile(spec, sq, skv))
        plan = compile_mask(spec, sq, skv, tuple(tile))
        why = None
        if plan is None and (force or backend in ("cuda", "meta")):
            why = ("does not compile to a tileable block plan (empty "
                   "problem, misaligned tile, or a query row with zero "
                   "visible tokens)")
        elif backend in ("cuda", "meta") and not has_build(dtype, dk, dv):
            why = (f"has no kernel build for {dtype} with dk={dk} dv={dv} "
                   f"(f32 or bf16, dk up to {MAX_DK}, dv up to {MAX_DV})")
        if why is not None:
            raise MaskForceError(
                f"KernelPolicy({mode!r}) on backend {backend!r} with mask "
                f"{spec.tag}: Sq={sq} Skv={skv} {why}, and the dense "
                f"reference may run only under policy 'off' (or 'auto' on "
                f"the cpu backend)")
    ctx = registry.make_ctx((sq, skv, dk), nm=spec, use_kernel=use_kernel,
                            plan=plan, dtype=dtype, backend=backend)
    ctx.update(force=force, dv=dv, note="; ".join(notes))
    return op, plan, ctx


def _resolve(policy, backend: Optional[str], device) -> tuple[str, str]:
    """(mode, resolved backend) from a mode string or a KernelPolicy."""
    mode, pol_backend = "auto", None
    if isinstance(policy, str):
        mode = policy
    elif policy is not None:  # KernelPolicy duck-type
        mode, pol_backend = policy.mode, policy.backend
    if mode not in ("off", "auto", "force"):
        raise ValueError(
            f"policy mode must be 'off' | 'auto' | 'force', got {mode!r}")
    return mode, registry.resolve_backend(backend or pol_backend,
                                          torch.device(device))


# ---------------------------------------------------------------------------
# typed entry points
# ---------------------------------------------------------------------------


def bs_attention(q, k, v, *, spec: MaskSpec, scale=None, policy="auto",
                 backend=None, tile=None):
    """Block-sparse prefill attention: q (B, Sq, Hq, Dk) and k/v
    (B, Skv, Hkv, D*) share absolute positions from 0."""
    _check_shapes(q, k, v)
    mode, be = _resolve(policy, backend, q.device)
    op, plan, ctx = _route(
        q.shape[1], k.shape[1], q.shape[-1], v.shape[-1], spec,
        decode=False, dtype=q.dtype, mode=mode, tile=tile, backend=be,
        device=q.device)
    return registry.dispatch(op, ctx, q, k, v, spec=spec, plan=plan,
                             scale=scale)


def bs_attention_decode(q, k, v, *, spec: MaskSpec, length,
                        q_positions=None, scale=None, policy="auto",
                        backend=None):
    """Mask-aware decode / chunk attention against a fixed-size cache
    view; ``length`` is the valid cache extent, ``q_positions`` the
    queries' absolute positions (chunk mode)."""
    _check_shapes(q, k, v)
    mode, be = _resolve(policy, backend, q.device)
    op, _, ctx = _route(
        q.shape[1], k.shape[1], q.shape[-1], v.shape[-1], spec,
        decode=True, dtype=q.dtype, mode=mode, tile=None, backend=be)
    return registry.dispatch(op, ctx, q, k, v, spec=spec, length=length,
                             q_positions=q_positions, scale=scale)


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"attention expects (B, S, H, D) operands, got q{tuple(q.shape)} "
            f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"Hq={q.shape[2]} must be a multiple of Hkv={k.shape[2]}")
    if k.shape[1] != v.shape[1] or k.shape[2] != v.shape[2]:
        raise ValueError(
            f"k/v sequence+head mismatch: k{tuple(k.shape)} "
            f"v{tuple(v.shape)}")


def explain_dispatch_attention(q_shape, kv_shape, *, mask: MaskSpec,
                               decode: bool = False, dtype=torch.float32,
                               policy="auto", backend=None, tile=None,
                               device=None, dv: Optional[int] = None
                               ) -> registry.DispatchRecord:
    """The :class:`DispatchRecord` ``bs_attention`` (or the decode family,
    with ``decode=True``) would write for operands of these shapes (v
    shaped as k, with ``dv`` dims where given) on ``device``, running
    nothing. ``device`` defaults to
    the named backend's device, else the card. Raises the same typed
    errors as the call, :class:`MaskForceError` included."""
    sq = q_shape[1] if len(q_shape) == 4 else q_shape[0]
    skv = kv_shape[1] if len(kv_shape) == 4 else kv_shape[0]
    if device is None:
        device = backend if backend in ("cuda", "cpu") else "cuda"
    mode, be = _resolve(policy, backend, device)
    op, _, ctx = _route(
        sq, skv, q_shape[-1], kv_shape[-1] if dv is None else dv, mask,
        decode=decode,
        dtype=dtype, mode=mode, tile=tile, backend=be, device=device)
    return registry.explain(op, ctx)
