"""Tensor-parallel collectives of the model and the active mesh (port of
``repro.parallel.hints``: ``tp_serving``, ``tp_reduce``, ``tp_context``,
and ``compat.active_mesh``'s role).

The sharded serving engine and the sharded train step run the model
inside ``tp_serving(mesh, tags)``. Two collectives mark the edges of the
regions that a tensor-parallel shard splits over the mesh's "model"
ranks (Megatron's "g" and "f"), each the identity unless its tag is
enabled:

* :func:`tp_reduce` at the row-parallel outputs (``attn_out``,
  ``ffn_down``): the sum of the ranks' partial outputs in the forward,
  the identity in the backward;
* :func:`tp_copy` at the inputs of the column-parallel projections
  (``attn_in``, ``kv_in``, ``ffn_in``; training enables them, see
  ``ServeTPPlan.train_tags``): the identity in the forward, the sum of
  the ranks' partial input gradients in the backward. Without it the
  residual stream's gradient on each rank would hold only its own
  heads' share, and every earlier layer's gradient would be wrong.

Both are ``torch.autograd.Function``s where a gradient is recorded and
plain calls otherwise, so serving runs the same sums as before. The
tags make the placement agree exactly with the slicing the caller did:
a projection whose in axis was not split must not be reduced (each
rank's output is already the whole sum). Outside ``tp_serving`` (one
card, serving or training, expert parallelism) both are the identity.

:func:`mesh_context` makes a :class:`~repro_torch.launch.mesh.ServeMesh`
the active one; :class:`~repro_torch.models.moe.MoE` reads it
(:func:`active_mesh`) and takes the expert-parallel path under it.

The JAX package's ``shard_hint`` (a ``with_sharding_constraint`` under
GSPMD) has no counterpart: there is no GSPMD partitioner here, every
rank holds its slice explicitly and every collective is written out.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

# (mesh, frozenset of enabled tags), set while a sharded step runs
_TP_CTX: list[tuple[object, frozenset]] = []
_MESH: list[object] = []


@contextlib.contextmanager
def tp_serving(mesh, tags):
    """Enable the tensor-parallel collectives named by ``tags`` over
    ``mesh``'s "model" ranks for the enclosed calls."""
    _TP_CTX.append((mesh, frozenset(tags)))
    try:
        yield
    finally:
        _TP_CTX.pop()


def _enabled_mesh(tag: str):
    if not _TP_CTX:
        return None
    mesh, tags = _TP_CTX[-1]
    return mesh if tag in tags else None


def tp_enabled(tag: str) -> bool:
    """Whether ``tag`` is enabled in the active ``tp_serving`` context."""
    return _enabled_mesh(tag) is not None


class _SumOverModel(torch.autograd.Function):
    """g: the sum over "model" forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        y = mesh.all_reduce(x, "model")
        return y if y is not x else x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _CopyToModel(torch.autograd.Function):
    """f: the identity forward, the sum over "model" backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return ctx.mesh.all_reduce(dx.contiguous(), "model"), None


def tp_reduce(x: torch.Tensor, tag: str) -> torch.Tensor:
    """The sum of ``x`` over the "model" ranks iff under ``tp_serving``
    with ``tag`` enabled; ``x`` itself otherwise. Where autograd records
    ``x``, its gradient passes through unchanged."""
    mesh = _enabled_mesh(tag)
    if mesh is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumOverModel.apply(x, mesh)
    return mesh.all_reduce(x, "model")


def tp_copy(x: torch.Tensor, tag: str) -> torch.Tensor:
    """``x`` itself; iff under ``tp_serving`` with ``tag`` enabled and
    autograd records ``x``, its gradient is summed over the "model"
    ranks on the way back."""
    mesh = _enabled_mesh(tag)
    if mesh is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, mesh)


def tp_context() -> Optional[tuple[object, frozenset]]:
    """The active ``tp_serving`` context, or None."""
    return _TP_CTX[-1] if _TP_CTX else None


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` the active mesh for the enclosed calls."""
    _MESH.append(mesh)
    try:
        yield mesh
    finally:
        _MESH.pop()


def active_mesh():
    """The mesh of the innermost ``mesh_context``, or None."""
    return _MESH[-1] if _MESH else None
