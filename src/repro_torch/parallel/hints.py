"""Tensor-parallel reduce gates and the active mesh (port of
``repro.parallel.hints``: ``tp_serving``, ``tp_reduce``, ``tp_context``,
and ``compat.active_mesh``'s role).

The sharded serving engine runs each step inside ``tp_serving(mesh,
tags)``; the model's row-parallel projection outputs (``attn_out``,
``ffn_down``) pass through :func:`tp_reduce`, a sum over the mesh's
"model" ranks when the engine sharded that projection on its
contraction axis, the identity everywhere else (single-card serving,
training, expert parallelism). The tags make the reduce placement agree
exactly with the slicing the engine did: a projection whose in-axis was
not split must not be reduced (each rank's output is already the whole
sum).

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

# (mesh, frozenset of enabled reduce tags), set while a sharded serving
# step runs
_TP_CTX: list[tuple[object, frozenset]] = []
_MESH: list[object] = []


@contextlib.contextmanager
def tp_serving(mesh, reduce_tags):
    """Enable the tensor-parallel sums named by ``reduce_tags`` over
    ``mesh``'s "model" ranks for the enclosed calls."""
    _TP_CTX.append((mesh, frozenset(reduce_tags)))
    try:
        yield
    finally:
        _TP_CTX.pop()


def tp_reduce(x: torch.Tensor, tag: str) -> torch.Tensor:
    """The sum of ``x`` over the "model" ranks iff under ``tp_serving``
    with ``tag`` enabled; ``x`` itself otherwise."""
    if not _TP_CTX:
        return x
    mesh, tags = _TP_CTX[-1]
    if tag not in tags:
        return x
    return mesh.all_reduce(x, "model")


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
