"""The cost of one step, counted on meta tensors (the counterpart of the
JAX package's ``roofline.hlo_cost``; its HLO walk has none: the step is
run, not compiled).

``step_cost(fn, *args)`` runs ``fn(*args)`` under a
``TorchDispatchMode`` (:class:`StepCost`) on tensors of the ``meta``
device, so nothing is allocated or computed, and returns

    {"flops", "bytes", "collectives": {kind: bytes},
     "collective_axes": {axis: bytes}, "dispatches": {(op, impl): n},
     "aten_flops", "op_flops"}

FLOPs   aten's products (mm, addmm, bmm, baddbmm, convolution, the SDPA
        family) by ``torch.utils.flop_counter``'s formulas
        (``aten_flops``), plus the port's own ops (``op_flops``, below).
        Elementwise FLOPs are not counted, as in the JAX package.
bytes   the JAX package's output-centric convention: every op's output
        is charged twice (written once, read about once by its
        consumers). Views and reshapes (an op whose output aliases its
        input), and constants (a tensor made from no tensor: ``empty``,
        ``zeros``, ``arange``) are free. An in-place write into a region
        (``index_put_``, ``scatter``, ``copy_``) charges its update, not
        the whole buffer.
ops     the port's own ops, the N:M families (``nm_matmul*``), the
        gather (``indexmac_gather*``) and block-sparse attention
        (``bs_attention``), are charged their ``core.cost_model`` cost
        once a dispatch (the kernel's bytes and its kept non-zeros'
        operations) and nothing inside them is counted: on meta tensors
        the registry runs their meta implementation
        (``registry.meta_observer``), whatever policy but ``off`` says.
        ``dispatches`` counts them by (op, impl). The float N:M
        families' backward (``_NMMatmul.backward``) is plain PyTorch on
        the card too, dense f32 products, so on meta its aten ops run and
        are counted as they are.
colls   the operand bytes of each collective a
        :class:`repro_torch.launch.mesh.MetaMesh` records (every
        collective of the port goes through its mesh), by kind and by
        axis.

A recurrent scan and the train step's microbatch loop run four of
their steps, one charged for the rest
(:meth:`StepCost.weighted`, installed into
:mod:`repro_torch.core.scan`), forward and backward.
"""
from __future__ import annotations

import collections
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.core import cost_model, scan
from repro_torch.kernels import registry

_aten = torch.ops.aten
# in-place writes of a region: the update's bytes, by argument position
_UPDATE_ARG = {
    _aten.index_put_: 2, _aten.index_put: 2, _aten._index_put_impl_: 2,
    _aten.scatter_: 3, _aten.scatter: 3, _aten.scatter_add_: 3,
    _aten.scatter_add: 3, _aten.index_add_: 3, _aten.index_add: 3,
    _aten.index_copy_: 3, _aten.index_copy: 3, _aten.copy_: 1,
}


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _aliases(func) -> bool:
    """Whether ``func``'s output is a view of an input (a free op)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def op_cost(op: str, ctx: dict, args: tuple,
            kwargs: dict) -> cost_model.KernelCost:
    """The ``core.cost_model`` cost of one dispatch of a port op family."""
    if op.startswith("nm_matmul"):
        m, k, n = ctx["shape"]
        x2, vals = args[0], args[1]
        q = op.endswith("_q")
        bias = args[4 if q else 3] if op.startswith("nm_matmul_decode") \
            else None
        fn = cost_model.indexmac_q_cost if q else cost_model.indexmac_cost
        extra = {} if q else {"w_value_bytes": vals.element_size()}
        return fn(m, k, n, ctx["cfg"], dtype_bytes=x2.element_size(),
                  bias_bytes=_nbytes(bias), dtype=x2.dtype, **extra)
    if op.startswith("indexmac_gather"):
        mr, k, nc = ctx["shape"]
        return cost_model.gather_cost(
            mr, k, nc, ctx["cfg"], b_bytes=ctx["dtype"].itemsize,
            w_value_bytes=ctx["vals_dtype"].itemsize,
            quantized=op.endswith("_q"), dtype=ctx["dtype"])
    if op == "bs_attention":
        q, k, v = args[:3]
        b, sq, hq, dk = q.shape
        _, skv, hkv, dv = v.shape
        return cost_model.attention_cost(
            b, sq, hq, dk, skv, hkv, dv, kwargs["plan"],
            dtype_bytes=q.element_size(), dtype=q.dtype)
    raise KeyError(f"no cost model for op {op!r}")


class StepCost(TorchDispatchMode):
    """The running count of :func:`step_cost` (module docstring)."""

    def __init__(self):
        super().__init__()
        self.aten_flops = 0.0
        self.op_flops = 0.0
        self.bytes = 0.0
        self.dispatches: collections.Counter = collections.Counter()
        self.collectives: collections.Counter = collections.Counter()
        self.axes: collections.Counter = collections.Counter()
        self._inside = 0  # > 0 while a port op's meta implementation runs
        self._weights: list[int] = []  # the scans' trip counts, forward
        self._ranges: list[tuple] = []  # (first, end) autograd seq, weight

    # -- the trip counts of the scans -------------------------------------
    def _next_seq(self) -> Optional[int]:
        """The sequence number the next autograd node will take (None
        with grad off)."""
        if not torch.is_grad_enabled():
            return None
        self._inside += 1
        try:
            probe = torch.empty((), device="meta", requires_grad=True) * 1
        finally:
            self._inside -= 1
        return probe.grad_fn._sequence_nr() + 1

    def weighted(self, s: int):
        """Steps 0, 1, s - 2 and s - 1 of a loop of ``s`` > 4
        (``core.scan.scan_steps``), step 1 standing for steps 1 to s - 3: its
        forward and the backward of the nodes it makes are charged s - 3
        times. Step 1 takes a carry and gives one on, as each step
        between does, and its backward runs after a later step's, as
        theirs do: so it holds every gradient the loop's carry passes on
        and every sum of a gradient into a tensor each step reads."""
        yield 0
        first = self._next_seq()
        weight = (s - 3) * self._weight()
        self._weights.append(s - 3)
        try:
            yield 1
        finally:
            self._weights.pop()
            end = self._next_seq()
            if first is not None:
                self._ranges.append((first, end, weight))
        yield s - 2
        yield s - 1

    def _weight(self) -> int:
        """The trips the running op stands for: the loops it runs in, or
        in a backward the loops that made its node (the innermost, which
        holds its outer loops' trips), whichever is more."""
        w = 1
        for s in self._weights:
            w *= s
        node = torch._C._current_autograd_node()
        if node is not None and self._ranges:
            seq = node._sequence_nr()
            for first, end, weight in self._ranges:
                if first <= seq < end:
                    w = max(w, weight)
        return w

    # -- the count ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet not in flop_registry:
            # a composite op (einsum, matmul, reshape under inference
            # mode) counted as its decomposition, as FlopCounterMode does
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self._inside:
            return out
        w = self._weight()
        if packet in flop_registry:
            self.aten_flops += w * flop_registry[packet](*args, **kwargs,
                                                         out_val=out)
        tensors_in = any(isinstance(t, torch.Tensor)
                         for t in tree_leaves((args, kwargs)))
        if packet in _UPDATE_ARG:
            self.bytes += w * 2 * _nbytes(args[_UPDATE_ARG[packet]])
        elif tensors_in and not _aliases(func):
            self.bytes += w * 2 * _nbytes(out)
        return out

    def observe(self, rec, ctx, run: Callable, args: tuple, kwargs: dict):
        """``registry.meta_observer``: run a port op's meta implementation
        uncounted and charge the op its cost model's."""
        self._inside += 1
        try:
            out = run(*args, **kwargs)
        finally:
            self._inside -= 1
        cost = op_cost(rec.op, ctx, args, kwargs)
        w = self._weight()
        self.op_flops += w * cost.flops
        self.bytes += w * cost.hbm_bytes
        self.dispatches[(rec.op, rec.impl)] += w
        return out

    def collective(self, kind: str, axis: str, nbytes: int) -> None:
        """A collective's operand bytes (``MetaMesh``)."""
        w = self._weight()
        self.collectives[kind] += w * nbytes
        self.axes[axis] += w * nbytes

    def result(self) -> dict:
        return {"flops": self.aten_flops + self.op_flops,
                "bytes": self.bytes,
                "collectives": dict(self.collectives),
                "collective_axes": dict(self.axes),
                "dispatches": dict(self.dispatches),
                "aten_flops": self.aten_flops, "op_flops": self.op_flops}


def step_cost(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` (on meta tensors) and return its cost
    (module docstring)."""
    count = StepCost()
    with scan.counting(count), count, registry.meta_observer(count.observe):
        fn(*args, **kwargs)
    return count.result()
