"""Mixture-of-Experts with sort-based token dispatch and fixed capacity
(port of the single-device path of ``repro.models.moe``,
``_moe_apply_local``).

Routing follows DeepSeek-V2: a dense f32 router, softmax scores, top-k
selection with no renormalisation, plus ``n_shared`` always-active
shared experts (one FFN of width ``n_shared * d_expert``); the Switch
load-balance loss comes back beside the output when it is asked for (a
serving step does not ask, and runs none of its ops).

Dispatch: the T*k (token, expert) assignments are sorted by expert
(stable), each takes its rank among its expert's assignments, and the
token rows go into an (E, C, D) buffer; an assignment of rank >= C (the
capacity) is dropped. The experts' FFNs run on their C rows, the rows
are gathered back, weighted by the gates and summed over k. Every shape
follows from (T, E, k, C), all known on the host, and no step reads a
value back from the card (no ``.item()``, no boolean-mask indexing):
an overflow is scattered into a spare row C of an (E, C + 1, D) buffer
that is then sliced away, so a step with MoE layers can be captured as a
CUDA graph.

Expert weights are N:M-eligible (target "expert"); the experts are one
:class:`FFN` module each, run in a Python loop over E (the JAX package
runs them as one ``vmap``): 3 E compressed-GEMM launches a layer, at M =
C rows each.

Expert parallelism (port of ``_moe_apply_shard_map``): a module sharded
over a mesh's "model" ranks (:meth:`MoE.shard_`, or ``MoE.init`` with
``experts=``) holds only its rank's E / model experts (``expert_offset``
is the first one's id) and a column / row slice of the shared experts'
FFN. Under an active mesh
(:func:`repro_torch.parallel.hints.mesh_context`) whose "model" size
divides E, ``forward`` routes the tokens it is given
(its data shard's) over all E experts, runs only its own at a capacity
computed from those tokens (GShard groups: drops are per data shard, as
JAX's), sums its partial output with the other "model" ranks'
(``all_reduce``) and averages the aux loss over the "data" ranks. A
sharded module called outside such a mesh raises, and so does a whole
one under it: neither computes a partial or a replicated result quietly.

Under the sharded train step (``training.sharded``: the tags "moe_in"
and "moe_out" of ``parallel.hints.tp_serving``) the same path runs under
autograd: ``tp_copy`` at the input (its gradient summed over "model"),
``tp_reduce`` at the output (the sum over "model" forward, the identity
backward), and the aux comes back as this data shard's own, whole on
every model rank. The router's gradient is the trap: it has a partial
part, through the gate weights of this rank's experts, and a replicated
part, through the aux, which every model rank computes whole. Summing
it over "model" would count the aux's part tp times; not summing it
would miss the other ranks' experts. So the step counts the aux's
gradient on model rank 0 only (the others' backward sees it times 0),
which makes every gradient leaving the MoE a partial sum: the router's
is summed over "model" (``parallel.sharding.model_partial_grads``) and
the input's by the ``tp_copy``. The aux's mean over "data" (JAX's
``pmean``) is the step's too: each data rank's backward takes 1 / data
of its own shard's aux, and the step sums the gradients over "data".
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import FFNConfig, MoEConfig, SparsityConfig
from repro_torch.models.common import Linear, linear_init
from repro_torch.models.ffn import FFN
from repro_torch.parallel.hints import (
    active_mesh,
    tp_copy,
    tp_enabled,
    tp_reduce,
)


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def capacity(tokens: int, cfg: MoEConfig) -> int:
    """Rows of each expert's buffer for ``tokens`` tokens: their even
    share of the T*k assignments times the capacity factor, rounded up
    to a multiple of 8, at least 8."""
    return max(8, _round_up(int(tokens * cfg.top_k / cfg.n_experts
                                 * cfg.capacity_factor), 8))


class MoE(nn.Module):
    """Routed experts plus shared experts; ``forward`` returns (y, aux),
    aux None unless ``with_aux``."""

    def __init__(self, cfg: MoEConfig, router: torch.Tensor,
                 experts: list[FFN], shared: Optional[FFN] = None, *,
                 ep: Optional[tuple[int, int]] = None):
        """``ep`` (rank, ranks): ``experts`` are that rank's E / ranks
        experts and ``shared`` its slice (see :meth:`shard_`)."""
        super().__init__()
        own = _own_experts(cfg.n_experts, *(ep or (0, 1)))
        if len(experts) != len(own):
            raise ValueError(f"{len(experts)} experts for n_experts="
                             f"{cfg.n_experts}"
                             + (f" over {ep[1]} ranks" if ep else ""))
        self.cfg = cfg
        self.router = Linear(router.float())  # dense, computed in f32
        self.experts = nn.ModuleList(experts)
        self.shared = shared
        self.expert_offset = own.start
        self.ep_size = ep[1] if ep else None  # None: the whole layer
        # {tensor name in ``shared``: the dim split over the ranks}
        self.shared_split: dict[str, int] = {}

    @classmethod
    def init(cls, gen: torch.Generator, d_model: int, cfg: MoEConfig, *,
             sp: Optional[SparsityConfig], dtype,
             quantize: Optional[str] = None,
             experts: Optional[tuple[int, int]] = None) -> "MoE":
        """Random weights from ``gen``. ``experts`` (rank, ranks) keeps
        only that rank's E / ranks experts and its slice of the shared
        FFN (:meth:`shard_`): the others are made (the generator runs as
        for the whole layer) and dropped one by one, so the whole layer
        is never held."""
        router = linear_init(gen, d_model, cfg.n_experts, dtype=torch.float32)

        def ffn(width):
            return FFN.init(gen, d_model, FFNConfig(d_ff=width, act=cfg.act),
                            sp=sp, dtype=dtype, target="expert",
                            quantize=quantize)

        own = _own_experts(cfg.n_experts, *(experts or (0, 1)))
        # a meta generator draws nothing: the others need not be made
        made = own if gen.device.type == "meta" else range(cfg.n_experts)
        kept = []
        for e in made:
            f = ffn(cfg.d_expert)
            if e in own:
                kept.append(f)
        shared = ffn(cfg.n_shared * cfg.d_expert) if cfg.n_shared else None
        split = {}
        if experts is not None and shared is not None:
            split = _slice_shared_(shared, *experts)
        moe = cls(cfg, router, kept, shared, ep=experts)
        moe.shared_split = split
        return moe

    def shard_(self, rank: int, ranks: int) -> "MoE":
        """Keep only expert rank ``rank``'s E / ``ranks`` experts and its
        column (w_up, w_gate) / row (w_down) slice of the shared FFN, in
        place; returns the module."""
        if self.ep_size is not None:
            raise ValueError("this MoE is already split over ranks")
        own = _own_experts(self.cfg.n_experts, rank, ranks)
        self.experts = nn.ModuleList([self.experts[e] for e in own])
        if self.shared is not None:
            self.shared_split = _slice_shared_(self.shared, rank, ranks)
        self.expert_offset, self.ep_size = own.start, ranks
        return self

    def route(self, xf: torch.Tensor):
        """(scores (T, E) f32, gate weights (T, k), selected experts (T, k))
        of the flat tokens ``xf`` (T, D)."""
        logits = self.router(xf, compute_dtype=torch.float32)
        scores = torch.softmax(logits, dim=-1)
        gate_w, sel = torch.topk(scores, self.cfg.top_k, dim=-1)
        return scores, gate_w, sel

    def forward(self, x: torch.Tensor, with_aux: bool = True):
        """x (B, S, D) -> (y (B, S, D), aux loss: an f32 scalar, or None
        without ``with_aux``). Under an active mesh whose "model" size
        divides E: the expert-parallel path (module docstring)."""
        mesh = active_mesh()
        split = self.ep_size or 1
        if mesh is not None and self.cfg.n_experts % mesh.model == 0:
            if split != mesh.model:
                raise ValueError(
                    f"an MoE split over {split} rank(s) under a mesh of "
                    f"{mesh.model} model ranks: split it with shard_(rank, "
                    f"{mesh.model}) (or MoE.init(..., experts=)) first")
            return self._forward_ep(x, mesh, with_aux)
        if self.ep_size is not None:
            raise RuntimeError(
                f"this MoE holds {len(self.experts)} of "
                f"{self.cfg.n_experts} experts (split over {split} ranks): "
                "it runs only under a mesh of as many model ranks "
                "(parallel.hints.mesh_context), never as a partial result")
        cfg = self.cfg
        b, s, d = x.shape
        t, k, e = b * s, cfg.top_k, cfg.n_experts
        c = capacity(t, cfg)
        xf = x.reshape(t, d)
        scores, gate_w, sel = self.route(xf)
        order, sorted_e, rank = _sort(sel, e)
        keep = rank < c
        buf = torch.zeros((e, c + 1, d), dtype=x.dtype, device=x.device)
        # an overflow (rank >= c) lands in the spare row c
        buf[sorted_e, rank.clamp(max=c)] = xf[order // k]
        h = torch.stack([ffn(buf[i, :c]) for i, ffn in
                         enumerate(self.experts)])         # (E, C, D)

        out_sorted = torch.where(keep[:, None],
                                 h[sorted_e, rank.clamp(max=c - 1)],
                                 torch.zeros((), dtype=h.dtype,
                                             device=x.device))
        y = _combine(out_sorted, order, gate_w, t, k, d)
        if self.shared is not None:
            y = y + self.shared(xf)
        if not with_aux:
            return y.reshape(b, s, d), None
        return y.reshape(b, s, d), self._aux(scores, sel)

    def _forward_ep(self, x: torch.Tensor, mesh, with_aux: bool):
        """The expert-parallel forward of this rank: ``x`` is its data
        shard's tokens (B_loc, S, D), routed over all E experts; only
        the E_loc own experts run, each on its first C rows at the local
        capacity C = capacity(B_loc * S); the routed and shared partial
        outputs are summed over the "model" ranks, the aux loss averaged
        over the "data" ranks. Under the train step ("moe_out" enabled)
        the sums go through autograd and the aux is this data shard's
        (module docstring). The experts and the shared FFN run without
        the FFN's own collectives (``FFN.partial``)."""
        train = tp_enabled("moe_out")
        if train:
            x = tp_copy(x, "moe_in")
        cfg = self.cfg
        b, s, d = x.shape
        t, k, e = b * s, cfg.top_k, cfg.n_experts
        e_loc, off = len(self.experts), self.expert_offset
        c = capacity(t, cfg)
        xf = x.reshape(t, d)
        scores, gate_w, sel = self.route(xf)
        order, sorted_e, rank = _sort(sel, e)
        local_e = sorted_e - off
        owned = (local_e >= 0) & (local_e < e_loc) & (rank < c)
        # another rank's assignments and overflows land in the spare
        # expert e_loc, row c
        buf = torch.zeros((e_loc + 1, c + 1, d), dtype=x.dtype,
                          device=x.device)
        buf[torch.where(owned, local_e, e_loc),
            torch.where(owned, rank, c)] = xf[order // k]
        h = torch.stack([ffn.partial(buf[i, :c]) for i, ffn in
                         enumerate(self.experts)])         # (E_loc, C, D)
        out_sorted = torch.where(
            owned[:, None],
            h[local_e.clamp(0, e_loc - 1), rank.clamp(max=c - 1)],
            torch.zeros((), dtype=h.dtype, device=x.device))
        y = _combine(out_sorted, order, gate_w, t, k, d)
        if self.shared is not None:  # column / row slice: a partial sum
            y = y + self.shared.partial(xf)
        if train:
            y = tp_reduce(y, "moe_out")
        else:
            y = mesh.all_reduce(y, "model")
        if not with_aux:
            return y.reshape(b, s, d), None
        aux = self._aux(scores, sel)
        if not train:
            aux = mesh.all_reduce(aux, "data") / mesh.data
        return y.reshape(b, s, d), aux

    def _aux(self, scores: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
        """The load-balance loss (Switch): E * sum_e f_e * P_e."""
        cfg, e = self.cfg, self.cfg.n_experts
        one_hot = (sel[..., None] == torch.arange(e, device=sel.device)
                   ).float()
        dispatch_frac = one_hot.sum(1).mean(0) / cfg.top_k
        router_prob = scores.mean(0)
        return cfg.router_aux_coef * e * torch.sum(dispatch_frac
                                                   * router_prob)


def _sort(sel: torch.Tensor, e: int):
    """The sort-based dispatch of the (T, k) selected experts: (order,
    sorted expert ids, each assignment's rank among its expert's)."""
    flat_e = sel.reshape(-1)                               # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(e, device=sel.device, dtype=sorted_e.dtype))
    rank = torch.arange(flat_e.shape[0], device=sel.device) - starts[sorted_e]
    return order, sorted_e, rank


def _combine(out_sorted: torch.Tensor, order: torch.Tensor,
             gate_w: torch.Tensor, t: int, k: int, d: int) -> torch.Tensor:
    """Unsort the (T*k, D) expert outputs and sum each token's k of them,
    weighted by its gates: (T, D)."""
    out_flat = torch.empty_like(out_sorted)
    out_flat[order] = out_sorted
    return (out_flat.reshape(t, k, d)
            * gate_w.to(out_sorted.dtype)[..., None]).sum(dim=1)


def _own_experts(n_experts: int, rank: int, ranks: int) -> range:
    """The expert ids rank ``rank`` of ``ranks`` holds: a contiguous
    E / ranks of them, as the JAX package's ``P("model")`` on E."""
    if n_experts % ranks:
        raise ValueError(f"{n_experts} experts do not split over {ranks} "
                         "ranks")
    per = n_experts // ranks
    return range(rank * per, (rank + 1) * per)


def _slice_shared_(shared: FFN, rank: int, ranks: int) -> dict[str, int]:
    """The shared FFN as tensor-parallel: w_up / w_gate column slices,
    w_down the matching row slice (its output a partial sum). Returns
    {tensor name in ``shared``: the dim it was split on}."""
    from repro_torch.parallel.sharding import slice_linear_

    split = {}
    if ranks == 1:
        return split
    for name, dim in (("w_up", 1), ("w_gate", 1), ("w_down", 0)):
        lin = getattr(shared, name)
        if lin is not None:
            split.update({f"{name}.{k}": d for k, d in slice_linear_(
                lin, dim, rank, ranks, owner=f"shared {name}").items()})
    return split
