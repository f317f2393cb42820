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
C rows each. The expert-parallel ``shard_map`` path is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import FFNConfig, MoEConfig, SparsityConfig
from repro_torch.models.common import Linear, linear_init
from repro_torch.models.ffn import FFN


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
                 experts: list[FFN], shared: Optional[FFN] = None):
        super().__init__()
        if len(experts) != cfg.n_experts:
            raise ValueError(f"{len(experts)} experts for n_experts="
                             f"{cfg.n_experts}")
        self.cfg = cfg
        self.router = Linear(router.float())  # dense, computed in f32
        self.experts = nn.ModuleList(experts)
        self.shared = shared

    @classmethod
    def init(cls, gen: torch.Generator, d_model: int, cfg: MoEConfig, *,
             sp: Optional[SparsityConfig], dtype,
             quantize: Optional[str] = None) -> "MoE":
        router = linear_init(gen, d_model, cfg.n_experts, dtype=torch.float32)

        def ffn(width):
            return FFN.init(gen, d_model, FFNConfig(d_ff=width, act=cfg.act),
                            sp=sp, dtype=dtype, target="expert",
                            quantize=quantize)

        experts = [ffn(cfg.d_expert) for _ in range(cfg.n_experts)]
        shared = ffn(cfg.n_shared * cfg.d_expert) if cfg.n_shared else None
        return cls(cfg, router, experts, shared)

    def route(self, xf: torch.Tensor):
        """(scores (T, E) f32, gate weights (T, k), selected experts (T, k))
        of the flat tokens ``xf`` (T, D)."""
        logits = self.router(xf, compute_dtype=torch.float32)
        scores = torch.softmax(logits, dim=-1)
        gate_w, sel = torch.topk(scores, self.cfg.top_k, dim=-1)
        return scores, gate_w, sel

    def forward(self, x: torch.Tensor, with_aux: bool = True):
        """x (B, S, D) -> (y (B, S, D), aux loss: an f32 scalar, or None
        without ``with_aux``)."""
        cfg = self.cfg
        b, s, d = x.shape
        t, k, e = b * s, cfg.top_k, cfg.n_experts
        c = capacity(t, cfg)
        xf = x.reshape(t, d)
        scores, gate_w, sel = self.route(xf)

        # sort-based dispatch
        flat_e = sel.reshape(-1)                           # (T*k,)
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        starts = torch.searchsorted(
            sorted_e, torch.arange(e, device=x.device, dtype=sorted_e.dtype))
        rank = torch.arange(t * k, device=x.device) - starts[sorted_e]
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
        out_flat = torch.empty_like(out_sorted)
        out_flat[order] = out_sorted                       # unsort
        y = (out_flat.reshape(t, k, d)
             * gate_w.to(h.dtype)[..., None]).sum(dim=1)
        if self.shared is not None:
            y = y + self.shared(xf)
        if not with_aux:
            return y.reshape(b, s, d), None

        # load-balance aux loss (Switch): E * sum_e f_e * P_e
        one_hot = (sel[..., None] == torch.arange(e, device=x.device)).float()
        dispatch_frac = one_hot.sum(1).mean(0) / k
        router_prob = scores.mean(0)
        aux = cfg.router_aux_coef * e * torch.sum(dispatch_frac * router_prob)
        return y.reshape(b, s, d), aux
