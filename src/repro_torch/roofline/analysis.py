"""Roofline terms of a dry-run cell on the card (port of
``repro.roofline.analysis``).

Per (arch x shape x mesh), for one rank:
  compute term    = FLOPs a rank / the dense bf16 peak FLOP/s
  memory term     = bytes a rank / HBM bandwidth
  collective term = sum over mesh axes of the collective operand bytes
                    a rank sends on the axis / the axis's link rate

The counts come from :func:`repro_torch.roofline.step_cost.step_cost`,
one rank's step on meta tensors, in place of the JAX package's compiled
per-device HLO. The rates are spec-sheet values of the NVIDIA H100 80GB
HBM3 (SXM, 700 W), not measurements: the HBM and the dense bf16 peak of
``core.cost_model``; NVLink 4 at 450 GB/s a direction for an axis whose
ranks sit in one 8-GPU node, one 400 Gb/s NDR port a GPU (50 GB/s) for
an axis that spans nodes (the JAX package charged one 50 GB/s ICI link).
Ranks are numbered row-major over (data, model) and fill nodes of 8 in
order.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.cost_model import HBM_BYTES_PER_S, PEAK_OPS_PER_S

PEAK_FLOPS = PEAK_OPS_PER_S[torch.bfloat16]  # dense bf16 a card
NVLINK_BW = 450e9  # NVLink 4, one direction a GPU (spec sheet)
NET_BW = 50e9  # one 400 Gb/s NDR InfiniBand port a GPU (spec sheet)
NODE_GPUS = 8

COLLECTIVES = ("all_reduce", "broadcast", "all_max")


def axis_ranks(mesh_shape: dict, axis: str) -> list[int]:
    """The global ranks of rank 0's group on ``axis`` ("data", "model" or
    "world") of a row-major ``{"data": D, "model": M}`` mesh."""
    d, m = mesh_shape["data"], mesh_shape["model"]
    if axis == "world":
        return list(range(d * m))
    if axis == "model":
        return list(range(m))
    return [i * m for i in range(d)]


def link_bw(mesh_shape: dict, axis: str) -> float:
    """The link rate of ``axis``: NVLink where its ranks share a node,
    the network otherwise."""
    nodes = {r // NODE_GPUS for r in axis_ranks(mesh_shape, axis)}
    return NVLINK_BW if len(nodes) == 1 else NET_BW


@dataclasses.dataclass
class RooflineReport:
    name: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    collective_breakdown: dict  # {kind: operand bytes a rank}
    model_flops: float  # analytic 6ND (or 2ND, decode 2N batch), GLOBAL
    memory: dict  # {"argument_size_in_bytes": ...} a rank
    # {axis: (operand bytes a rank, link B/s)}: the collective term's parts
    collective_axes: dict = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BYTES_PER_S

    @property
    def t_collective(self) -> float:
        return sum(b / bw for b, bw in self.collective_axes.values())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / the ranks' counted FLOPs: what recompute, dense
        backward products and replicated work add."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_frac(self) -> float:
        """The share of the bound the model FLOPs need at peak:
        (model_flops / chips / peak) / t_bound."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops / self.chips / PEAK_FLOPS) / self.t_bound

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flops_frac=self.useful_flops_frac,
                 roofline_frac=self.roofline_frac)
        return d


def analyze(name: str, cost: dict, chips: int, model_flops: float,
            memory: dict, *, mesh_shape: dict | None = None
            ) -> RooflineReport:
    """The report of one rank's ``step_cost`` on a mesh of ``chips``
    ranks (``mesh_shape`` {"data", "model"} gives each axis's link)."""
    colls = {k: float(cost["collectives"].get(k, 0.0)) for k in COLLECTIVES}
    axes = {a: (float(b), link_bw(mesh_shape, a) if mesh_shape else NET_BW)
            for a, b in cost.get("collective_axes", {}).items()}
    return RooflineReport(
        name=name, chips=chips, flops_per_chip=float(cost["flops"]),
        bytes_per_chip=float(cost["bytes"]),
        collective_bytes_per_chip=sum(colls.values()),
        collective_breakdown=colls, model_flops=model_flops,
        memory=dict(memory), collective_axes=axes)


def model_flops_for(cfg, shape, n_params_active: int, n_params_total: int,
                    sparse_density: float = 1.0) -> float:
    """Analytic MODEL_FLOPS of the cell (the JAX package's formulas).

    train:   6 * N_active * tokens     (fwd 2ND + bwd 4ND)
    prefill: 2 * N_active * tokens
    decode:  2 * N_active * batch      (one token per sequence)
    """
    n = n_params_active
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch


def fmt_row(r: RooflineReport) -> str:
    return (f"| {r.name} | {r.chips} | {r.t_compute*1e3:.2f} | "
            f"{r.t_memory*1e3:.2f} | {r.t_collective*1e3:.2f} | "
            f"{r.bottleneck} | {r.useful_flops_frac:.2f} | "
            f"{r.roofline_frac:.2f} |")
