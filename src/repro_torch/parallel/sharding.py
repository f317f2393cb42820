"""Tensor-parallel serving plans and the slicing of a port LM to one
rank's shard (port of the serving half of ``repro.parallel.sharding``:
``ServeTPPlan``, ``serve_tp_plan``, ``serve_local_cfg``, ``_serve_rule``,
``_check_nm_row_split`` and ``serve_param_pspecs``).

Column-parallel projections (wq, wq_b, wk / wv when the KV heads split,
w_up, w_gate) keep their out-axis slice, row-parallel ones (wo, w_down)
their in-axis slice, whose partial outputs the model sums over the
"model" ranks (:func:`repro_torch.parallel.hints.tp_reduce`, tags
``attn_out`` / ``ffn_down``). MLA's per-head up-projections w_uk / w_uv
split on their head axis. Everything else (embedding, norms, the head,
MLA's latent projections) is replicated. The rules are head-aware: a
projection splits only where the head count divides the ranks
(splitting head_dim would scramble the (B, S, H, D) reshapes), and
:func:`serve_local_cfg` gives the modules the divided head counts.

A compressed weight keeps vals, idx and an int8 weight's scales sliced
together; its scales follow the out axis. A weight compressed on its out
axis stays replicated. A row split must land on an N:M group boundary
(idx holds positions within a group), else ``ValueError`` ("group
boundaries"); a masked weight's row split must land on an m-block one.

:func:`serve_param_specs` is the rule map (name -> spec tuple of
"model" / None per dim, the counterpart of ``serve_param_pspecs``),
:func:`shard_lm_` slices a whole model in place, and
:func:`init_sharded` builds a random model a layer at a time, slicing
each before the next is made, so that no rank holds the whole model.
:func:`init_expert_parallel` does the same for expert parallelism (each
MoE layer keeps its rank's experts, everything else replicated).

The training half of the JAX module (FSDP ``param_pspecs``,
``cache_pspecs`` over "pod", ``batch_pspec``) has no counterpart yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig
from repro_torch.core.nmweight import MaskedNMWeight, NMWeight
from repro_torch.models.common import Linear, _param
from repro_torch.quant.qnmweight import QNMWeight

COLUMN = (None, "model")
ROW = ("model", None)
REPLICATED = (None, None)


@dataclasses.dataclass(frozen=True)
class ServeTPPlan:
    """Which projection families split over "model" for a config. Uniform
    over the whole plan (``serve_tp_plan`` raises otherwise): the reduce
    tags are global, so a half-split plan would double-count."""

    tp: int
    shard_attn: bool  # wq (+wq_b / w_uk / w_uv) out axis, wo in axis
    shard_kv: bool    # wk / wv out axis and the cache's head axis (GQA)
    shard_ffn: bool   # w_up / w_gate out axis, w_down in axis

    @property
    def reduce_tags(self) -> frozenset:
        tags = set()
        if self.shard_attn:
            tags.add("attn_out")
        if self.shard_ffn:
            tags.add("ffn_down")
        return frozenset(tags)


def serve_tp_plan(cfg: ModelConfig, tp: int) -> ServeTPPlan:
    """Decide and check the tensor-parallel split for serving ``cfg`` over
    ``tp`` ranks. Supported: attention mixers (GQA, MLA) with a dense FFN
    or no MLP, no cross-attention; an MoE block (expert parallelism is
    its own path) and the recurrent mixers (no head axis in their state)
    raise NotImplementedError, a plan whose blocks disagree ValueError."""
    attn_f: set = set()
    kv_f: set = set()
    ffn_f: set = set()
    for entry, _rep in cfg.plan:
        blocks = entry if isinstance(entry, tuple) else (entry,)
        for blk in blocks:
            mx = blk.mixer
            if not isinstance(mx, AttnConfig) or blk.cross_attn:
                raise NotImplementedError(
                    f"TP serving supports attention-mixer decoder plans; "
                    f"{cfg.name} has {type(mx).__name__}"
                    f"{' + cross_attn' if blk.cross_attn else ''}")
            if isinstance(blk.mlp, MoEConfig):
                raise NotImplementedError(
                    f"TP serving does not support MoE blocks ({cfg.name}):"
                    " the MoE splits its experts itself (expert "
                    "parallelism)")
            if tp == 1:
                continue
            q_ok = mx.q_heads % tp == 0
            if mx.kind == "mla":
                attn_f.add(q_ok)
                kv_f.add(False)  # the latent ckv / kr cache has no heads
            else:
                kv_ok = q_ok and mx.kv_heads % tp == 0
                if q_ok and not kv_ok and mx.kv_heads != 1:
                    # q split over replicated KV is sound only for MQA: a
                    # rank's contiguous q heads lie in one global KV
                    # group, which the local (hkv, g) reshape would not
                    # pair them with; attention stays replicated
                    q_ok = False
                attn_f.add(q_ok)
                kv_f.add(kv_ok and q_ok)
            if blk.mlp is not None:
                ffn_f.add(blk.mlp.d_ff % tp == 0)
    if tp == 1:
        return ServeTPPlan(1, False, False, False)
    if len(attn_f) > 1 or len(kv_f) > 1 or len(ffn_f) > 1:
        raise ValueError(
            f"{cfg.name}: plan is not uniformly TP-shardable at tp={tp} "
            "(blocks disagree on head/d_ff divisibility); the global "
            "reduce tags cannot represent a mixed plan")
    return ServeTPPlan(tp,
                       attn_f.pop() if attn_f else False,
                       kv_f.pop() if kv_f else False,
                       ffn_f.pop() if ffn_f else False)


def serve_local_cfg(cfg: ModelConfig, plan: ServeTPPlan) -> ModelConfig:
    """One rank's view of ``cfg``: head counts divided by tp, so that the
    (B, S, H, D) reshapes of the mixers match the local projections.
    d_ff needs none: the FFN takes its shapes from its weights."""
    if plan.tp == 1 or not (plan.shard_attn or plan.shard_kv):
        return cfg
    new_plan = []
    for entry, rep in cfg.plan:
        blocks = entry if isinstance(entry, tuple) else (entry,)
        nb = []
        for blk in blocks:
            mx = blk.mixer
            q = mx.q_heads // plan.tp if plan.shard_attn else mx.q_heads
            kv = (mx.kv_heads // plan.tp
                  if plan.shard_kv and mx.kind != "mla" else mx.kv_heads)
            nb.append(dataclasses.replace(
                blk, mixer=dataclasses.replace(mx, q_heads=q, kv_heads=kv)))
        new_plan.append(
            (tuple(nb) if isinstance(entry, tuple) else nb[0], rep))
    return dataclasses.replace(cfg, plan=tuple(new_plan))


def _serve_rule(owner: str, ndim: int, plan: ServeTPPlan) -> tuple:
    if plan.shard_attn and owner in ("wq", "wq_b"):
        return COLUMN
    if plan.shard_attn and owner == "wo":
        return ROW
    if plan.shard_attn and owner in ("w_uk", "w_uv"):
        return ("model", None, None)  # (heads, lora, hd): heads split
    if plan.shard_kv and owner in ("wk", "wv"):
        return COLUMN
    if plan.shard_ffn and owner in ("w_up", "w_gate"):
        return COLUMN
    if plan.shard_ffn and owner == "w_down":
        return ROW
    return (None,) * max(ndim, 2)  # replicated


def _check_nm_row_split(kc: int, n: int, tag: str, owner: str,
                        tp: int) -> None:
    """A row-parallel compressed weight: each rank's slice of vals / idx
    must hold whole N:M groups (idx entries are positions within one)."""
    if kc % tp or (kc // tp) % n:
        raise ValueError(
            f"{owner}: compressed in-axis Kc={kc} ({tag}) does not split "
            f"into tp={tp} shards on group boundaries")


def _fit(spec: tuple, shape: tuple, tp: int) -> tuple:
    """``spec`` padded or trimmed to the rank of ``shape``, with "model"
    dropped where tp does not divide the dim."""
    spec = tuple(spec)
    if len(spec) < len(shape):
        spec = (None,) * (len(shape) - len(spec)) + spec
    spec = spec[-len(shape):] if len(spec) > len(shape) else spec
    return tuple(s if s is None or d % tp == 0 else None
                 for d, s in zip(shape, spec))


def _linear_specs(lin: Linear, owner: str, plan: ServeTPPlan,
                  rule: Optional[tuple] = None) -> dict:
    """{tensor name: spec} of one Linear (vals / idx / scales or w), by
    its owner's rule unless ``rule`` is given."""
    tp = plan.tp
    rule = rule or _serve_rule(owner, 2, plan)
    if lin.nm is not None:
        if lin.axis != 0:
            rule = REPLICATED  # out-axis compression: kept replicated
        elif rule == ROW:
            _check_nm_row_split(lin.vals.shape[-2], lin.nm.n, lin.nm.tag,
                                owner, tp)
        specs = {"vals": _fit(rule, lin.vals.shape, tp),
                 "idx": _fit(rule, lin.idx.shape, tp)}
        if lin.quantized:
            out_rule = rule[-1] if lin.axis == 0 else rule[-2]
            specs["scales"] = _fit(tuple(rule[:-2]) + (out_rule,),
                                   lin.scales.shape, tp)
        return specs
    if lin.mask_nm is not None and rule == ROW:
        k = lin.w.shape[0]
        if k % tp or (k // tp) % lin.mask_nm.m:
            raise ValueError(f"{owner}: masked in-axis K={k} "
                             f"({lin.mask_nm.tag}) does not split into "
                             f"tp={tp} shards on group boundaries")
    return {"w": _fit(rule, lin.w.shape, tp)}


def serve_param_specs(lm, plan: ServeTPPlan) -> dict[str, tuple]:
    """The rule map of ``lm``'s weights: every parameter and buffer name
    (``lm.named_parameters()`` / ``named_buffers()``) -> its spec, one
    entry a dim, "model" where that dim splits over the ranks, None
    where it is whole. Raises ValueError where a row split would cut an
    N:M group."""
    specs: dict[str, tuple] = {}
    for mname, mod in lm.named_modules():
        prefix = f"{mname}." if mname else ""
        owner = mname.rsplit(".", 1)[-1]
        if isinstance(mod, Linear):
            for leaf, spec in _linear_specs(mod, owner, plan).items():
                specs[prefix + leaf] = spec
            continue
        for name, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            specs[prefix + name] = _fit(_serve_rule(name, t.ndim, plan),
                                        t.shape, plan.tp)
    return specs


def _take(t: torch.Tensor, spec: tuple, rank: int, tp: int) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec``: its own storage (a
    copy), so that the whole tensor can be freed."""
    for dim, s in enumerate(spec):
        if s == "model":
            n = t.shape[dim] // tp
            return t.narrow(dim, rank * n, n).clone()
    return t


def _slice_tensors_(mod: Linear, specs: dict, rank: int, tp: int) -> None:
    if mod.nm is not None:
        vals = _take(mod.vals.data, specs["vals"], rank, tp)
        idx = _take(mod.idx, specs["idx"], rank, tp)
        if mod.quantized:
            w = QNMWeight(vals, idx, _take(mod.scales, specs["scales"], rank,
                                           tp), mod.nm, mod.axis,
                          mod.kernel_policy)
        else:
            w = NMWeight(vals, idx, mod.nm, mod.axis, mod.kernel_policy)
    elif mod.mask_nm is not None:
        w = MaskedNMWeight(_take(mod.w.data, specs["w"], rank, tp),
                           mod.mask_nm, mod.axis)
    else:
        w = _take(mod.w.data, specs["w"], rank, tp)
    mod.hold(w)


def slice_linear_(lin: Linear, dim: int, rank: int, ranks: int, *,
                  owner: str = "linear") -> None:
    """Keep rank ``rank``'s slice of ``lin``'s weight along ``dim`` (0:
    its in axis, a row split; 1: its out axis, a column split), in
    place; a compressed weight's row split must hold whole groups."""
    plan = ServeTPPlan(ranks, False, False, True)
    specs = _linear_specs(lin, owner, plan, ROW if dim == 0 else COLUMN)
    main = "vals" if lin.nm is not None else "w"
    if "model" not in specs[main]:
        raise ValueError(f"{owner}: {tuple(getattr(lin, main).shape)} "
                         f"(axis {lin.axis}) does not split over {ranks} "
                         f"ranks on dim {dim}")
    _slice_tensors_(lin, specs, rank, ranks)


def shard_layer_(layer, plan: ServeTPPlan, rank: int,
                 local_block=None) -> None:
    """Slice one ``TransformerBlock`` in place to rank ``rank``'s shard
    under ``plan`` and give its mixer the local head counts
    (``local_block``, the layer's block of ``serve_local_cfg``)."""
    if plan.tp == 1:
        return
    serve_param_specs(layer, plan)  # every raise before any slicing
    for mname, mod in layer.named_modules():
        if isinstance(mod, Linear):
            owner = mname.rsplit(".", 1)[-1]
            _slice_tensors_(mod, _linear_specs(mod, owner, plan), rank,
                            plan.tp)
            continue
        for name, p in list(mod.named_parameters(recurse=False)):
            spec = _fit(_serve_rule(name, p.ndim, plan), p.shape, plan.tp)
            if "model" in spec:
                setattr(mod, name, _param(_take(p.data, spec, rank,
                                                plan.tp)))
    if local_block is not None:
        layer.block = local_block
        layer.mixer.cfg = local_block.mixer


def shard_lm_(lm, plan: ServeTPPlan, mesh) -> None:
    """Slice ``lm`` in place to this rank's tensor-parallel shard (its
    "model" coordinate on ``mesh``): the layers' projections as
    :func:`serve_param_specs` says, the modules' head counts and
    ``lm.cfg`` as :func:`serve_local_cfg`; sets ``lm.tp_plan``."""
    if getattr(lm, "tp_plan", None) is not None:
        raise ValueError("this model is already sharded")
    if mesh.model != plan.tp:
        raise ValueError(f"a tp={plan.tp} plan on a mesh of {mesh.model} "
                         "model ranks")
    serve_param_specs(lm, plan)  # every raise before any slicing
    local = serve_local_cfg(lm.cfg, plan)
    rank = mesh.axis_index("model")
    for layer, blk in zip(lm.layers, local.blocks()):
        shard_layer_(layer, plan, rank, blk)
    lm.cfg = local
    lm.tp_plan = plan


def init_sharded(cfg: ModelConfig, mesh, *, plan: Optional[ServeTPPlan]
                 = None, seed: int = 0, dtype=torch.bfloat16,
                 quantize: Optional[str] = None):
    """This rank's tensor-parallel shard of ``LM.init(cfg, seed=...)``,
    made on ``mesh.device`` a layer at a time: each layer is made whole
    (the generator runs as for the whole model), sliced, and its whole
    weights dropped before the next is made. Equal to
    ``shard_lm_(LM.init(cfg, ...), plan, mesh)``."""
    from repro_torch.models.transformer import LM

    plan = plan or serve_tp_plan(cfg, mesh.model)
    local = serve_local_cfg(cfg, plan)
    blocks = local.blocks()
    rank = mesh.axis_index("model")

    def layer_fn(i, layer):
        shard_layer_(layer, plan, rank, blocks[i])
        return layer

    lm = LM.init(cfg, seed=seed, dtype=dtype, device=mesh.device,
                 quantize=quantize, layer_fn=layer_fn)
    lm.cfg = local
    lm.tp_plan = plan
    return lm


def shard_experts_(lm, mesh) -> None:
    """Split every MoE layer of ``lm`` over ``mesh``'s "model" ranks in
    place (:meth:`MoE.shard_`); everything else stays replicated."""
    from repro_torch.models.moe import MoE

    for layer in lm.layers:
        if isinstance(layer.mlp, MoE):
            layer.mlp.shard_(mesh.axis_index("model"), mesh.model)


def init_expert_parallel(cfg: ModelConfig, mesh, *, seed: int = 0,
                         dtype=torch.bfloat16,
                         quantize: Optional[str] = None):
    """This rank's expert-parallel copy of ``LM.init(cfg, seed=...)`` on
    ``mesh.device``: each MoE layer keeps only this rank's E / model
    experts (the others are made and dropped one by one) and its slice
    of the shared FFN; everything else is whole. Equal to
    ``shard_experts_(LM.init(cfg, ...), mesh)``."""
    from repro_torch.models.transformer import LM

    return LM.init(cfg, seed=seed, dtype=dtype, device=mesh.device,
                   quantize=quantize,
                   experts=(mesh.axis_index("model"), mesh.model))
