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

The training plan (:func:`train_tp_plan`, a :class:`ServeTPPlan` with
``shard_ssm`` / ``shard_moe``; one scan, ``_plan``, decides both) adds
what JAX's ``serve_tp_plan`` refuses and its train step splits through
its flat rules: an MoE block's experts over "model" (E / tp a rank,
:meth:`MoE.shard_`, its shared FFN column / row), Mamba's ``d_inner``
(``w_in``'s x and z halves each cut, the rank's slices side by side;
``w_x`` and ``w_out`` row-parallel; ``w_dt``, ``conv_w``, ``conv_b``,
``dt_bias``, ``a_log`` and ``d_skip`` on ``d_inner``), and RWKV's whole
heads under ``shard_attn`` (``w_r`` / ``w_k`` / ``w_v`` / ``w_g``,
``decay_base`` and ``decay_lora_b`` on their out columns, ``bonus`` on
its heads, ``w_o`` row-parallel) with its channel mix under
``shard_ffn`` (``w_cm_k`` column, ``w_cm_v`` row; ``w_cm_r`` stays
whole). :func:`shard_lm_` and :func:`init_sharded` take either plan.
It also takes an encoder-decoder (whisper): the encoder's layers split
as the decoder's, and a cross-attention block's ``wq`` / ``wk`` / ``wv``
/ ``wo`` as its self-attention's (tags "attn_in" / "attn_out"; the
encoder's output, which only the cross blocks read, enters their split
K/V heads under "enc_out"). The serving plan refuses cross-attention
blocks, as JAX's does.

The training rules (the other half of the JAX module) follow them:
:func:`param_specs` (``param_pspecs``: the flat MaxText-style rules,
TP over "model", FSDP over "data", ``tp_only`` dropping "data"),
:func:`batch_spec` / :func:`dp_axes` (``batch_pspec`` / ``dp_axes``,
over "pod" and "data") and :func:`cache_specs` (``cache_pspecs``: the
sequence axis over "model", batch over the data axes). They take a
``mesh_shape`` dict, as JAX's take the mesh's; a spec is a tuple with
one entry a dim: an axis name, a tuple of names (the batch) or None.
The sharded train step (``repro_torch.training.sharded``) splits over
"model" as the training plan does (:func:`shard_lm_` /
:func:`init_sharded` record what they split in ``lm.tp_split``, and
``lm.tp_blocks`` the blocks of a split made of several, as ``w_in``'s
two) and takes from :func:`param_specs` only the dim each trained tensor
splits over "data".
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import (
    AttnConfig,
    FFNConfig,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
)
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
    tags are global, so a half-split plan would double-count.

    ``shard_ssm`` and ``shard_moe`` are the training plan's alone
    (:func:`train_tp_plan`; ``serve_tp_plan`` refuses those blocks):
    Mamba's ``d_inner`` (tags "ssm_in" at ``w_in``'s input, "ssm_x" at
    ``w_x``'s output, summed both ways, "ssm_out" at ``w_out``'s) and the
    experts over "model" ("moe_in" at the MoE's input, "moe_out" at its
    output). In training ``shard_attn`` also covers RWKV's time-mix heads
    and ``shard_ffn`` its channel mix."""

    tp: int
    shard_attn: bool  # wq (+wq_b / w_uk / w_uv) out axis, wo in axis
    shard_kv: bool    # wk / wv out axis and the cache's head axis (GQA)
    shard_ffn: bool   # w_up / w_gate out axis, w_down in axis
    shard_ssm: bool = False  # Mamba's d_inner
    shard_moe: bool = False  # the experts (at tp 1 too: the train step
    #                          runs an MoE through its expert-parallel path)

    @property
    def reduce_tags(self) -> frozenset:
        tags = set()
        if self.shard_attn:
            tags.add("attn_out")
        if self.shard_ffn:
            tags.add("ffn_down")
        if self.shard_ssm:
            tags |= {"ssm_x", "ssm_out"}
        if self.shard_moe:
            tags.add("moe_out")
        return frozenset(tags)

    @property
    def train_tags(self) -> frozenset:
        """The reduce tags and the tags of the inputs of the split regions
        (``parallel.hints.tp_copy``: the identity forward, a sum of the
        gradient over "model" backward), which training needs: "attn_in"
        with the attention split, "kv_in" with the KV heads split too,
        "ffn_in" with the FFN split, "ssm_in" with Mamba's, "moe_in" with
        the experts'; "enc_out" with the KV heads split, at the
        encoder's output (``LM.encode``), whose gradient the cross blocks'
        split K/V projections leave partial."""
        tags = set(self.reduce_tags)
        if self.shard_attn:
            tags.add("attn_in")
        if self.shard_kv:
            tags |= {"kv_in", "enc_out"}
        if self.shard_ffn:
            tags.add("ffn_in")
        if self.shard_ssm:
            tags.add("ssm_in")
        if self.shard_moe:
            tags.add("moe_in")
        return frozenset(tags)


def _attn_split(mx: AttnConfig, tp: int) -> tuple:
    """(shard_attn, shard_kv) of one attention mixer over ``tp`` ranks."""
    q_ok = mx.q_heads % tp == 0
    if mx.kind == "mla":
        return q_ok, False  # the latent ckv / kr cache has no heads
    kv_ok = q_ok and mx.kv_heads % tp == 0
    if q_ok and not kv_ok and mx.kv_heads != 1:
        # q split over replicated KV is sound only for MQA: a rank's
        # contiguous q heads lie in one global KV group, which the local
        # (hkv, g) reshape would not pair them with; attention stays
        # replicated
        q_ok = False
    return q_ok, kv_ok and q_ok


def _plan(cfg: ModelConfig, tp: int, refuse) -> ServeTPPlan:
    """The plan both :func:`serve_tp_plan` and :func:`train_tp_plan`
    decide: each block's families (attention heads, RWKV's heads as
    attention, Mamba's ``d_inner``, a dense FFN's width), the decoder's
    and the encoder's, split where they divide, after ``refuse(blk)``
    raised on the blocks the caller does not take; blocks of one family
    that disagree raise ValueError."""
    fam = {"attn": set(), "kv": set(), "ffn": set(), "ssm": set()}
    moe = False
    for blk in cfg.blocks() + cfg.encoder_blocks():
        refuse(blk)
        mx, mlp = blk.mixer, blk.mlp
        moe = moe or isinstance(mlp, MoEConfig)
        if tp == 1:
            continue
        if isinstance(mx, MambaConfig):
            fam["ssm"].add(mx.expand * cfg.d_model % tp == 0)
        elif isinstance(mx, RWKVConfig):
            fam["attn"].add(cfg.d_model // mx.head_dim % tp == 0)
        else:
            attn, kv = _attn_split(mx, tp)
            fam["attn"].add(attn)
            fam["kv"].add(kv)
        if isinstance(mlp, FFNConfig):
            fam["ffn"].add(mlp.d_ff % tp == 0)
    if tp == 1:
        return ServeTPPlan(1, False, False, False, shard_moe=moe)
    if any(len(f) > 1 for f in fam.values()):
        raise ValueError(
            f"{cfg.name}: plan is not uniformly TP-shardable at tp={tp} "
            "(blocks disagree on head/d_ff/d_inner divisibility); the "
            "global reduce tags cannot represent a mixed plan")
    pick = {k: f.pop() if f else False for k, f in fam.items()}
    return ServeTPPlan(tp, pick["attn"], pick["kv"], pick["ffn"],
                       shard_ssm=pick["ssm"], shard_moe=moe)


def serve_tp_plan(cfg: ModelConfig, tp: int) -> ServeTPPlan:
    """Decide and check the tensor-parallel split for serving ``cfg`` over
    ``tp`` ranks. Supported: attention mixers (GQA, MLA) with a dense FFN
    or no MLP, no cross-attention; an MoE block (expert parallelism is
    its own path) and the recurrent mixers (no head axis in their state)
    raise NotImplementedError, a plan whose blocks disagree ValueError."""

    def refuse(blk):
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

    return _plan(cfg, tp, refuse)


def train_tp_plan(cfg: ModelConfig, tp: int) -> ServeTPPlan:
    """The tensor-parallel split for training ``cfg`` over ``tp`` ranks:
    :func:`serve_tp_plan`'s, in every layer, MoE layers too, with RWKV's
    heads where they divide, Mamba's ``d_inner`` where it divides
    (``shard_ssm``), the experts over the ranks (``shard_moe``), and an
    encoder's layers and cross-attention blocks as the attention and
    FFN families say. An MoE whose experts or shared FFN width do not
    divide over the ranks raises NotImplementedError; blocks of one
    family that disagree ValueError, as in serving."""

    def refuse(blk):
        mlp = blk.mlp
        if isinstance(mlp, MoEConfig):
            shared = mlp.n_shared * mlp.d_expert
            if mlp.n_experts % tp or shared % tp:
                raise NotImplementedError(
                    f"sharded training of {cfg.name}: {mlp.n_experts} "
                    f"experts (shared width {shared}) do not split over "
                    f"{tp} model ranks")

    return _plan(cfg, tp, refuse)


def serve_local_cfg(cfg: ModelConfig, plan: ServeTPPlan) -> ModelConfig:
    """One rank's view of ``cfg``: the attention mixers' head counts
    divided by tp, the decoder's and the encoder's, so that the (B, S, H,
    D) reshapes match the local projections (a cross-attention block's
    take their shape from its mixer's). d_ff, d_inner and RWKV's heads
    need none: those modules take their shapes from their weights."""
    if plan.tp == 1 or not (plan.shard_attn or plan.shard_kv):
        return cfg

    def local(blk):
        mx = blk.mixer
        if not isinstance(mx, AttnConfig):
            return blk
        q = mx.q_heads // plan.tp if plan.shard_attn else mx.q_heads
        kv = (mx.kv_heads // plan.tp
              if plan.shard_kv and mx.kind != "mla" else mx.kv_heads)
        return dataclasses.replace(
            blk, mixer=dataclasses.replace(mx, q_heads=q, kv_heads=kv))

    def local_plan(entries):
        return tuple(
            (tuple(local(b) for b in entry) if isinstance(entry, tuple)
             else local(entry), rep) for entry, rep in entries)

    enc = cfg.encoder_plan
    return dataclasses.replace(
        cfg, plan=local_plan(cfg.plan),
        encoder_plan=local_plan(enc) if enc is not None else None)


def _serve_rule(owner: str, ndim: int, plan: ServeTPPlan) -> tuple:
    # RWKV's w_r / w_k / w_v / w_g, decay_lora_b, decay_base and bonus
    # hold its heads on their out axis (bonus: its first), w_o on its in
    # axis, as the attention's projections do
    if plan.shard_attn and owner in ("wq", "wq_b", "w_r", "w_k", "w_v",
                                     "w_g", "decay_lora_b"):
        return COLUMN
    if plan.shard_attn and owner in ("wo", "w_o", "bonus"):
        return ROW
    if plan.shard_attn and owner in ("w_uk", "w_uv"):
        return ("model", None, None)  # (heads, lora, hd): heads split
    if plan.shard_attn and owner == "decay_base":
        return ("model",)
    if plan.shard_kv and owner in ("wk", "wv"):
        return COLUMN
    if plan.shard_ffn and owner in ("w_up", "w_gate", "w_cm_k"):
        return COLUMN
    if plan.shard_ffn and owner in ("w_down", "w_cm_v"):
        return ROW
    if plan.shard_ssm:
        if owner in ("w_in", "w_dt", "conv_w"):
            return COLUMN
        if owner in ("w_x", "w_out", "a_log"):
            return ROW
        if owner in ("conv_b", "dt_bias", "d_skip"):  # (d_inner,)
            return ("model",)
    return (None,) * max(ndim, 2)  # replicated


def _blocks(owner: str, plan: ServeTPPlan) -> int:
    """The blocks a split dim holds, each cut over the ranks: Mamba's
    ``w_in`` holds the x and z halves on its out axis (a rank keeps
    [x_r | z_r]); every other split is one contiguous block."""
    return 2 if plan.shard_ssm and owner == "w_in" else 1


def _check_nm_row_split(kc: int, n: int, tag: str, owner: str,
                        tp: int) -> None:
    """A row-parallel compressed weight: each rank's slice of vals / idx
    must hold whole N:M groups (idx entries are positions within one)."""
    if kc % tp or (kc // tp) % n:
        raise ValueError(
            f"{owner}: compressed in-axis Kc={kc} ({tag}) does not split "
            f"into tp={tp} shards on group boundaries")


def _fit(spec: tuple, shape: tuple, tp: int, blocks: int = 1) -> tuple:
    """``spec`` padded or trimmed to the rank of ``shape``, with "model"
    dropped where tp (times ``blocks``) does not divide the dim."""
    return _fit_axes(spec, shape, {"model": tp * blocks})


def _linear_specs(lin: Linear, owner: str, plan: ServeTPPlan,
                  rule: Optional[tuple] = None) -> dict:
    """{tensor name: spec} of one Linear (vals / idx / scales or w), by
    its owner's rule unless ``rule`` is given."""
    tp = plan.tp
    rule = rule or _serve_rule(owner, 2, plan)
    blocks = _blocks(owner, plan)
    if lin.nm is not None:
        if lin.axis != 0:
            rule = REPLICATED  # out-axis compression: kept replicated
        elif rule == ROW:
            _check_nm_row_split(lin.vals.shape[-2], lin.nm.n, lin.nm.tag,
                                owner, tp)
        specs = {"vals": _fit(rule, lin.vals.shape, tp, blocks),
                 "idx": _fit(rule, lin.idx.shape, tp, blocks)}
        if lin.quantized:
            out_rule = rule[-1] if lin.axis == 0 else rule[-2]
            specs["scales"] = _fit(tuple(rule[:-2]) + (out_rule,),
                                   lin.scales.shape, tp, blocks)
        return specs
    if lin.mask_nm is not None and rule == ROW:
        k = lin.w.shape[0]
        if k % tp or (k // tp) % lin.mask_nm.m:
            raise ValueError(f"{owner}: masked in-axis K={k} "
                             f"({lin.mask_nm.tag}) does not split into "
                             f"tp={tp} shards on group boundaries")
    return {"w": _fit(rule, lin.w.shape, tp, blocks)}


def _rule_modules(mod):
    """(name, module) of ``mod``'s modules the rules split: an MoE's
    experts and shared FFN are split by the MoE itself
    (:func:`_shard_moe_`), so its subtree is left out."""
    from repro_torch.models.moe import MoE

    skip = []
    for mname, m in mod.named_modules():
        if any(mname.startswith(p) for p in skip):
            continue
        if isinstance(m, MoE):
            skip.append(f"{mname}.")
            continue
        yield mname, m


def serve_param_specs(lm, plan: ServeTPPlan) -> dict[str, tuple]:
    """The rule map of ``lm``'s weights: every parameter and buffer name
    (``lm.named_parameters()`` / ``named_buffers()``) -> its spec, one
    entry a dim, "model" where that dim splits over the ranks, None
    where it is whole. Raises ValueError where a row split would cut an
    N:M group. An MoE's tensors are not in it (the MoE splits itself)."""
    specs: dict[str, tuple] = {}
    for mname, mod in _rule_modules(lm):
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


def _take(t: torch.Tensor, spec: tuple, rank: int, tp: int,
          blocks: int = 1) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec`` (of each of ``blocks``
    equal blocks of the split dim, side by side): its own storage (a
    copy), so that the whole tensor can be freed."""
    for dim, s in enumerate(spec):
        if s == "model":
            if blocks == 1:
                n = t.shape[dim] // tp
                return t.narrow(dim, rank * n, n).clone()
            return torch.cat([_take(b, spec, rank, tp)
                              for b in t.chunk(blocks, dim)], dim)
    return t


def _slice_tensors_(mod: Linear, specs: dict, rank: int, tp: int,
                    blocks: int = 1) -> None:
    def take(t, name):
        return _take(t, specs[name], rank, tp, blocks)

    if mod.nm is not None:
        vals, idx = take(mod.vals.data, "vals"), take(mod.idx, "idx")
        if mod.quantized:
            w = QNMWeight(vals, idx, take(mod.scales, "scales"), mod.nm,
                          mod.axis, mod.kernel_policy)
        else:
            w = NMWeight(vals, idx, mod.nm, mod.axis, mod.kernel_policy)
    elif mod.mask_nm is not None:
        w = MaskedNMWeight(take(mod.w.data, "w"), mod.mask_nm, mod.axis)
    else:
        w = take(mod.w.data, "w")
    mod.hold(w)


def slice_linear_(lin: Linear, dim: int, rank: int, ranks: int, *,
                  owner: str = "linear") -> dict[str, int]:
    """Keep rank ``rank``'s slice of ``lin``'s weight along ``dim`` (0:
    its in axis, a row split; 1: its out axis, a column split), in
    place; a compressed weight's row split must hold whole groups.
    Returns {tensor name: the dim it was split on}."""
    plan = ServeTPPlan(ranks, False, False, True)
    specs = _linear_specs(lin, owner, plan, ROW if dim == 0 else COLUMN)
    main = "vals" if lin.nm is not None else "w"
    if "model" not in specs[main]:
        raise ValueError(f"{owner}: {tuple(getattr(lin, main).shape)} "
                         f"(axis {lin.axis}) does not split over {ranks} "
                         f"ranks on dim {dim}")
    _slice_tensors_(lin, specs, rank, ranks)
    return {leaf: spec.index("model") for leaf, spec in specs.items()
            if "model" in spec}


def _shard_moe_(moe, rank: int, tp: int) -> dict[str, int]:
    """Split an MoE over the ranks in place (:meth:`MoE.shard_`, unless
    it was made split) and return {tensor name in it: the dim split over
    "model"}: its shared FFN's slices (its experts are whole modules of
    their own, see ``training.sharded.TrainLayout``)."""
    if moe.ep_size is None:
        moe.shard_(rank, tp)
    elif moe.ep_size != tp:
        raise ValueError(f"an MoE split over {moe.ep_size} ranks under a "
                         f"tp={tp} plan")
    return {f"shared.{k}": d for k, d in moe.shared_split.items()}


def shard_layer_(layer, plan: ServeTPPlan, rank: int,
                 local_block=None) -> tuple[dict, dict]:
    """Slice one ``TransformerBlock`` in place to rank ``rank``'s shard
    under ``plan`` and give its mixer the local head counts
    (``local_block``, the layer's block of ``serve_local_cfg``). Returns
    ({tensor name in the layer: the dim it was split on}, {name: blocks
    of that split} for those of more than one)."""
    from repro_torch.models.moe import MoE

    if plan.tp == 1:
        return {}, {}
    serve_param_specs(layer, plan)  # every raise before any slicing
    split, blocks = {}, {}
    for mname, mod in _rule_modules(layer):
        if isinstance(mod, Linear):
            owner = mname.rsplit(".", 1)[-1]
            specs = _linear_specs(mod, owner, plan)
            k = _blocks(owner, plan)
            _slice_tensors_(mod, specs, rank, plan.tp, k)
            for leaf, spec in specs.items():
                if "model" in spec:
                    split[f"{mname}.{leaf}"] = spec.index("model")
                    if k > 1:
                        blocks[f"{mname}.{leaf}"] = k
            continue
        for name, p in list(mod.named_parameters(recurse=False)):
            spec = _fit(_serve_rule(name, p.ndim, plan), p.shape, plan.tp)
            if "model" in spec:
                setattr(mod, name, _param(_take(p.data, spec, rank,
                                                plan.tp)))
                split[f"{mname}.{name}" if mname else name] = \
                    spec.index("model")
    if isinstance(layer.mlp, MoE) and plan.shard_moe:
        split.update({f"mlp.{k}": d for k, d in
                      _shard_moe_(layer.mlp, rank, plan.tp).items()})
    if local_block is not None:
        layer.block = local_block
        layer.mixer.cfg = local_block.mixer
        if layer.cross is not None:  # the cross GQA has the mixer's shape
            layer.cross.cfg = local_block.mixer
    return split, blocks


def _layer_splits(split: dict, blocks: dict, name: str, layer_split) -> None:
    """Record one layer's splits under its name in the model
    (``layers.{i}`` or ``enc_layers.{i}``)."""
    s, b = layer_split
    split.update({f"{name}.{k}": d for k, d in s.items()})
    blocks.update({f"{name}.{k}": n for k, n in b.items()})


def shard_lm_(lm, plan: ServeTPPlan, mesh) -> None:
    """Slice ``lm`` in place to this rank's tensor-parallel shard (its
    "model" coordinate on ``mesh``) under a serving or a training plan:
    the layers' projections as :func:`serve_param_specs` says (and a
    training plan's MoE layers expert-parallel), the modules'
    head counts and ``lm.cfg`` as :func:`serve_local_cfg`; sets
    ``lm.tp_plan``, ``lm.tp_split`` ({tensor name: the dim split over
    "model"}) and ``lm.tp_blocks`` ({name: blocks} of the splits made of
    several)."""
    if getattr(lm, "tp_plan", None) is not None:
        raise ValueError("this model is already sharded")
    if mesh.model != plan.tp:
        raise ValueError(f"a tp={plan.tp} plan on a mesh of {mesh.model} "
                         "model ranks")
    serve_param_specs(lm, plan)  # every raise before any slicing
    local = serve_local_cfg(lm.cfg, plan)
    rank = mesh.axis_index("model")
    split, blocks = {}, {}
    for prefix, layers, local_blocks in (
            ("layers", lm.layers, local.blocks()),
            ("enc_layers", lm.enc_layers or (), local.encoder_blocks())):
        for i, (layer, blk) in enumerate(zip(layers, local_blocks)):
            _layer_splits(split, blocks, f"{prefix}.{i}",
                          shard_layer_(layer, plan, rank, blk))
    lm.cfg = local
    lm.tp_plan = plan
    lm.tp_split, lm.tp_blocks = split, blocks


def init_sharded(cfg: ModelConfig, mesh, *, plan: Optional[ServeTPPlan]
                 = None, seed: int = 0, dtype=torch.bfloat16,
                 quantize: Optional[str] = None):
    """This rank's tensor-parallel shard of ``LM.init(cfg, seed=...)``,
    made on ``mesh.device`` a layer at a time, an encoder's layers too:
    each layer is made whole (the generator runs as for the whole
    model), sliced, and its whole weights dropped before the next is
    made; an MoE layer under a training plan is made with only this
    rank's experts (``LM.init(..., experts=)``), never whole. Equal to
    ``shard_lm_(LM.init(cfg, ...), plan, mesh)``."""
    from repro_torch.models.transformer import LM

    plan = plan or serve_tp_plan(cfg, mesh.model)
    local = serve_local_cfg(cfg, plan)
    rank = mesh.axis_index("model")
    split, blocks = {}, {}

    def slicer(prefix, local_blocks):
        def layer_fn(i, layer):
            _layer_splits(split, blocks, f"{prefix}.{i}",
                          shard_layer_(layer, plan, rank, local_blocks[i]))
            return layer
        return layer_fn

    experts = ((rank, plan.tp) if plan.shard_moe
               and plan.tp > 1 else None)
    lm = LM.init(cfg, seed=seed, dtype=dtype, device=mesh.device,
                 quantize=quantize,
                 layer_fn=slicer("layers", local.blocks()),
                 enc_layer_fn=slicer("enc_layers", local.encoder_blocks()),
                 experts=experts)
    lm.cfg = local
    lm.tp_plan = plan
    lm.tp_split, lm.tp_blocks = split, blocks
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


# ---------------------------------------------------------------------------
# training rules (port of ``param_pspecs``, ``cache_pspecs``, ``batch_pspec``
# and ``dp_axes``)
# ---------------------------------------------------------------------------

# GEMM weights by their owner's name: (spec of the in axis, of the out axis)
_COL = ("data", "model")   # column-parallel: out axis = heads / ffn hidden
_ROW = ("model", "data")   # row-parallel: in axis over "model"
_GEMM_RULES: dict[str, tuple] = {
    "wq": _COL, "wk": _COL, "wv": _COL, "wo": _ROW,
    "wq_a": _COL, "wq_b": _COL, "wkv_a": ("data", None),
    "wk_rope": ("data", None),
    "w_up": _COL, "w_gate": _COL, "w_down": _ROW,
    "w_in": _COL, "w_x": _ROW, "w_dt": (None, "model"), "w_out": _ROW,
    "w_r": _COL, "w_k": _COL, "w_v": _COL, "w_g": _COL, "w_o": _ROW,
    "w_cm_k": _COL, "w_cm_v": _ROW, "w_cm_r": _COL,
    "lm_head": _COL,
    "router": (None, None),
}
# other tensors: the whole spec by name (leading axes listed)
_NAMED_RULES: dict[str, tuple] = {
    "embedding": ("model", "data"),       # vocab x d_model
    "pos": (None, "data"),
    "enc_pos": (None, "data"),
    "w_uk": ("model", None, None),        # (heads, lora, hd): heads = TP
    "w_uv": ("model", None, None),
    "conv_w": (None, "model"),
    "a_log": ("model", None),
    "mix_lora_a": ("data", None),
    "mix_lora_b": (None, None, "data"),
    "decay_lora_a": ("data", None),
    "decay_lora_b": (None, "data"),
    "mu": (None, "data"),
    "cm_mu": (None, "data"),
    "bonus": (None, None),
}
MODES = ("fsdp", "tp_only")


def _axis_ok(dim: int, axis, mesh_shape: dict) -> bool:
    if axis is None:
        return True
    size = 1
    for a in (axis,) if isinstance(axis, str) else axis:
        size *= mesh_shape[a]
    return dim % size == 0


def _fit_axes(spec: tuple, shape: tuple, mesh_shape: dict) -> tuple:
    """``spec`` padded or trimmed to the rank of ``shape`` (leading None
    added, leading entries dropped), each axis dropped where its size
    does not divide the dim (JAX's ``_fit``)."""
    spec = tuple(spec)
    if len(spec) < len(shape):
        spec = (None,) * (len(shape) - len(spec)) + spec
    spec = spec[-len(shape):] if len(spec) > len(shape) else spec
    return tuple(s if _axis_ok(d, s, mesh_shape) else None
                 for d, s in zip(shape, spec))


def _adjust_rule(rule: tuple, names: list, mode: str) -> tuple:
    if "experts" in names:  # a leading expert axis over "model" (EP)
        rule = ("model",) + tuple(None if r == "model" else r for r in rule)
    elif "shared" in names:  # the shared experts are pure TP blocks
        rule = tuple(None if r == "data" else r for r in rule)
    if mode == "tp_only":
        rule = tuple(None if r == "data" else r for r in rule)
    return rule


def _train_fit(rule: tuple, shape: tuple, names: list, mesh_shape: dict,
               n_experts: int) -> tuple:
    """The fitted spec of one tensor; an expert's tensor is fitted as the
    JAX package's stacked (E, ...) leaf and its E entry dropped (the
    port holds one module an expert: the E axis's "model" is the
    expert-parallel split of ``MoE.shard_``)."""
    if "experts" in names:
        return _fit_axes(rule, (n_experts,) + tuple(shape), mesh_shape)[1:]
    return _fit_axes(rule, tuple(shape), mesh_shape)


def param_specs(lm, mesh_shape: dict, mode: str = "fsdp") -> dict:
    """The training rule map of ``lm`` (the whole model) on a mesh of
    ``mesh_shape`` ({"data": 4, "model": 2}, optionally "pod"): every
    parameter and buffer name -> its spec, the counterpart of JAX's
    ``param_pspecs(params, mesh, mode)``. Compressed vals and idx share
    the GEMM rule of their owner, an int8 weight's scales follow its out
    axis; ``tp_only`` drops "data"."""
    from repro_torch.models.common import Embedding, LearnedPositions
    from repro_torch.models.moe import MoE

    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    experts = {}
    for mname, mod in lm.named_modules():
        if isinstance(mod, MoE):
            experts[mname] = mod.cfg.n_experts
    specs: dict[str, tuple] = {}
    for mname, mod in lm.named_modules():
        prefix = f"{mname}." if mname else ""
        names = mname.split(".") if mname else []
        owner = names[-1] if names else ""
        n_exp = next((e for m, e in experts.items()
                      if mname.startswith(m + ".experts.")), 1)
        if isinstance(mod, Linear):
            rule = _adjust_rule(_GEMM_RULES.get(owner, _COL), names, mode)
            if mod.nm is not None:
                specs[prefix + "vals"] = _train_fit(
                    rule, mod.vals.shape, names, mesh_shape, n_exp)
                specs[prefix + "idx"] = _train_fit(
                    rule, mod.idx.shape, names, mesh_shape, n_exp)
                if mod.quantized:
                    out = rule[-1] if mod.axis == 0 else rule[-2]
                    specs[prefix + "scales"] = _train_fit(
                        tuple(rule[:-2]) + (out,), mod.scales.shape, names,
                        mesh_shape, n_exp)
            else:
                specs[prefix + "w"] = _train_fit(rule, mod.w.shape, names,
                                                 mesh_shape, n_exp)
            continue
        for name, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            key = name
            if isinstance(mod, Embedding):
                key = "embedding"
            elif isinstance(mod, LearnedPositions):
                key = owner  # "pos" / "enc_pos"
            rule = _NAMED_RULES.get(key, (None,) * t.ndim)
            rule = _adjust_rule(rule, names + [name], mode)
            specs[prefix + name] = _train_fit(rule, t.shape, names,
                                              mesh_shape, n_exp)
    return specs


def dp_axes(mesh_shape: dict) -> tuple[str, ...]:
    """The data-parallel axes of a mesh: "pod" and "data", those it has."""
    return tuple(a for a in ("pod", "data") if a in mesh_shape)


def batch_spec(batch: int, mesh_shape: dict, rank: int = 2) -> tuple:
    """The spec of a (batch, ...) array of ``rank`` dims: the batch axis
    over as many of ("pod", "data") as divide it, in that order (a name,
    a tuple of names, or None), the other dims whole."""
    axes: tuple = ()
    size = 1
    for a in dp_axes(mesh_shape):
        if batch % (size * mesh_shape[a]) == 0:
            axes += (a,)
            size *= mesh_shape[a]
    first = axes[0] if len(axes) == 1 else (axes or None)
    return (first,) + (None,) * (rank - 1)


# cache leaves whose axis after the batch is the sequence (over "model")
_SEQ_CACHE = {"k", "v", "ckv", "kr", "cross_k", "cross_v"}
_CACHE_RANK = {"k": 4, "v": 4, "cross_k": 4, "cross_v": 4, "ckv": 3,
               "kr": 3, "conv": 3, "ssm": 3, "wkv": 4, "tm_last": 2,
               "cm_last": 2}


def _cache_spec(name: str, shape: tuple, mesh_shape: dict,
                batch_axes) -> tuple:
    nd = len(shape)
    spec = [None] * nd
    b = nd - _CACHE_RANK.get(name, nd)  # the batch axis (after a stack)
    if _axis_ok(shape[b], batch_axes, mesh_shape):
        spec[b] = (batch_axes[0] if isinstance(batch_axes, tuple)
                   and len(batch_axes) == 1 else batch_axes)
    if name in _SEQ_CACHE and _axis_ok(shape[b + 1], "model", mesh_shape):
        spec[b + 1] = "model"
    elif name in ("conv", "ssm") and _axis_ok(shape[b + 1], "model",
                                              mesh_shape):
        if name == "ssm":  # Mamba's state: its channel axis over "model"
            spec[b + 1] = "model"
        else:
            spec[b + 2] = ("model" if _axis_ok(shape[b + 2], "model",
                                               mesh_shape) else None)
    return tuple(spec)


def cache_specs(caches, mesh_shape: dict, batch_axes=("data",)):
    """The specs of a decode cache (``LM.init_cache``'s list of one dict
    a layer, or any tree of dicts and lists of tensors), the counterpart
    of ``cache_pspecs``: the batch over ``batch_axes`` where they divide
    it, the sequence axis of K / V (and MLA's latents, the cross K / V)
    over "model", Mamba's channel axis over "model"."""
    if isinstance(caches, dict):
        return {k: (_cache_spec(k, tuple(v.shape), mesh_shape, batch_axes)
                    if isinstance(v, torch.Tensor)
                    else cache_specs(v, mesh_shape, batch_axes))
                for k, v in caches.items()}
    return [cache_specs(c, mesh_shape, batch_axes) for c in caches]


def model_partial_grads(lm) -> list[str]:
    """The names of ``lm``'s replicated parameters whose gradients are
    partial sums over the "model" ranks under its tensor-parallel plan:
    a GQA's ``q_norm`` (applied to the rank's q heads) with the attention
    split, its ``k_norm`` with the KV heads split too; RWKV's
    ``wkv_norm`` (per head, applied to the rank's heads) with its heads
    split; an expert-parallel MoE's router (its gate weights reach the
    rank's own experts only; the aux's share is counted on model rank 0,
    see ``models.moe``)."""
    from repro_torch.models.attention import GQA
    from repro_torch.models.moe import MoE
    from repro_torch.models.rwkv import RWKV

    plan = getattr(lm, "tp_plan", None)
    if plan is None or plan.tp == 1:
        return []
    out = []
    for mname, mod in lm.named_modules():
        if isinstance(mod, GQA):
            if plan.shard_attn and mod.q_norm is not None:
                out.append(f"{mname}.q_norm.scale")
            if plan.shard_kv and mod.k_norm is not None:
                out.append(f"{mname}.k_norm.scale")
        elif isinstance(mod, RWKV) and plan.shard_attn:
            out.append(f"{mname}.wkv_norm.scale")
        elif isinstance(mod, MoE) and plan.shard_moe:
            out.append(f"{mname}.router.w")
    return out
