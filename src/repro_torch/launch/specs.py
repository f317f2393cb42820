"""Dry-run cells: (arch x shape x mesh) -> one rank's model, state and
step on the meta device, and the cell's analytic MODEL_FLOPS (port of
``repro.launch.specs``).

Nothing is allocated: the rank's shard is made on meta through the
port's own rules, and the step is the one the port runs, so that
:func:`repro_torch.roofline.step_cost.step_cost` counts what that rank
would do.

* **train**: the training plan (``train_tp_plan``) and ``init_sharded``
  (f32 weights, bf16 compute: the JAX package's training dtypes), the
  FSDP or tp_only storage and AdamW's m and v
  (``init_sharded_train_state``), the sharded train step
  (``make_sharded_train_step``) on the whole batch (each rank runs its
  "data" rows), microbatches by the JAX package's rule.
* **prefill / decode**: bf16 weights; a rank serves ``batch / data``
  slots (the ``ShardedServeEngine``'s split; all of them where they do
  not divide, as ``batch_spec`` leaves them whole) with a cache of
  ``seq_len`` positions in ``cache_dtype``. The shard is the serving
  plan's (``serve_tp_plan``: attention and dense FFNs tensor-parallel).
  A decoder that plan refuses (MoE blocks, recurrent mixers, whose state
  has no split in serving) takes the expert-parallel split
  (``init_expert_parallel``: the experts over "model", the rest whole,
  as the deepseek-v2-236b serve); an encoder-decoder the training
  plan's (its cross-attention split as its self-attention). The step is
  ``make_serve_steps``' prefill from 0 or one decode token at offset
  ``seq_len - 1``.

``memory`` holds the rank's ``argument_size_in_bytes``, the sum of its
parameters and buffers, optimizer state, batch and cache (the JAX
``memory_analysis`` field of the same name), and those parts. The JAX
package's temp bytes have no counterpart without running the step on
the card, and are left out.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import ServeMesh
from repro_torch.models.transformer import count_params
from repro_torch.parallel.hints import mesh_context, tp_serving
from repro_torch.parallel.sharding import (
    init_expert_parallel,
    init_sharded,
    serve_tp_plan,
    train_tp_plan,
)
from repro_torch.roofline.analysis import model_flops_for


@dataclasses.dataclass
class Cell:
    name: str
    arch: str
    shape: ShapeConfig
    fn: Callable  # the step: fn(*args) runs it once on meta tensors
    args: tuple
    model_flops: float
    chips: int
    cfg: ModelConfig
    mesh: ServeMesh
    memory: dict = dataclasses.field(default_factory=dict)
    lm: Any = None  # the rank's model


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def model_bytes(lm) -> int:
    """The bytes of a model's parameters and buffers."""
    return _bytes(list(lm.parameters()) + list(lm.buffers()))


def tree_bytes(tree) -> int:
    """The bytes of the tensors in a tree of dicts, lists and tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def microbatches_for(batch: int, data: int, microbatches: int) -> int:
    """The JAX package's microbatch count: at most ``microbatches``, each
    microbatch's rows divisible over the data ranks."""
    mb = max(1, min(microbatches, batch // data))
    while batch % mb or (batch // mb) % data:
        mb -= 1
    return mb


def with_kernels(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with its compressed weights on the kernels' policy (the
    port's main path)."""
    if cfg.sparsity is None:
        return cfg
    return dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, use_kernel=True))


def serve_shard(cfg: ModelConfig, mesh: ServeMesh, dtype=torch.bfloat16):
    """(this rank's serving shard, the contexts its steps run under):
    see the module docstring for the choice of split."""
    try:
        plan = serve_tp_plan(cfg, mesh.model)
    except NotImplementedError:
        plan = None
    if plan is not None:
        lm = init_sharded(cfg, mesh, plan=plan, dtype=dtype)
        return lm, lambda: tp_serving(mesh, plan.reduce_tags)
    if cfg.encoder_plan is None:  # MoE and / or recurrent state: EP
        lm = init_expert_parallel(cfg, mesh, dtype=dtype)
        return lm, lambda: mesh_context(mesh)
    plan = train_tp_plan(cfg, mesh.model)
    lm = init_sharded(cfg, mesh, plan=plan, dtype=dtype)

    @contextlib.contextmanager
    def ctx():
        with tp_serving(mesh, plan.reduce_tags), mesh_context(mesh):
            yield

    return lm, ctx


def make_cell(
    arch: str,
    shape_name: str,
    mesh: ServeMesh,
    *,
    sparse: bool = True,
    sharding_mode: str = "fsdp",
    microbatches: int = 8,
    remat: str = "dots",
    attn_chunk: Optional[int] = None,
    cfg_override: Optional[ModelConfig] = None,
    shape_override: Optional[ShapeConfig] = None,
    cache_dtype=torch.bfloat16,
) -> Cell:
    """One rank's cell (module docstring) on ``mesh`` (a ``MetaMesh``;
    its rank's coordinates pick the shard)."""
    from repro_torch.serving.engine import make_serve_steps
    from repro_torch.training.sharded import (
        init_sharded_train_state,
        make_sharded_train_step,
    )
    from repro_torch.training.train_loop import TrainConfig

    shape = shape_override or SHAPES[shape_name]
    cfg = cfg_override or get_config(arch, sparse=sparse)
    if attn_chunk is not None:
        cfg = dataclasses.replace(cfg, attn_chunk=attn_chunk)
    cfg = with_kernels(cfg)
    chips = mesh.world
    mflops = model_flops_for(cfg, shape, count_params(cfg, active_only=True),
                             count_params(cfg))
    name = (f"{arch}|{shape_name}|{mesh.data}x{mesh.model}"
            f"|{'sparse' if sparse else 'dense'}")
    b, s, dev = shape.global_batch, shape.seq_len, mesh.device
    enc = cfg.encoder_plan is not None

    if shape.kind == "train":
        lm = init_sharded(cfg, mesh, plan=train_tp_plan(cfg, mesh.model),
                          dtype=torch.float32)
        lm.set_compute_dtype(torch.bfloat16)
        tcfg = TrainConfig(microbatches=microbatches_for(
            b, mesh.data, microbatches), remat=remat)
        lm, opt = init_sharded_train_state(lm, tcfg, mesh, sharding_mode)
        step = make_sharded_train_step(lm, tcfg, mesh, sharding_mode)
        batch = {"tokens": torch.empty((b, s), dtype=torch.int32, device=dev),
                 "labels": torch.empty((b, s), dtype=torch.int32,
                                       device=dev)}
        if enc:
            batch["enc_input"] = torch.empty(
                (b, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16,
                device=dev)
        per = b // tcfg.microbatches  # a rank holds its rows of each
        rows = per // mesh.data if per % mesh.data == 0 else per
        local = tree_bytes(batch) * rows // per
        memory = {"params_bytes": model_bytes(lm),
                  "optimizer_bytes": tree_bytes(opt),
                  "batch_bytes": local, "cache_bytes": 0}
        fn, args = step, (lm, opt, batch)
    else:
        lm, ctx = serve_shard(cfg, mesh)
        # the slots split over "data" where they divide (batch_spec), else
        # every data rank serves them all (long_500k's one sequence)
        slots = b // mesh.data if b % mesh.data == 0 else b
        caches = lm.init_cache(slots, s, dtype=cache_dtype)
        prefill, decode = make_serve_steps(lm, graphs=False)
        if shape.kind == "prefill":
            kw = {"tokens": torch.empty((slots, s), dtype=torch.long,
                                        device=dev)}
            if enc:
                kw["enc_input"] = torch.empty(
                    (slots, cfg.encoder_seq, cfg.d_model),
                    dtype=torch.bfloat16, device=dev)
            run = prefill
        else:
            kw = {"tokens": torch.empty((slots, 1), dtype=torch.long,
                                        device=dev), "cache_len": s - 1}
            run = decode

        def fn(caches, kw):
            with torch.inference_mode(), ctx():
                return run(caches, **kw)

        args = (caches, kw)
        memory = {"params_bytes": model_bytes(lm), "optimizer_bytes": 0,
                  "batch_bytes": tree_bytes(kw),
                  "cache_bytes": tree_bytes(caches)}
    memory["argument_size_in_bytes"] = sum(memory.values())
    return Cell(name, arch, shape, fn, args, mflops, chips, cfg, mesh,
                memory, lm)
