"""The train step over ``torch.distributed`` ranks: data parallelism over
"data", tensor parallelism over "model", FSDP storage (the counterpart
of the JAX package's ``make_train_step`` jitted under ``param_shardings``
and ``batch_pspec``, ``launch/specs.py``).

Each rank of a :class:`~repro_torch.launch.mesh.ServeMesh` holds its
tensor-parallel shard of the model (``parallel.sharding.init_sharded``
or ``shard_lm_`` under the training plan, ``train_tp_plan``: attention,
dense FFNs, Mamba and RWKV tensor-parallel, MoE blocks expert-parallel)
and calls ``make_sharded_train_step(lm, tcfg, mesh, mode)`` on it; the
step has ``train_loop.make_train_step``'s signature and computes the
same function as the JAX step under a ``data x model`` mesh:

* **Rows.** Every rank is given the whole batch. Microbatch i is the
  batch's i-th block of rows, as JAX's reshape makes it, and a rank runs
  its "data" shard of it (``batch_spec``; where the rows do not divide
  over "data", every data rank runs them all and nothing is summed over
  "data"). A rank divides its NLL sum by the whole microbatch's count of
  labels, so the data ranks' sum is the loss of the whole microbatch,
  not a mean of means.
* **Tensor parallelism.** The model runs under ``tp_serving(mesh,
  plan.train_tags)``: the row-parallel outputs are summed over "model"
  in the forward (``tp_reduce``) and the inputs of the split regions in
  the backward (``tp_copy``), so a replicated parameter (norms,
  embedding, head, unsplit projections) gets the whole gradient on
  every model rank; a replicated norm applied inside the rank's heads
  (a GQA's ``q_norm`` / ``k_norm``, RWKV's ``wkv_norm``,
  ``model_partial_grads``) is summed over "model".
* **MoE.** The step runs under the mesh (``mesh_context``), so an MoE
  takes its expert-parallel path: each rank routes its data shard's
  tokens, runs its own experts at the capacity of those tokens (drops
  per data shard) and the outputs are summed over "model". Its load
  balance loss is the data shard's (JAX's per-group aux, ``pmean``'d
  over "data"): the reported aux is the mean over the data ranks, and
  the backward of each rank takes 1 / data of its own shard's aux, on
  model rank 0 only, so that the router's gradient is a partial sum
  like the rest (``models.moe``). A microbatch's loss is its NLL plus
  that aux, the step's the mean of its microbatches'; the parts are the
  last microbatch's. An MoE's experts are whole modules on one model
  rank each (``TrainLayout.experts``).
* **Storage.** ``mode="fsdp"`` splits each trained tensor of the shard
  further over "data", on the dim ``param_specs`` gives "data" (kept
  whole where the rule drops it): between steps the model's parameters,
  the AdamW moments and the error feedback hold those slices. A step
  gathers the parameters (each data rank's slice broadcast to the
  others), runs forward and backward on them, sums the gradients over
  "data" and keeps the rank's slice (gloo has no reduce-scatter on the
  card: with 2 data ranks each sends the other its slice, else an
  all-reduce), then updates the slices. The whole parameters replace the
  slices for the step's forward and backward only (the slices are cut
  back from them after). ``mode="tp_only"`` keeps the shard whole on
  every data rank and sums the gradients over "data". Where the JAX
  flat rules and the head-aware plan disagree on "model" (wk / wv when
  the KV heads do not divide), the plan wins.
* **Clip and compression.** The global norm is over the whole gradient,
  each element counted once (a replicated copy only on the rank at
  coordinate 0 of the axes it is replicated over), and every rank
  applies the same scale. ``grad_compression`` is the JAX function on
  the whole gradient: each leaf's amax is the maximum over the ranks'
  slices.

Every collective goes through the mesh and every rank runs every one,
in the same order. An encoder-decoder (whisper) trains the same way:
the batch's ``enc_input`` rows split over "data" with its ``tokens``,
the encoder's layers and the cross-attention blocks split over "model"
as the decoder's attention and FFNs (``train_tp_plan``), and the
encoder's tensors (``enc_layers.*``, ``enc_pos``) take their "data"
dims from ``param_specs`` like any other.

:func:`save_sharded` writes a sharded state whole in checkpoint format
3, under the single process's leaf names and in its order (each leaf
gathered, every expert under its global id, rank 0 writes);
:func:`train_shardings` gives ``Checkpointer.restore(..., shardings=)``
this rank's regions (an index array where a rank's piece is several
blocks, as Mamba's ``w_in``) and the whole leaf each comes from, so a
run saved at one mesh resumes at another or in one process.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.scan import scan_outputs, scan_steps
from repro_torch.optim.optimizer import adamw_init, adamw_update
from repro_torch.parallel.hints import mesh_context, tp_serving
from repro_torch.parallel.sharding import (
    MODES,
    batch_spec,
    model_partial_grads,
    param_specs,
    train_tp_plan,
)
from repro_torch.training.checkpoint import Region, _walk, weight_meta
from repro_torch.training.train_loop import (
    TrainConfig,
    init_compress_state,
    param_grads,
    trainable,
)


@dataclasses.dataclass(frozen=True)
class TrainLayout:
    """How one rank holds a sharded train state: ``model_dims`` {tensor
    name: the dim split over "model"}, ``model_blocks`` {name: blocks}
    of a split made of several equal blocks, each cut over the ranks
    (Mamba's ``w_in``: x and z), ``data_dims`` {trained name: the dim
    split over "data"} (fsdp), ``partial`` (names whose gradients are
    summed over "model"), ``experts`` {an expert-parallel MoE's module
    name: (its first expert's id, experts here, experts in all)}: an
    expert's tensors are whole on the one model rank holding it, named
    here ``<moe>.experts.<j>`` for the global id ``first + j``; and the
    rank's coordinates."""

    mode: str
    data: int
    model: int
    coords: tuple
    model_dims: dict
    data_dims: dict
    partial: tuple
    model_blocks: dict = dataclasses.field(default_factory=dict)
    experts: dict = dataclasses.field(default_factory=dict)

    def expert(self, name: Optional[str]):
        """(MoE module name, local expert index, the rest of the name)
        of an expert's tensor (or module) ``name``, else None."""
        for moe in self.experts:
            head = f"{moe}.experts."
            if name is not None and name.startswith(head):
                j, rest = name[len(head):].split(".", 1)
                return moe, int(j), rest
        return None

    def global_name(self, name: Optional[str]) -> Optional[str]:
        """``name`` in the whole model: an expert's under its global id."""
        hit = self.expert(name)
        if hit is None:
            return name
        moe, j, rest = hit
        return f"{moe}.experts.{self.experts[moe][0] + j}.{rest}"

    def region(self, name: Optional[str], shape: tuple) -> Region:
        """The whole shape of tensor ``name`` held here in ``shape`` and
        this rank's index into it (the whole of an unnamed leaf; an
        index array on a dim whose piece is several blocks)."""
        full, index = list(shape), [slice(None)] * len(shape)
        dim = self.model_dims.get(name)
        if dim is not None:
            n, k, m = shape[dim], self.model_blocks.get(name, 1), \
                self.coords[1]
            full[dim] = n * self.model
            if k == 1:
                index[dim] = slice(m * n, (m + 1) * n)
            else:  # a rank's width of each block, a block's width
                w, b = n // k, n * self.model // k
                index[dim] = np.concatenate(
                    [np.arange(i * b + m * w, i * b + (m + 1) * w)
                     for i in range(k)])
        dim = self.data_dims.get(name)
        if dim is not None:
            n = shape[dim]
            full[dim] = n * self.data
            index[dim] = slice(self.coords[0] * n, (self.coords[0] + 1) * n)
        return Region(tuple(full), tuple(index))

    def owns(self, name: Optional[str]) -> bool:
        """Whether this rank holds the counted copy of ``name``'s piece:
        coordinate 0 of each axis the tensor is replicated over."""
        return ((name in self.model_dims or self.expert(name) is not None
                 or self.coords[1] == 0)
                and (name in self.data_dims or self.coords[0] == 0))


def _plan(lm):
    """The model's training plan: its shard's, or tp 1's for a whole
    model (which still runs an MoE expert-parallel); raises
    NotImplementedError for what sharded training refuses."""
    whole = train_tp_plan(lm.cfg, 1)  # raises for what training refuses
    return lm.tp_plan or whole


def train_layout(lm, mesh, mode: str = "fsdp") -> TrainLayout:
    """The layout of ``lm`` (this rank's tensor-parallel shard on
    ``mesh``, not yet split over "data") under ``mode``."""
    from repro_torch.models.moe import MoE

    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    plan = _plan(lm)
    if plan.tp != mesh.model:
        raise ValueError(f"a model sharded over {plan.tp} ranks on a mesh "
                         f"of {mesh.model} model ranks (parallel.sharding."
                         "init_sharded / shard_lm_ make the shard)")
    model_dims = dict(getattr(lm, "tp_split", {}) or {})
    data_dims = {}
    if mode == "fsdp" and mesh.data > 1:
        specs = param_specs(lm, {"data": mesh.data, "model": mesh.model},
                            mode)
        for name in trainable(lm):
            if "data" in specs[name]:
                dim = specs[name].index("data")
                if model_dims.get(name) != dim:  # else the plan's wins
                    data_dims[name] = dim
    experts = {name: (mod.expert_offset, len(mod.experts),
                      mod.cfg.n_experts)
               for name, mod in lm.named_modules()
               if isinstance(mod, MoE) and mod.ep_size is not None}
    return TrainLayout(mode, mesh.data, mesh.model, mesh.coords,
                       model_dims, data_dims,
                       tuple(model_partial_grads(lm)),
                       dict(getattr(lm, "tp_blocks", {}) or {}), experts)


def _piece(t: torch.Tensor, layout: TrainLayout, name: str) -> torch.Tensor:
    dim = layout.data_dims[name]
    n = t.shape[dim] // layout.data
    return t.narrow(dim, layout.coords[0] * n, n).clone()


def _gather_data(p: torch.Tensor, layout: TrainLayout, name: str, mesh):
    """The whole shard of a tensor split over "data": each data rank's
    slice broadcast to the others (gloo has no all-gather on the card;
    a sum into a zero-filled buffer would move each byte twice)."""
    dim = layout.data_dims[name]
    shape = list(p.shape)
    n = shape[dim]
    shape[dim] = n * layout.data
    full = torch.empty(shape, dtype=p.dtype, device=p.device)
    for d in range(layout.data):
        piece = p if d == layout.coords[0] else torch.empty_like(p)
        full.narrow(dim, d * n, n).copy_(mesh.broadcast(piece, "data", d))
    return full


def _reduce_data(g: torch.Tensor, layout: TrainLayout, name: str, mesh):
    """This rank's slice of ``g`` summed over "data". With 2 data ranks
    each sends the other its slice of ``g`` (a broadcast each way, half
    the bytes of an all-reduce: gloo has no reduce-scatter on the card);
    else the all-reduce, then the slice."""
    if layout.data != 2:
        return _piece(mesh.all_reduce(g, "data"), layout, name)
    dim, me = layout.data_dims[name], layout.coords[0]
    n = g.shape[dim] // 2
    mine = g.narrow(dim, me * n, n)
    for src in range(2):
        if src == me:
            mesh.broadcast(g.narrow(dim, (1 - me) * n, n), "data", src)
        else:
            theirs = mesh.broadcast(torch.empty_like(
                mine, memory_format=torch.contiguous_format), "data", src)
    return (mine + theirs).contiguous()


@torch.no_grad()
def _split_storage_(lm, layout: TrainLayout) -> None:
    for name, p in trainable(lm).items():
        if name in layout.data_dims:
            p.data = _piece(p.data, layout, name)


def init_sharded_train_state(lm, tcfg: TrainConfig, mesh, mode="fsdp"):
    """(lm, opt_state[, compress_err]) of this rank: in fsdp mode the
    model's trained tensors are cut to their "data" slices in place, and
    the moments (and the error feedback) have the slices' shapes."""
    if getattr(lm, "train_layout", None) is not None:
        raise ValueError("this model already holds a sharded train state")
    layout = train_layout(lm, mesh, mode)
    _split_storage_(lm, layout)
    lm.train_layout = layout
    params = trainable(lm)
    opt_state = adamw_init(params)
    if tcfg.grad_compression:
        return lm, opt_state, init_compress_state(params)
    return lm, opt_state


class ShardedTrainStep:
    """``train_step(lm, opt_state, batch [, compress_err])`` of one rank
    (module docstring); :meth:`loss_and_norm` runs the step's forward
    and backward without the update. ``split`` holds the last step's
    seconds by part: "gather" (the parameters over "data"), "compute"
    (forward and backward, the tensor-parallel sums inside), "reduce"
    (the gradients over "data" and "model"), "update" (norm,
    compression, AdamW), each ended by a synchronize on the card."""

    def __init__(self, lm, tcfg: TrainConfig, mesh, mode: str = "fsdp"):
        self.cfg, self.tcfg, self.mesh, self.mode = lm.cfg, tcfg, mesh, mode
        self.tags = _plan(lm).train_tags
        if getattr(lm, "train_layout", None) is None:
            train_layout(lm, mesh, mode)  # every refusal at build time

    def _layout(self, lm) -> TrainLayout:
        if lm.cfg != self.cfg:
            raise ValueError("train_step runs models of the config it was "
                             "built for")
        layout = getattr(lm, "train_layout", None)
        if layout is None or layout.mode != self.mode or (
                layout.data, layout.model, layout.coords) != (
                self.mesh.data, self.mesh.model, self.mesh.coords):
            raise ValueError("the model holds no sharded train state of "
                             "this step's mesh and mode "
                             "(init_sharded_train_state)")
        return layout

    def _rows(self, n: int):
        """(rows a microbatch, whether they split over "data")."""
        mb = self.tcfg.microbatches
        if n % mb:
            raise ValueError(f"batch of {n} rows does not split into {mb} "
                             "microbatches")
        per = n // mb
        shape = {"data": self.mesh.data, "model": self.mesh.model}
        return per, self.mesh.data > 1 and batch_spec(per, shape)[0] \
            is not None

    def grads(self, lm, batch: dict):
        """(loss, parts, grads) of the whole batch: the gradients summed
        over "data" (and the partial ones over "model") and cut to this
        rank's storage."""
        layout, mesh = self._layout(lm), self.mesh
        params = trainable(lm)
        dev = lm.device
        self.split, self._t = {}, time.perf_counter()
        n = len(batch["tokens"])
        per, split = self._rows(n)
        mb = self.tcfg.microbatches
        local = per // mesh.data if split else per
        start = mesh.coords[0] * local if split else 0
        labels = torch.as_tensor(batch["labels"])
        aux_w = self._aux_weight(split)
        with torch.no_grad():  # gather the data-split tensors; the whole
            for name in layout.data_dims:  # tensor holds the rank's slice
                params[name].data = _gather_data(params[name].data, layout,
                                                 name, mesh)
        self._tick(dev, "gather")
        try:
            acc, nlls, auxes = None, [], []
            with tp_serving(mesh, self.tags), mesh_context(mesh):
                for i in scan_steps(mb, labels):
                    rows = slice(i * per + start, i * per + start + local)
                    part = {k: torch.as_tensor(v[rows]).to(dev)
                            for k, v in batch.items()}
                    count = (labels[i * per:(i + 1) * per] >= 0).sum().to(
                        dev, torch.float32)
                    _, parts = lm.loss(part, remat=self.tcfg.remat,
                                       count=count)
                    g = param_grads(parts["nll"] + parts["aux"] * aux_w,
                                    params)
                    nlls.append(parts["nll"].detach())
                    auxes.append(parts["aux"].detach())
                    if mb == 1:
                        acc = g
                    elif acc is None:
                        acc = {k: v.float() for k, v in g.items()}
                    else:
                        for k, v in g.items():
                            acc[k] += v.float()
        finally:
            with torch.no_grad():  # back to the rank's slices (bit-equal:
                for name in layout.data_dims:  # the sum added zeros)
                    params[name].data = _piece(params[name].data, layout,
                                               name)
        self._tick(dev, "compute")
        if mb > 1:
            acc = {k: v / mb for k, v in acc.items()}
        nll = torch.stack(scan_outputs(nlls, mb))
        aux = torch.stack(scan_outputs(auxes, mb))
        if split:
            nll = mesh.all_reduce(nll, "data")
            aux = mesh.all_reduce(aux, "data") / mesh.data
        grads = {}
        for name in list(acc):
            g = acc.pop(name)  # the whole gradient freed as it is cut
            if split and name in layout.data_dims:
                g = _reduce_data(g, layout, name, mesh)
            else:
                if split:
                    g = mesh.all_reduce(g, "data")
                if name in layout.data_dims:
                    g = _piece(g, layout, name)
            if name in layout.partial:
                g = mesh.all_reduce(g, "model")
            grads[name] = g
        loss = (nll + aux).sum() / mb
        self._tick(dev, "reduce")
        return loss, {"nll": nll[-1], "aux": aux[-1]}, grads

    def _aux_weight(self, split: bool) -> float:
        """The share of its data shard's MoE aux this rank's backward
        takes (module docstring): 1 / data of it (all of it where the
        rows do not split over "data") on model rank 0, none elsewhere."""
        return ((1.0 / self.mesh.data if split else 1.0)
                * (self.mesh.coords[1] == 0))

    def _tick(self, dev, part: str) -> None:
        """Add the seconds since the last tick to ``self.split[part]``
        (the card synchronized first)."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        self.split[part] = self.split.get(part, 0.0) + now - self._t
        self._t = now

    def norm(self, lm, grads: dict) -> torch.Tensor:
        """The global norm of the whole gradient held in slices."""
        layout = self._layout(lm)
        sq = torch.zeros((), dtype=torch.float32, device=lm.device)
        for name, g in grads.items():
            if layout.owns(name):
                sq = sq + torch.sum(torch.square(g.float()))
        return torch.sqrt(self.mesh.all_reduce(sq, "world"))

    def compress(self, grads: dict, err: dict):
        """The int8 error-feedback compression of the whole gradient (the
        JAX ``_compress_tree``), on slices: each leaf's amax over the
        ranks."""
        names = list(grads)
        gf = {n: grads[n].float() + err[n] for n in names}
        amax = torch.stack([gf[n].abs().max() for n in names])
        amax = self.mesh.all_max(amax, "world") + 1e-12
        deq, new_err = {}, {}
        for n, a in zip(names, amax):
            scale = a / 127.0
            q = torch.clamp(torch.round(gf[n] / scale), -127, 127).to(
                torch.int8)
            deq[n] = q.float() * scale
            new_err[n] = gf[n] - deq[n]
        return deq, new_err

    def loss_and_norm(self, lm, batch: dict) -> tuple[float, float]:
        """Step 1's (loss, grad_norm) without an update."""
        loss, _, grads = self.grads(lm, batch)
        return float(loss), float(self.norm(lm, grads))

    def __call__(self, lm, opt_state, batch,
                 compress_err: Optional[dict] = None):
        loss, parts, grads = self.grads(lm, batch)
        new_err = compress_err
        if self.tcfg.grad_compression:
            if compress_err is None:
                raise ValueError("grad_compression needs the error state")
            grads, new_err = self.compress(grads, compress_err)
        gnorm = self.norm(lm, grads)
        _, opt_state, om = adamw_update(self.tcfg.opt, trainable(lm), grads,
                                        opt_state, grad_norm=gnorm)
        self._tick(lm.device, "update")
        metrics = {"loss": loss, **parts, **om}
        if self.tcfg.grad_compression:
            return lm, opt_state, new_err, metrics
        return lm, opt_state, metrics


def make_sharded_train_step(lm, tcfg: TrainConfig, mesh,
                            mode: str = "fsdp") -> ShardedTrainStep:
    """Builds ``train_step(lm, opt_state, batch [, compress_err])`` for
    this rank of ``mesh`` (module docstring); the model and state come
    from :func:`init_sharded_train_state`."""
    return ShardedTrainStep(lm, tcfg, mesh, mode)


def _leaf_name(path: str) -> Optional[str]:
    """The tensor name of a train-state leaf path (``params/<name>``,
    ``opt/m/<name>``, ``opt/v/<name>``), None for ``opt/step``."""
    parts = path.split("/")
    if parts[0] == "params" and len(parts) == 2:
        return parts[1]
    if parts[0] == "opt" and len(parts) == 3 and parts[1] in ("m", "v"):
        return parts[2]
    return None


def _global_path(layout: TrainLayout, path: str) -> str:
    name = _leaf_name(path)
    if name is None:
        return path
    return path[:len(path) - len(name)] + layout.global_name(name)


def train_shardings(lm, opt_state) -> dict:
    """{leaf path: Region} of this rank's state ``{"params": lm, "opt":
    opt_state}``: ``Checkpointer.restore(template, shardings=...)`` loads
    each leaf's region of a whole checkpoint into it, an expert's from
    its global id's leaf (``Region.leaf``)."""
    layout = lm.train_layout
    state = {"params": lm, "opt": opt_state}
    out = {}
    for path, leaf in _walk(state):
        name = _leaf_name(path)
        if not isinstance(leaf, torch.Tensor) or name is None:
            continue
        region = layout.region(name, tuple(leaf.shape))
        if layout.expert(name) is not None:
            region = region._replace(leaf=_global_path(layout, path))
        out[path] = region
    return out


def _global_leaves(layout: TrainLayout, state) -> list:
    """(path in the whole state, path here, the model coordinate holding
    it or None for every one) of each leaf of the single process's state
    ``{"params": lm, "opt": opt_state}``, in its flatten order: each of
    this rank's experts stands for one expert of every model rank (the
    same local index), the module's leaves ordered by global id, the
    moments' dicts by their sorted paths."""
    out, run = [], []

    def flush():
        out.extend(e[:3] for e in sorted(run, key=lambda e: e[3]))
        run.clear()

    for i, (path, _) in enumerate(_walk(state)):
        name = _leaf_name(path)
        hit = layout.expert(name)
        if hit is None:
            flush()
            out.append((path, path, None))
            continue
        moe, j, rest = hit
        per = layout.experts[moe][1]
        for c in range(layout.model):
            g = c * per + j
            whole = path[:len(path) - len(name)] + f"{moe}.experts.{g}.{rest}"
            run.append((whole, path, c, (g, i) if path.startswith("params/")
                        else (whole,)))
    flush()
    return out


def _global_weight_meta(layout: TrainLayout, state) -> dict:
    """``weight_meta`` of the whole state: each expert's under every
    global id its local index stands for."""
    out = {}
    for path, meta in weight_meta(state).items():
        name = _leaf_name(path)
        hit = layout.expert(name)
        if hit is None:
            out[path] = meta
            continue
        moe, j, rest = hit
        per = layout.experts[moe][1]
        for c in range(layout.model):
            out[path[:len(path) - len(name)]
                + f"{moe}.experts.{c * per + j}.{rest}"] = meta
    return out


@torch.no_grad()
def gather_leaf(layout: TrainLayout, mesh, path: str, leaf,
                holder: Optional[int] = None):
    """The whole leaf of ``path`` on the ranks at "data" coordinate 0
    (this rank's tensor-parallel piece elsewhere): each piece in a
    zero-filled buffer of the whole shape, summed over "data" (the
    slices of a split tensor) and then over "model" (the pieces of a
    tensor split over "model"; an expert's leaf broadcast from the model
    rank ``holder``; a leaf whole on every model rank needs neither);
    integers summed as int32."""
    name = _leaf_name(path)
    if not isinstance(leaf, torch.Tensor) or name is None:
        return leaf
    wide = leaf.dtype if leaf.is_floating_point() else torch.int32
    t = leaf.to(wide)
    if name in layout.data_dims:
        t = _gather_data(t, layout, name, mesh)
    if layout.coords[0] != 0:
        return t
    region = layout.region(name, tuple(leaf.shape))
    full = torch.zeros(region.shape, dtype=wide, device=leaf.device)
    index = [torch.as_tensor(i, device=leaf.device)
             if isinstance(i, np.ndarray) else i for i in region.index]
    dim = layout.data_dims.get(name)
    if dim is not None:  # t already holds every data slice
        index[dim] = slice(None)
    if holder is None:
        mine = name in layout.model_dims or layout.coords[1] == 0
    else:
        mine = holder == layout.coords[1]
    if holder is None and name not in layout.model_dims:
        return t.to(leaf.dtype)  # whole on every model rank
    if mine:
        full[tuple(index)] = t
    if holder is not None:
        return mesh.broadcast(full, "model", holder).to(leaf.dtype)
    return mesh.all_reduce(full, "model").to(leaf.dtype)


def save_sharded(ckpt, step: int, lm, opt_state, mesh, *,
                 extra: Optional[dict] = None) -> None:
    """Save this rank's sharded ``{"params": lm, "opt": opt_state}``
    whole as the checkpoint of ``step``: the single process's leaves, by
    its names and in its order; the ranks gather each leaf in that order
    (``gather_leaf``), rank 0 writes, and every rank returns once the
    write is done."""
    layout = lm.train_layout
    state = {"params": lm, "opt": opt_state}
    local = dict(_walk(state))
    # one whole leaf at a time on the card: rank 0 copies each to the
    # host as the writer takes it
    leaves = ((whole, gather_leaf(layout, mesh, path, local[path], holder))
              for whole, path, holder in _global_leaves(layout, state))
    if mesh.rank == 0:
        ckpt.save_leaves(step, leaves, _global_weight_meta(layout, state),
                         extra)
        ckpt.wait()
    else:
        for _ in leaves:
            pass
    mesh.all_reduce(torch.zeros(1, device=lm.device), "world")  # a barrier
