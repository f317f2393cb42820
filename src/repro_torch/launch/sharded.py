"""Rank functions of the multi-rank paths: what each rank of a
``launch.mesh.spawn`` runs. They live in the package (a spawned process
imports its function by name) and return plain numpy and Python values.

* :func:`serve_rank`: cases served through ``ShardedServeEngine``, each
  on a model this rank builds (the whole model from numpy weights or a
  seed, sliced by the engine; or its shard made a layer at a time by
  ``init_sharded``): the streams, the last-position logits of a prefill
  (summed over "data" to the whole batch), the dispatch and launch
  counts of the serve, the engine's step calls, the page groups and
  prefix hits, the serve's metrics and peak memory.
* :func:`ep_rank`: an LM forward under expert parallelism
  (``mesh_context``): a prefill and decode steps on this rank's data shard,
  the logits and aux loss back whole, the launches of each call, each
  MoE layer's dropped assignments.
* :func:`moe_rank`: one ``MoE`` split over the ranks, on this rank's
  data shard of an input: y (whole) and the aux loss.
* :func:`cases_rank`: ``ep_rank`` / ``moe_rank`` cases on every mesh of
  one world size (1x4 and 2x2 in one spawn).
* :func:`train_rank`: training cases through the sharded train step
  (``training.sharded``) on this rank's shard: each step's metrics and
  seconds, the launches, peak memory, and this rank's state or its
  distance from a whole checkpoint; a case may save the state whole or
  resume from a checkpoint saved at another mesh.
* :func:`make_shardwise_train_step`: the single process's oracle of a
  ``data x model`` step with an MoE: each data shard's rows run on
  their own (the MoE's capacity and aux per shard), as the sharded step
  computes them.
* :func:`ping`: one ``all_reduce`` of each axis (a mesh's smoke test).
"""
from __future__ import annotations

import functools
import gc
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.launch.mesh import ServeMesh, local_rows, make_serve_mesh

def ping(mesh: ServeMesh) -> dict:
    """Each axis's sum of (rank + 1): checks the groups and coordinates."""
    x = torch.full((2,), float(mesh.rank + 1), device=mesh.device)
    return {"coords": mesh.coords, "device": str(mesh.device),
            **{ax: float(mesh.all_reduce(x, ax)[0])
               for ax in ("data", "model", "world")}}


def kernel_counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels.blocksparse_attn import kernel as attn
    from repro_torch.kernels.indexmac import decode_kernel, kernel
    from repro_torch.kernels.indexmac_gather import kernel as gather

    return {k.name: k for k in (kernel.KERNEL, kernel.KERNEL_Q,
                                decode_kernel.KERNEL, decode_kernel.KERNEL_Q,
                                gather.KERNEL, gather.KERNEL_Q, attn.KERNEL)}


def zero_counts() -> dict:
    """Clear the dispatch counters and every kernel's launch count;
    returns the kernels by name."""
    from repro_torch.kernels import registry

    registry.clear_history()
    kernels = kernel_counters()
    for kern in kernels.values():
        kern.reset()
    return kernels


def read_counts(kernels: dict) -> dict:
    """{"dispatches": {(op, impl, backend): n}, "launches": {kernel: n}}."""
    from repro_torch.kernels import registry

    return {"dispatches": dict(registry.dispatch_counts()),
            "launches": {n: k.launches for n, k in kernels.items()}}


def compressed_linears(lm) -> int:
    """Compressed Linear modules of ``lm``: a step launches one N:M GEMM
    for each."""
    from repro_torch.models.common import Linear

    return sum(1 for m in lm.modules()
               if isinstance(m, Linear) and m.nm is not None)


def _peak(dev) -> Optional[int]:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None


def _model(mesh: ServeMesh, case: dict):
    """The rank's model of ``case``: from numpy weights (``tree``,
    interop) or ``seed``; whole (the engine slices it) unless
    ``shard_init`` (``init_sharded``, a layer at a time)."""
    from repro_torch.interop import lm_from_jax
    from repro_torch.models.transformer import LM
    from repro_torch.parallel.sharding import init_sharded

    cfg, dtype = case["cfg"], case.get("dtype", torch.float32)
    if case.get("tree") is not None:
        return lm_from_jax(cfg, case["tree"], dtype=dtype,
                           device=mesh.device)
    if case.get("shard_init"):
        return init_sharded(cfg, mesh, seed=case.get("seed", 0), dtype=dtype,
                            quantize=case.get("quantize"))
    return LM.init(cfg, seed=case.get("seed", 0), dtype=dtype,
                   device=mesh.device)


def prefill_logits(lm, mesh: ServeMesh, tokens: np.ndarray,
                   tags=frozenset()) -> np.ndarray:
    """Last-position logits (B, V) of a prefill of ``tokens`` (B, S),
    this rank running its data shard of the rows under ``tp_serving``,
    summed over "data" into the whole batch."""
    from repro_torch.models.cache import CacheView
    from repro_torch.parallel.hints import tp_serving

    b, s = tokens.shape
    rows = local_rows(mesh, b)
    toks = torch.as_tensor(tokens[rows], device=mesh.device)
    with torch.inference_mode(), tp_serving(mesh, tags):
        cache = lm.init_cache(toks.shape[0], s)
        out = lm(toks, view=CacheView.prefill(), caches=cache,
                 last_only=True)[0][:, -1]
        full = torch.zeros((b, out.shape[-1]), dtype=out.dtype,
                           device=out.device)
        full[rows] = out
        full = mesh.all_reduce(full, "data")
    return full.float().cpu().numpy()


def serve_rank(mesh: ServeMesh, cases: list) -> list:
    """Serve each case through ``ShardedServeEngine`` (module
    docstring). A case: ``cfg``, ``dtype``, ``tree`` or ``seed``,
    ``shard_init``, ``quantize``, ``engine`` (its keyword arguments:
    slots, max_seq, prefill_len, prefill_chunk, paged, temperature,
    seed, ...), ``prompts`` (arrays), ``max_new`` (ints), and
    ``logits_prompts`` ((B, S) array or None). ``witness`` (toks, feed)
    numpy also returns the logits of ``launch.witness.witness_calls``
    on them."""
    from repro_torch.core.dots import strict_f32
    from repro_torch.serving.engine import Request, ShardedServeEngine

    strict_f32()
    out = []
    for case in cases:
        t0 = time.perf_counter()
        lm = _model(mesh, case)
        built_s = time.perf_counter() - t0
        if mesh.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(mesh.device)
        kernels = zero_counts()
        eng = ShardedServeEngine(
            lm, mesh=mesh, quantize=None if case.get("shard_init")
            else case.get("quantize"), **case["engine"])
        t0 = time.perf_counter()
        for i, (p, n) in enumerate(zip(case["prompts"], case["max_new"])):
            eng.submit(Request(rid=i, prompt=np.asarray(p, np.int32),
                               max_new=int(n)))
        done = eng.run()
        serve_s = time.perf_counter() - t0
        counts = read_counts(kernels)
        res = {
            "streams": {r.rid: list(map(int, r.out)) for r in done},
            "counts": counts, "step_calls": dict(eng.step_calls),
            "linears": compressed_linears(lm),
            "plan": (eng.tp_plan.shard_attn, eng.tp_plan.shard_kv,
                     eng.tp_plan.shard_ffn),
            "stats": eng.throughput_stats(), "serve_s": serve_s,
            "built_s": built_s, "peak": _peak(mesh.device),
            "groups": (eng.page_manager.groups
                       if eng.page_manager is not None else None),
        }
        if case.get("logits_prompts") is not None:
            res["logits"] = prefill_logits(lm, mesh, case["logits_prompts"],
                                           eng.tp_plan.reduce_tags)
        if case.get("witness") is not None:
            res["witness"] = witness_logits(lm, mesh, *case["witness"],
                                            tags=eng.tp_plan.reduce_tags)
        out.append(res)
        del eng, lm
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def witness_logits(lm, mesh: ServeMesh, toks: np.ndarray, feed: np.ndarray,
                   *, tags=frozenset()) -> list:
    """``launch.witness.witness_calls`` of this rank's data shard of the
    rows, under ``tp_serving(tags)`` and the active mesh, each call's
    logits summed over "data" into the whole batch: [(B, V) numpy]."""
    from repro_torch.launch.witness import witness_calls
    from repro_torch.parallel.hints import mesh_context, tp_serving

    b = toks.shape[0]
    rows = local_rows(mesh, b)
    dev = mesh.device
    with torch.inference_mode(), tp_serving(mesh, tags), \
            mesh_context(mesh):
        calls = witness_calls(lm, torch.as_tensor(toks[rows], device=dev),
                              torch.as_tensor(feed[:, rows], device=dev))
        out = []
        for logits in calls:
            full = torch.zeros((b, logits.shape[-1]), dtype=torch.float32,
                               device=dev)
            full[rows] = logits[:, -1].float()
            out.append(mesh.all_reduce(full, "data").cpu().numpy())
    return out


def moe_drops(lm):
    """Forward pre-hooks on every MoE layer of ``lm`` that count the
    assignments its capacity drops on each call (this rank's tokens):
    returns (the hooks, the list they append (layer, dropped, of) to)."""
    from repro_torch.models.moe import MoE, capacity

    seen = []

    def hook(i, mod, args, kwargs):
        x = args[0]
        t = x.shape[0] * x.shape[1]
        _, _, sel = mod.route(x.reshape(t, -1))
        counts = torch.bincount(sel.reshape(-1), minlength=mod.cfg.n_experts)
        c = capacity(t, mod.cfg)
        seen.append((i, int((counts - c).clamp(min=0).sum()),
                     int(sel.numel())))

    hooks = [layer.mlp.register_forward_pre_hook(
        functools.partial(hook, i), with_kwargs=True)
        for i, layer in enumerate(lm.layers) if isinstance(layer.mlp, MoE)]
    return hooks, seen


def ep_rank(mesh: ServeMesh, case: dict) -> dict:
    """An LM forward under expert parallelism (module docstring). A case:
    ``cfg``, ``dtype``, ``tree`` (numpy weights; the MoE layers are then
    split here) or ``seed`` (``init_expert_parallel``: each MoE layer
    made with only this rank's experts), ``toks`` (B, S) and ``feed``
    (steps, B, 1) numpy, ``capacity_factors`` (a run of the calls for
    each; None: the config's), ``drops`` (count each MoE layer's dropped
    assignments). Returns ``runs``, one a capacity factor: the logits of
    each call [(B, V)] (rank 0's; whole over "data"), the prefill's aux
    loss, each call's kernel launches and dispatches and seconds, the
    drops; and the experts this rank holds a MoE layer, its compressed
    Linears and peak memory. ``calls`` / ``aux`` are the first run's."""
    import dataclasses

    from repro_torch.core.dots import strict_f32
    from repro_torch.interop import lm_from_jax
    from repro_torch.models.cache import CacheView
    from repro_torch.models.moe import MoE
    from repro_torch.parallel.hints import mesh_context
    from repro_torch.parallel.sharding import (
        init_expert_parallel,
        shard_experts_,
    )

    strict_f32()
    cfg, dtype, dev = case["cfg"], case.get("dtype", torch.float32), \
        mesh.device
    t0 = time.perf_counter()
    if case.get("tree") is not None:
        lm = lm_from_jax(cfg, case["tree"], dtype=dtype, device=dev)
        shard_experts_(lm, mesh)
    else:
        lm = init_expert_parallel(cfg, mesh, seed=case.get("seed", 0),
                                  dtype=dtype)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    built_s = time.perf_counter() - t0
    moes = [layer.mlp for layer in lm.layers if isinstance(layer.mlp, MoE)]
    toks, feed = case["toks"], case["feed"]
    b, s = toks.shape
    rows = local_rows(mesh, b)
    runs = []
    for cf in case.get("capacity_factors", [None]):
        for layer, m in zip([ly for ly in lm.layers
                             if isinstance(ly.mlp, MoE)], moes):
            m.cfg = dataclasses.replace(
                m.cfg, capacity_factor=layer.block.mlp.capacity_factor
                if cf is None else cf)
        hooks, seen = moe_drops(lm) if case.get("drops") else ([], [])
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        calls, times, aux = [], [], None
        with torch.inference_mode(), mesh_context(mesh):
            cache = lm.init_cache(rows.stop - rows.start, s + feed.shape[0])
            for i in range(1 + feed.shape[0]):
                kernels = zero_counts()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t1 = time.perf_counter()
                if i == 0:
                    logits, _, aux = lm(
                        torch.as_tensor(toks[rows], device=dev),
                        view=CacheView.prefill(), caches=cache,
                        last_only=True, with_aux=True)
                else:
                    logits, _ = lm(
                        torch.as_tensor(feed[i - 1][rows], device=dev),
                        view=CacheView.decode(torch.full(
                            (rows.stop - rows.start,), s + i - 1)),
                        caches=cache)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                times.append(time.perf_counter() - t1)
                full = torch.zeros((b, logits.shape[-1]),
                                   dtype=torch.float32, device=dev)
                full[rows] = logits[:, -1].float()
                full = mesh.all_reduce(full, "data")  # on every rank
                calls.append({"logits": full.cpu().numpy()
                              if mesh.rank == 0 else None,
                              **read_counts(kernels)})
        for h in hooks:
            h.remove()
        runs.append({"capacity_factor": cf, "calls": calls,
                     "aux": float(aux), "seconds": times, "drops": seen,
                     "peak": _peak(dev)})
    return {"runs": runs, "calls": runs[0]["calls"], "aux": runs[0]["aux"],
            "built_s": built_s,
            "experts": [(m.expert_offset, len(m.experts)) for m in moes],
            "linears": compressed_linears(lm), "coords": mesh.coords}


def cases_rank(mesh: ServeMesh, cases: list) -> list:
    """Each case in order through :func:`ep_rank` (``kind`` "ep") or
    :func:`moe_rank` ("moe"), each on the mesh its ``mesh`` (data,
    model) names, made from this process group (every rank runs the
    same cases in the same order, so the groups match): one spawn runs
    every mesh of its world size."""
    meshes = {(mesh.data, mesh.model): mesh}
    out = []
    for case in cases:
        shape = tuple(case.get("mesh", (mesh.data, mesh.model)))
        if shape not in meshes:
            meshes[shape] = make_serve_mesh(*shape, backend=mesh.backend,
                                            device=mesh.device)
        fn = ep_rank if case["kind"] == "ep" else moe_rank
        out.append(fn(meshes[shape], case))
    return out


def moe_rank(mesh: ServeMesh, case: dict) -> dict:
    """One MoE (``cfg``, numpy weights ``tree``, interop) split over the
    "model" ranks, run on this rank's data shard of ``x`` (B, S, D)
    under the mesh: y summed over "data" to the whole batch, and the aux
    loss."""
    from repro_torch.interop import mlp_from_jax
    from repro_torch.parallel.hints import mesh_context

    moe = mlp_from_jax(case["cfg"], case["tree"], dtype=torch.float32,
                       device=mesh.device)
    moe.shard_(mesh.axis_index("model"), mesh.model)
    kernels = zero_counts()
    x = case["x"]
    rows = local_rows(mesh, x.shape[0])
    with torch.inference_mode(), mesh_context(mesh):
        y, aux = moe(torch.as_tensor(x[rows], device=mesh.device))
        full = torch.zeros(x.shape, dtype=y.dtype, device=y.device)
        full[rows] = y
        full = mesh.all_reduce(full, "data")
    return {"y": full.cpu().numpy(), "aux": float(aux),
            "experts": (moe.expert_offset, len(moe.experts)),
            **read_counts(kernels)}


def _train_model(mesh: ServeMesh, case: dict):
    """The rank's tensor-parallel shard of a train case under the
    training plan (``train_tp_plan``), f32 weights: from numpy weights
    (``tree``, interop, then sliced) or a seed (``init_sharded``: a layer
    at a time, an MoE layer made with this rank's experts only; no rank
    holds the whole model)."""
    from repro_torch.interop import lm_from_jax
    from repro_torch.parallel.sharding import (
        init_sharded,
        shard_lm_,
        train_tp_plan,
    )

    cfg = case["cfg"]
    plan = train_tp_plan(cfg, mesh.model)
    if case.get("tree") is not None:
        lm = lm_from_jax(cfg, case["tree"], dtype=torch.float32,
                         device=mesh.device)
        shard_lm_(lm, plan, mesh)
    else:
        lm = init_sharded(cfg, mesh, plan=plan, seed=case.get("seed", 0),
                          dtype=torch.float32)
    if case.get("policy") is not None:
        _set_policy(lm, case["policy"])
    if case.get("compute") == "bf16":
        lm.set_compute_dtype(torch.bfloat16)
    return lm


def with_frames(batches: list, cfg, seed: int) -> list:
    """``batches`` each with an encoder-decoder's input ``enc_input``:
    random frames (rows, ``cfg.encoder_seq``, ``cfg.d_model``), f32
    standard normal from ``seed``, one draw a batch in order."""
    rng = np.random.default_rng(seed)
    return [dict(b, enc_input=rng.standard_normal(
        (len(b["tokens"]), cfg.encoder_seq, cfg.d_model),
        dtype=np.float32)) for b in batches]


def _batches(case: dict) -> list:
    """The case's batches: given (``batches``, numpy), or the first
    ``steps`` of a ``DataPipeline`` of ``pipeline`` (vocab_size, seq_len,
    global_batch), with random frames from the seed ``frames``
    (:func:`with_frames`) where the case gives one."""
    if case.get("batches") is not None:
        return list(case["batches"])
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig

    pipe = DataPipeline(PipelineConfig(**case["pipeline"]))
    out = [pipe.next() for _ in range(case["steps"])]
    if case.get("frames") is not None:
        out = with_frames(out, case["cfg"], case["frames"])
    return out


def _set_policy(lm, mode: str) -> None:
    from repro_torch.core.nmweight import KernelPolicy
    from repro_torch.models.common import Linear

    for m in lm.modules():
        if isinstance(m, Linear) and m.nm is not None:
            m.kernel_policy = KernelPolicy(mode)


def _local_state(lm, opt_state, err) -> dict:
    """{"params" | "m" | "v" | "err": {name: (numpy, Region)}} of this
    rank's slices, by their names in the whole model (an expert's by its
    global id)."""
    from repro_torch.training.train_loop import trainable

    layout = lm.train_layout
    parts = {"params": {n: p.detach() for n, p in trainable(lm).items()},
             "m": opt_state["m"], "v": opt_state["v"]}
    if err is not None:
        parts["err"] = err
    return {part: {layout.global_name(n): (
        t.detach().to("cpu", torch.float32, copy=True).numpy(),
        layout.region(n, tuple(t.shape))) for n, t in tensors.items()}
        for part, tensors in parts.items()}


class Reference:
    """A single process's trained state (params, m, v, f32) in host shared
    memory, one segment a tensor, for :func:`_diff_to`: the ranks of a
    spawn read the segments by name (:attr:`names`, what a case's
    ``reference`` holds), each only the rows its regions need. With
    ``every`` > 1 a tensor of 2 dims or more keeps every ``every``-th
    entry of its last dim (a sample the compare reads at its columns),
    where the whole state of several models would not fit the host's
    memory beside the ranks. The segments are written and read as files
    (POSIX shared memory is a tmpfs file on Linux), a piece at a time,
    where a mapping would fault each page in. They live until
    :meth:`close` (or the end of the process that made them)."""

    def __init__(self, lm, opt_state, every: int = 1):
        from multiprocessing import shared_memory

        from repro_torch.training.train_loop import trainable

        self._segments: list = []
        self.names: dict = {"every": every}
        writes = []
        try:
            for part, tensors in (("params", trainable(lm)),
                                  ("m", opt_state["m"]),
                                  ("v", opt_state["v"])):
                names = self.names[part] = {}
                for name, t in tensors.items():
                    t = t.detach()
                    if t.ndim >= 2:
                        t = t[..., ::every]
                    seg = shared_memory.SharedMemory(
                        create=True, size=max(4 * t.numel(), 1))
                    self._segments.append(seg)
                    writes.append((seg.name, t))
                    names[name] = (seg.name, tuple(t.shape))
            _write_segments(writes)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        for seg in self._segments:
            seg.close()
            seg.unlink()
        self._segments = []


IO_CHUNK = 1 << 24  # f32 entries a segment's read or write moves at once


def _segment_path(name: str) -> str:
    return os.path.join("/dev/shm", name)


WRITERS = 4  # threads writing segments: tmpfs takes pages a core at a time


def _write_segments(writes: list) -> None:
    """Write each (segment name, tensor) of ``writes``, WRITERS at once,
    each writer through a staging buffer of its own (pinned for a
    tensor on the card)."""
    import concurrent.futures
    import threading

    local = threading.local()

    def write(item):
        name, t = item
        if getattr(local, "stage", None) is None:
            local.stage = torch.empty(IO_CHUNK, dtype=torch.float32,
                                      pin_memory=t.device.type == "cuda")
        _write_segment(name, t, local.stage)

    with concurrent.futures.ThreadPoolExecutor(WRITERS) as pool:
        for _ in pool.map(write, writes):
            pass


def _write_segment(name: str, t: torch.Tensor, stage: torch.Tensor) -> None:
    flat = t.reshape(-1)
    fd = os.open(_segment_path(name), os.O_WRONLY)
    try:
        for i in range(0, flat.numel(), IO_CHUNK):
            piece = stage[:min(IO_CHUNK, flat.numel() - i)]
            piece.copy_(flat[i:i + piece.numel()])
            view = memoryview(piece.numpy()).cast("B")
            done = 0
            while done < len(view):
                done += os.pwrite(fd, view[done:], 4 * i + done)
    finally:
        os.close(fd)


def _reference_region(names: dict, part: str, name: str,
                      index) -> torch.Tensor:
    """The region ``index`` of tensor ``name`` of a :class:`Reference`'s
    ``part`` (host memory, contiguous): the rows of dim 0 it spans are
    read, then the region cut from them."""
    seg_name, shape = names[part][name]
    index = tuple(index)
    rows = shape[0] if shape else 1
    lo, hi = 0, rows
    if index and isinstance(index[0], slice):
        lo, hi, step = index[0].indices(rows)
        if step != 1:
            lo, hi = 0, rows
        else:
            index = (slice(None),) + index[1:]
    elif index:
        ix = np.asarray(index[0])
        lo, hi = int(ix.min()), int(ix.max()) + 1
        index = (ix - lo,) + index[1:]
    row = int(np.prod(shape[1:], dtype=np.int64)) if shape else 1
    arr = np.empty((hi - lo,) + tuple(shape[1:]), np.float32)
    view = memoryview(arr.reshape(-1)).cast("B")
    fd = os.open(_segment_path(seg_name), os.O_RDONLY)
    try:
        done, start = 0, 4 * lo * row
        while done < len(view):
            n = os.preadv(fd, [view[done:done + 4 * IO_CHUNK]],
                          start + done)
            if n <= 0:
                raise OSError(f"reference segment {seg_name}: short read")
            done += n
    finally:
        os.close(fd)
    for dim, ix in enumerate(index):  # one dim at a time: an index
        arr = arr[(slice(None),) * dim + (ix,)]  # array pairs with none
    return torch.from_numpy(np.ascontiguousarray(arr))


def _compared(t: torch.Tensor, region, every: int) -> tuple:
    """(the entries of this rank's ``t`` a reference of ``every`` holds,
    their index into the reference's tensor)."""
    index = list(region.index)
    if t.ndim < 2 or every == 1:
        return t, tuple(index)
    last = index[-1]
    if isinstance(last, slice) and last.step in (None, 1):
        start = last.start or 0
        off = -start % every  # the first local column the sample holds
        n = len(range(off, t.shape[-1], every))
        index[-1] = slice((start + off) // every,
                          (start + off) // every + n)
        return t[..., off::every], tuple(index)
    cols = np.arange(region.shape[-1])[last]
    keep = cols % every == 0
    index[-1] = cols[keep] // every
    return (t[..., torch.as_tensor(np.flatnonzero(keep), device=t.device)],
            tuple(index))


DIFF_CHUNK = 1 << 24  # entries compared at once on the device


def _diff_to(lm, opt_state, reference: dict, tol: float, opt) -> dict:
    """How far this rank's parameters and moments lie from their regions
    of a single process's state (a :class:`Reference`'s ``names``: all
    of it, or its sample), a piece of a tensor at a time: {"params" |
    "m" | "v": (largest |difference|, its tensor, entries beyond
    ``tol``)}; "eps": the parameter entries in AdamW's eps regime by the
    reference's v (sqrt(v-hat) < ``opt.eps``, where an update is
    lr / eps times its gradient, so its rounding moves the entry by up
    to lr a step; after step 1, every entry whose gradient |g| =
    sqrt(v-hat) lies under 10 eps, where the slope
    lr * eps / (|g| + eps)^2 of the update turns a gradient that is
    mostly cancellation, and so lies on either side of zero in two
    summation orders, into up to 2 lr): (their count beyond ``tol``,
    their largest distance, the largest difference of every other entry,
    their count beyond ``tol`` and largest difference as they are). Their
    distance after step 1 is what the two sides' own moments do not
    explain, |p - p_ref + lr (u - u_ref)| with u = m-hat / (sqrt(v-hat)
    + eps) of each side (each step-1 update is -lr (u + wd p0) from the
    same p0), so an update missing or of the wrong sign there counts in
    full; after a later step their difference. "at": the largest
    parameter difference's entry (its position among the compared
    entries), the rank's and the reference's value, m and v there. A
    piece's readings come back in one transfer (ranks sharing a card
    wait for each other at every read of the device)."""
    from repro_torch.optim.optimizer import cosine_schedule
    from repro_torch.training.train_loop import trainable

    layout = lm.train_layout
    every = reference["every"]
    step = torch.as_tensor(opt_state["step"]).cpu()
    first = int(step) == 1
    bc1 = float(1 - torch.pow(opt.b1, step.float()))
    bc2 = float(1 - torch.pow(opt.b2, step.float()))
    lr = float(cosine_schedule(opt, step))
    regime = opt.eps * (10 if first else 1)
    best = {part: (-1.0, None, 0) for part in ("params", "m", "v")}
    eps_n, eps_max, rest_max, raw_n, raw_max = 0, 0.0, 0.0, 0, 0.0
    worst, at = (None, 0), {}

    def update(m, v):
        return (m / bc1) / (torch.sqrt(v / bc2) + opt.eps)

    for name, p in trainable(lm).items():
        region = layout.region(name, tuple(p.shape))
        mine = {}
        for part, t in (("params", p), ("m", opt_state["m"][name]),
                        ("v", opt_state["v"][name])):
            mine[part], index = _compared(t.detach(), region, every)
        ref = {part: _reference_region(reference, part,
                                       layout.global_name(name), index)
               for part in mine}
        n = mine["params"].numel()
        for i in range(0, n, DIFF_CHUNK):
            sl = slice(i, min(i + DIFF_CHUNK, n))
            a = {k: t.reshape(-1)[sl].float() for k, t in mine.items()}
            b = {k: t.reshape(-1)[sl].to(p.device) for k, t in ref.items()}
            in_eps = torch.sqrt(b["v"] / bc2) < regime
            d = {k: (a[k] - b[k]).abs() for k in a}
            raw = torch.where(in_eps, d["params"], 0.0)
            dist = raw
            if first:
                du = update(a["m"], a["v"]) - update(b["m"], b["v"])
                dist = torch.where(in_eps, ((a["params"] - b["params"])
                                            + lr * du).abs(), 0.0)
            readings = [x for k in ("params", "m", "v")
                        for x in (d[k].max(), (d[k] > tol).sum())]
            readings += [d["params"].argmax(), raw.max(), (raw > tol).sum(),
                         dist.max(), (dist > tol).sum(),
                         torch.where(in_eps, 0.0, d["params"]).max()]
            r = torch.stack([x.double() for x in readings]).tolist()
            for j, part in enumerate(("params", "m", "v")):
                big, leaf, over = best[part]
                if r[2 * j] > big:
                    big, leaf = r[2 * j], name
                    if part == "params":
                        worst = (name, i + int(r[6]))
                best[part] = (big, leaf, over + int(r[2 * j + 1]))
            raw_max, raw_n = max(raw_max, r[7]), raw_n + int(r[8])
            eps_max, eps_n = max(eps_max, r[9]), eps_n + int(r[10])
            rest_max = max(rest_max, r[11])
        if worst[0] == name:
            at = {part: (float(mine[part].reshape(-1)[worst[1]]),
                         float(ref[part].reshape(-1)[worst[1]]))
                  for part in mine}
        del mine, ref
    out = {part: (max(big, 0.0), leaf, over)
           for part, (big, leaf, over) in best.items()}
    out["eps"] = (eps_n, eps_max, rest_max, raw_n, raw_max)
    out["at"] = (worst[0], worst[1], at)
    return out


def train_rank(mesh: ServeMesh, cases: list) -> list:
    """Train each case on this rank (``training.sharded``), each on the
    mesh its ``mesh`` (data, model) names (default: this spawn's; every
    rank runs the same cases in the same order). A case: ``cfg``,
    ``tree`` (numpy weights) or ``seed``, ``compute`` ("f32" or "bf16"),
    ``policy`` (the compressed Linears' kernel policy mode, if given),
    ``mode`` ("fsdp" / "tp_only"), ``tcfg`` (a ``TrainConfig``),
    ``batches`` or ``pipeline`` + ``steps`` (and an encoder-decoder's
    ``frames``, a seed: ``with_frames``); ``resume`` (directory, step):
    the state restored from a whole checkpoint first (elastic) and the
    batches after that step run; ``save`` (directory, step): the state
    saved whole after that step; ``gate``: the first step's (loss,
    grad_norm) under policy "off", without an update (the step itself
    gives them through the kernels);
    ``state``: the steps after which this rank's slices are returned
    (numpy, with their regions: ``states`` by step);
    ``reference`` (a :class:`Reference`'s ``names``) and ``tol``: how far
    the state after step ``reference_at`` (default: the last) lies from a
    single process's (``diff``).
    Returns per case: each step's metrics (floats), seconds and split
    (``ShardedTrainStep.split``), the dispatches and launches of
    the steps (counted from zero just before the first), the compressed
    Linears of the shard, the peak memory of the steps and the rank's
    coordinates."""
    from repro_torch.core.dots import strict_f32
    from repro_torch.training.checkpoint import Checkpointer
    from repro_torch.training.sharded import (
        init_sharded_train_state,
        make_sharded_train_step,
        save_sharded,
        train_shardings,
    )

    strict_f32()
    meshes = {(mesh.data, mesh.model): mesh}
    out = []
    for case in cases:
        shape = tuple(case.get("mesh", (mesh.data, mesh.model)))
        if shape not in meshes:
            meshes[shape] = make_serve_mesh(*shape, backend=mesh.backend,
                                            device=mesh.device)
        m = meshes[shape]
        dev = m.device
        t0 = time.perf_counter()
        lm = _train_model(m, case)
        tcfg, mode = case["tcfg"], case.get("mode", "fsdp")
        step_fn = make_sharded_train_step(lm, tcfg, m, mode)
        lm, opt, *err = init_sharded_train_state(lm, tcfg, m, mode)
        err = err[0] if err else None
        batches = _batches(case)
        first = 0
        if case.get("resume") is not None:
            directory, at = case["resume"]
            restored, _ = Checkpointer(directory).restore(
                {"params": lm, "opt": opt}, step=at,
                shardings=train_shardings(lm, opt))
            opt, first = restored["opt"], at
        built_s = time.perf_counter() - t0
        res = {"coords": m.coords, "mesh": shape, "built_s": built_s,
               "linears": compressed_linears(lm)}
        if case.get("gate"):  # the kernels' side is the first step's
            t1 = time.perf_counter()
            _set_policy(lm, "off")
            plain = step_fn.loss_and_norm(lm, batches[first])
            _set_policy(lm, "auto")
            res["gate"] = {"off": plain,
                           "seconds": time.perf_counter() - t1}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        kernels = zero_counts()
        metrics, seconds, states, splits = [], [], {}, []
        for i in range(first, len(batches)):
            t1 = time.perf_counter()
            if err is not None:
                lm, opt, err, mt = step_fn(lm, opt, batches[i], err)
            else:
                lm, opt, mt = step_fn(lm, opt, batches[i])
            metrics.append({k: float(v) for k, v in mt.items()})
            seconds.append(time.perf_counter() - t1)
            splits.append(dict(step_fn.split))
            if i + 1 in case.get("state", ()):
                states[i + 1] = _local_state(lm, opt, err)
            if case.get("save") is not None and i + 1 == case["save"][1]:
                t1 = time.perf_counter()
                save_sharded(Checkpointer(case["save"][0]), i + 1, lm, opt,
                             m)
                res["save_s"] = time.perf_counter() - t1
            if case.get("reference") is not None and i + 1 == case.get(
                    "reference_at", len(batches)):
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                t1 = time.perf_counter()
                res["diff"] = _diff_to(lm, opt, case["reference"],
                                       tol=case.get("tol", 0.0),
                                       opt=tcfg.opt)
                res["diff_s"] = time.perf_counter() - t1
        res.update(metrics=metrics, seconds=seconds, splits=splits,
                   peak=_peak(dev), states=states, **read_counts(kernels))
        res["case_s"] = time.perf_counter() - t0
        out.append(res)
        del lm, opt, err, step_fn
        # a finished case's model can stay alive in a reference cycle
        # through its step's frames until the collector runs: free it
        # before the next case is built
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def make_shardwise_train_step(lm, tcfg, data: int):
    """``train_step(lm, opt_state, batch)`` of one process (the whole
    model, no mesh) computing what ``make_sharded_train_step`` computes
    on a mesh of ``data`` data ranks: microbatch i is the batch's i-th
    block of rows, and each of its ``data`` blocks of rows (all its rows
    where they do not divide) runs on its own, an MoE at that shard's
    capacity and with that shard's aux. A microbatch's loss is the sum
    over the shards of their NLL sums over the whole microbatch's count
    of labels, plus the mean of the shards' aux; the gradients are
    autograd's over it, averaged over the microbatches; then AdamW, as
    ``train_loop.make_train_step``. The oracle of the sharded step of an
    MoE at data > 1, where the whole-batch step is not: the drops and
    the aux are per shard there, as in JAX's expert-parallel MoE."""
    from repro_torch.optim.optimizer import adamw_update
    from repro_torch.training.train_loop import (
        param_grads,
        to_device,
        trainable,
    )

    if tcfg.grad_compression:
        raise ValueError("the shard-wise step has no gradient compression")
    mb = tcfg.microbatches

    def train_step(lm_, opt_state, batch):
        if lm_.cfg != lm.cfg:
            raise ValueError("train_step runs models of the config it was "
                             "built for")
        params = trainable(lm_)
        batch = to_device(batch, lm_.device)
        n = len(batch["tokens"])
        if n % mb:
            raise ValueError(f"batch of {n} rows does not split into {mb} "
                             "microbatches")
        per = n // mb
        shards = data if per % data == 0 else 1
        local = per // shards
        acc, losses = None, []
        for i in range(mb):
            count = (batch["labels"][i * per:(i + 1) * per] >= 0).sum().to(
                torch.float32)
            nll = aux = 0.0
            for d in range(shards):
                rows = slice(i * per + d * local, i * per + (d + 1) * local)
                _, parts = lm_.loss({k: v[rows] for k, v in batch.items()},
                                    remat=tcfg.remat, count=count)
                nll = nll + parts["nll"]
                aux = aux + parts["aux"] / shards
            g = param_grads(nll + aux, params)
            acc = g if acc is None else {k: acc[k] + g[k].float()
                                         for k in acc}
            losses.append((nll.detach(), aux.detach()))
        grads = acc if mb == 1 else {k: v / mb for k, v in acc.items()}
        loss = sum(a + b for a, b in losses) / mb
        _, opt_state, om = adamw_update(tcfg.opt, params, grads, opt_state)
        return lm_, opt_state, {"loss": loss, "nll": losses[-1][0],
                                "aux": losses[-1][1], **om}

    return train_step
