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
* :func:`ping`: one ``all_reduce`` of each axis (a mesh's smoke test).
"""
from __future__ import annotations

import functools
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
    """The rank's tensor-parallel shard of a train case, f32 weights:
    from numpy weights (``tree``, interop, then sliced) or a seed
    (``init_sharded``: a layer at a time, no rank holds the whole
    model)."""
    from repro_torch.interop import lm_from_jax
    from repro_torch.parallel.sharding import (
        init_sharded,
        serve_tp_plan,
        shard_lm_,
    )

    cfg = case["cfg"]
    if case.get("tree") is not None:
        lm = lm_from_jax(cfg, case["tree"], dtype=torch.float32,
                         device=mesh.device)
        shard_lm_(lm, serve_tp_plan(cfg, mesh.model), mesh)
    else:
        lm = init_sharded(cfg, mesh, seed=case.get("seed", 0),
                          dtype=torch.float32)
    if case.get("policy") is not None:
        _set_policy(lm, case["policy"])
    if case.get("compute") == "bf16":
        lm.set_compute_dtype(torch.bfloat16)
    return lm


def _batches(case: dict) -> list:
    """The case's batches: given (``batches``, numpy), or the first
    ``steps`` of a ``DataPipeline`` of ``pipeline`` (vocab_size, seq_len,
    global_batch)."""
    if case.get("batches") is not None:
        return list(case["batches"])
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig

    pipe = DataPipeline(PipelineConfig(**case["pipeline"]))
    return [pipe.next() for _ in range(case["steps"])]


def _set_policy(lm, mode: str) -> None:
    from repro_torch.core.nmweight import KernelPolicy
    from repro_torch.models.common import Linear

    for m in lm.modules():
        if isinstance(m, Linear) and m.nm is not None:
            m.kernel_policy = KernelPolicy(mode)


def _local_state(lm, opt_state, err) -> dict:
    """{"params" | "m" | "v" | "err": {name: (numpy, Region)}} of this
    rank's slices."""
    from repro_torch.training.train_loop import trainable

    layout = lm.train_layout
    parts = {"params": {n: p.detach() for n, p in trainable(lm).items()},
             "m": opt_state["m"], "v": opt_state["v"]}
    if err is not None:
        parts["err"] = err
    return {part: {n: (t.detach().to("cpu", torch.float32,
                                     copy=True).numpy(),
                       layout.region(n, tuple(t.shape)))
                   for n, t in tensors.items()}
            for part, tensors in parts.items()}


def save_reference(directory: str, lm, opt_state) -> None:
    """Write a single process's trained state for :func:`_diff_to`: one
    ``.npy`` file a tensor (``{params|m|v}.{name}.npy``), which a rank
    maps and slices to its regions."""
    from repro_torch.training.train_loop import trainable

    os.makedirs(directory, exist_ok=True)
    for part, tensors in (("params", trainable(lm)), ("m", opt_state["m"]),
                          ("v", opt_state["v"])):
        for name, t in tensors.items():
            np.save(os.path.join(directory, f"{part}.{name}.npy"),
                    t.detach().to("cpu", torch.float32).numpy())


def _diff_to(lm, opt_state, directory: str, tol: float, opt) -> dict:
    """How far this rank's parameters and moments lie from their regions
    of a single process's state (:func:`save_reference`), one tensor at
    a time: {"params" | "m" | "v": (largest |difference|, its tensor,
    entries beyond ``tol``)}; "eps": the parameter entries in AdamW's
    eps regime by the reference's v (sqrt(v-hat) < ``opt.eps``, where an
    update is lr / eps times its gradient, so the gradient's rounding
    moves it by up to lr a step): (their count beyond ``tol``, their
    largest difference, the largest difference of every other entry);
    "at": the largest parameter difference's entry, the rank's and the
    reference's value, m and v there."""
    from repro_torch.training.train_loop import trainable

    layout = lm.train_layout
    bc2 = 1 - opt.b2 ** int(opt_state["step"])
    out = {part: (0.0, None, 0) for part in ("params", "m", "v")}
    eps_n, eps_max, rest_max, worst = 0, 0.0, 0.0, (None, 0)

    def ref(part, name, t):
        index = layout.region(name, tuple(t.shape)).index
        arr = np.load(os.path.join(directory, f"{part}.{name}.npy"),
                      mmap_mode="r")[index]
        return torch.from_numpy(np.ascontiguousarray(arr)).to(t.device)

    for name, p in trainable(lm).items():
        for part, t in (("v", opt_state["v"][name]),
                        ("m", opt_state["m"][name]), ("params", p)):
            r = ref(part, name, t)
            if part == "v":
                in_eps = torch.sqrt(r / bc2) < opt.eps
            d = (t.detach().float() - r).abs()
            del r
            big, leaf, over = out[part]
            over += int((d > tol).sum())
            if leaf is None or float(d.max()) > big:
                out[part] = (float(d.max()), name, over)
                if part == "params":
                    worst = (name, int(d.argmax()))
            else:
                out[part] = (big, leaf, over)
            if part == "params":
                eps_n += int((in_eps & (d > tol)).sum())
                if bool(in_eps.any()):
                    eps_max = max(eps_max, float(d[in_eps].max()))
                if not bool(in_eps.all()):
                    rest_max = max(rest_max, float(d[~in_eps].max()))
            del d
        del in_eps
    out["eps"] = (eps_n, eps_max, rest_max)
    name, i = worst
    mine = {"params": trainable(lm)[name], "m": opt_state["m"][name],
            "v": opt_state["v"][name]}
    out["at"] = (name, i, {
        part: (float(t.detach().reshape(-1)[i]),
               float(ref(part, name, t).reshape(-1)[i]))
        for part, t in mine.items()})
    return out


def train_rank(mesh: ServeMesh, cases: list) -> list:
    """Train each case on this rank (``training.sharded``), each on the
    mesh its ``mesh`` (data, model) names (default: this spawn's; every
    rank runs the same cases in the same order). A case: ``cfg``,
    ``tree`` (numpy weights) or ``seed``, ``compute`` ("f32" or "bf16"),
    ``policy`` (the compressed Linears' kernel policy mode, if given),
    ``mode`` ("fsdp" / "tp_only"), ``tcfg`` (a ``TrainConfig``),
    ``batches`` or ``pipeline`` + ``steps``; ``resume`` (directory, step):
    the state restored from a whole checkpoint first (elastic) and the
    batches after that step run; ``save`` (directory, step): the state
    saved whole after that step; ``gate``: the first step's (loss,
    grad_norm) under policy "off", without an update (the step itself
    gives them through the kernels);
    ``state``: the steps after which this rank's slices are returned
    (numpy, with their regions: ``states`` by step);
    ``reference`` (a directory of :func:`save_reference`) and ``tol``:
    how far the final state lies from a single process's (``diff``).
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
        res.update(metrics=metrics, seconds=seconds, splits=splits,
                   peak=_peak(dev), states=states, **read_counts(kernels))
        if case.get("reference") is not None:
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            t1 = time.perf_counter()
            res["diff"] = _diff_to(lm, opt, case["reference"],
                                   tol=case.get("tol", 0.0), opt=tcfg.opt)
            res["diff_s"] = time.perf_counter() - t1
        res["case_s"] = time.perf_counter() - t0
        out.append(res)
        del lm, opt, err, step_fn
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out
