"""Meshes over ``torch.distributed`` (port of
``repro.launch.mesh.make_serve_mesh``), for the sharded serving engine
and the sharded train step alike.

A mesh is ``data x model`` ranks: batch slots or rows split over
"data", tensor or expert parallelism over "model". Rank r sits at
(r // model, r % model), as the JAX package's row-major mesh puts its
devices. :func:`make_serve_mesh` is called by every rank of an
initialised process group and returns a :class:`ServeMesh`: the world
group, the "data" and "model" subgroups of this rank, its coordinates,
its device and ``axis_size(name)``. Collectives are sums
(``all_reduce``), maxima (``all_max``) and ``broadcast``: a gather is a
sum into a zero-filled buffer and a reduce-scatter a sum followed by the
rank's slice (gloo has no reduce-scatter), so one code path serves gloo
and NCCL.

The backend is the caller's choice, made explicitly: ``"gloo"`` for
ranks on the CPU or ranks that share one card (NCCL refuses two ranks
on one GPU), ``"nccl"`` for ranks on distinct cards. Nothing here
switches backend or device on an error.

:func:`spawn` starts the ranks of a mesh as processes (start method
``spawn``: a CUDA context never crosses a fork), with a ``FileStore``
rendezvous in a temporary directory (no TCP port) and a timeout on the
process group and on the whole run. It raises if a rank raises, exits
non-zero or outlives the timeout, and kills the ranks still running.
The rank function must be importable by name (a module-level function
of the package), and it returns what the caller gets back, by rank.

:class:`MetaMesh` is a :class:`ServeMesh` of one rank's coordinates and
no process group, on the ``meta`` device (the dry-run): its collectives
record their operand bytes by kind and axis and return a meta tensor of
the result's shape. Every collective of the port goes through a
``ServeMesh``, so a step run under a ``MetaMesh`` shows them all.
:func:`make_production_mesh` gives the JAX package's production meshes
as ``MetaMesh`` es.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core import scan

AXES = ("data", "model")
BACKENDS = ("gloo", "nccl")
EXIT_GRACE_S = 60.0  # a rank's exit after its result, past the deadline


@dataclasses.dataclass
class ServeMesh:
    """This rank's view of a ``data x model`` mesh. The groups are None
    in a mesh of one rank (1 x 1), where every collective is the
    identity."""

    data: int
    model: int
    rank: int
    backend: str
    device: torch.device
    world_group: Any = None
    data_group: Any = None
    model_group: Any = None

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def coords(self) -> tuple[int, int]:
        """(data, model) coordinates of this rank."""
        return self.rank // self.model, self.rank % self.model

    def axis_size(self, name: str) -> int:
        if name not in AXES:
            raise KeyError(f"no mesh axis {name!r}; the axes are {AXES}")
        return self.data if name == "data" else self.model

    def axis_index(self, name: str) -> int:
        return self.coords[AXES.index(name)]

    def group(self, name: str):
        return {"data": self.data_group, "model": self.model_group,
                "world": self.world_group}[name]

    def all_reduce(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """The sum of ``x`` over the ranks of axis ``name`` ("data",
        "model" or "world"). Floats below f32 are summed in f32 and cast
        back; the result is a new tensor unless the axis has one rank
        (then ``x`` itself)."""
        size = self.world if name == "world" else self.axis_size(name)
        if size == 1:
            return x
        y = x.float() if x.is_floating_point() and x.element_size() < 4 \
            else x.clone()
        y = y.contiguous()
        dist.all_reduce(y, group=self.group(name))
        return y.to(x.dtype)

    def broadcast(self, x: torch.Tensor, name: str, src: int
                  ) -> torch.Tensor:
        """``x`` of the rank at coordinate ``src`` of axis ``name`` ("data"
        or "model"), on every rank of that axis: a new tensor (``x``
        itself on an axis of one rank)."""
        if self.axis_size(name) == 1:
            return x
        d, m = self.coords
        root = src * self.model + m if name == "data" else d * self.model + src
        y = x.clone().contiguous()
        dist.broadcast(y, src=root, group=self.group(name))
        return y

    def all_max(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """The elementwise maximum of ``x`` over the ranks of axis
        ``name``, a new tensor (``x`` itself on an axis of one rank)."""
        size = self.world if name == "world" else self.axis_size(name)
        if size == 1:
            return x
        y = x.clone().contiguous()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group(name))
        return y


@dataclasses.dataclass
class MetaMesh(ServeMesh):
    """The ``data x model`` mesh of the rank at ``rank``, on the meta
    device and without a process group (module docstring). ``log`` holds
    each collective as (kind, axis, operand bytes); the count installed
    in :mod:`repro_torch.core.scan` (a dry-run's
    :class:`repro_torch.roofline.step_cost.StepCost`) gets them too. The
    operand of ``all_reduce`` is what :class:`ServeMesh` sends: a float
    below f32 is summed in f32."""

    backend: str = "meta"
    device: torch.device = torch.device("meta")
    log: list = dataclasses.field(default_factory=list)

    def _record(self, kind: str, name: str, y: torch.Tensor) -> None:
        nbytes = y.numel() * y.element_size()
        self.log.append((kind, name, nbytes))
        count = scan.active()
        if count is not None:
            count.collective(kind, name, nbytes)

    # the copies ServeMesh makes around each collective, then the record

    def all_reduce(self, x: torch.Tensor, name: str) -> torch.Tensor:
        size = self.world if name == "world" else self.axis_size(name)
        if size == 1:
            return x
        y = x.float() if x.is_floating_point() and x.element_size() < 4 \
            else x.clone()
        self._record("all_reduce", name, y)
        return y.to(x.dtype)

    def broadcast(self, x: torch.Tensor, name: str, src: int
                  ) -> torch.Tensor:
        if self.axis_size(name) == 1:
            return x
        y = x.clone()
        self._record("broadcast", name, y)
        return y

    def all_max(self, x: torch.Tensor, name: str) -> torch.Tensor:
        size = self.world if name == "world" else self.axis_size(name)
        if size == 1:
            return x
        y = x.clone()
        self._record("all_max", name, y)
        return y


def make_production_mesh(multi_pod: bool = False, rank: int = 0
                         ) -> MetaMesh:
    """The JAX package's production mesh as the ``MetaMesh`` of ``rank``:
    16 x 16 ("data", "model"), or with ``multi_pod`` the 2 x 16 x 16 one
    with its "pod" axis folded into "data" (32 x 16), as ``dp_axes``
    folds it into the data-parallel axes."""
    return MetaMesh(32 if multi_pod else 16, 16, rank)


def _subgroups(data: int, model: int):
    """(data groups by model coordinate, model groups by data
    coordinate); every rank makes every group, in the same order."""
    data_groups = [dist.new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    return data_groups, model_groups


def make_serve_mesh(data: int = 1, model: int = 1, *, backend: str,
                    device="cuda") -> ServeMesh:
    """This rank's :class:`ServeMesh` of ``data x model`` ranks. With more
    than one rank the default process group must be initialised with
    ``data * model`` ranks and ``backend``; with one rank no group is
    needed. ``device`` is this rank's device ("cuda" is the card of the
    rank's local index under NCCL, card 0 under gloo)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    world = data * model
    if world == 1:
        return ServeMesh(1, 1, 0, backend, _device(device, backend, 0))
    if not dist.is_initialized():
        raise RuntimeError(f"a {data} x {model} mesh needs an initialised "
                           "process group (launch.mesh.spawn)")
    if dist.get_world_size() != world:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks; a {data} x {model} mesh needs {world}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    rank = dist.get_rank()
    data_groups, model_groups = _subgroups(data, model)
    mesh = ServeMesh(data, model, rank, backend,
                     _device(device, backend, rank))
    mesh.world_group = dist.group.WORLD
    mesh.data_group = data_groups[mesh.coords[1]]
    mesh.model_group = model_groups[mesh.coords[0]]
    return mesh


def _device(device, backend: str, rank: int) -> torch.device:
    from repro_torch.models.common import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
    return dev


def _worker(rank: int, data: int, model: int, backend: str, device: str,
            store_path: str, timeout_s: float, call_path: str,
            results) -> None:
    torch.set_num_threads(1)
    try:
        with open(call_path, "rb") as f:  # written by this rank's parent
            fn, args = pickle.load(f)
        if data * model > 1:
            store = dist.FileStore(store_path, data * model)
            dist.init_process_group(
                backend, store=store, rank=rank, world_size=data * model,
                timeout=datetime.timedelta(seconds=timeout_s))
        mesh = make_serve_mesh(data, model, backend=backend, device=device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        out = fn(mesh, *args)
        results.put((rank, "ok", out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """The running ranks of :func:`start`; :meth:`join` waits for their
    results (what :func:`spawn` returns)."""

    def __init__(self, fn: Callable, data: int, model: int, *,
                 backend: str, device, timeout_s: float, args: tuple):
        import torch.multiprocessing as mp

        self.world, self.timeout_s = data * model, timeout_s
        self.deadline = time.monotonic() + timeout_s
        ctx = mp.get_context("spawn")
        self.results = ctx.Queue()
        self.tmp = tempfile.TemporaryDirectory(prefix="repro_torch_mesh_")
        store = os.path.join(self.tmp.name, "store")
        # the call goes through a file, not the process's arguments: a
        # large pickle in the start pipe would hold each start until its
        # child has imported enough to read it, so the ranks would start
        # one after another
        call = os.path.join(self.tmp.name, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, args), f)
        self.procs = [ctx.Process(target=_worker, daemon=True, args=(
            r, data, model, backend, str(device), store, timeout_s, call,
            self.results)) for r in range(self.world)]
        try:
            for p in self.procs:
                p.start()
        except BaseException:
            self.stop()
            raise

    def join(self) -> list:
        """The ranks' results in rank order; raises RuntimeError (the
        ranks killed) on a rank's error, exit or the timeout."""
        try:
            return _collect(self.procs, self.results, self.world,
                            self.timeout_s, self.deadline)
        finally:
            self.stop()

    def stop(self) -> None:
        """Kill every rank still running and remove the rendezvous."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            if p.pid is not None:
                p.join(timeout=10)
        self.tmp.cleanup()


def start(fn: Callable, data: int, model: int, *, backend: str,
          device="cuda", timeout_s: float = 600.0, args: tuple = (),
          verbose: bool = True) -> Ranks:
    """Start ``fn(mesh, *args)`` on every rank of a ``data x model`` mesh,
    each in a process of its own, and return at once; ``.join()`` gives
    the results (see :func:`spawn`)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if verbose:
        print(f"mesh.spawn: {data} x {model} ranks, backend {backend}, "
              f"device {device}, timeout {timeout_s:.0f}s", flush=True)
    return Ranks(fn, data, model, backend=backend, device=device,
                 timeout_s=timeout_s, args=args)


def spawn(fn: Callable, data: int, model: int, *, backend: str,
          device="cuda", timeout_s: float = 600.0, args: tuple = (),
          verbose: bool = True) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a ``data x model`` mesh,
    each in a process of its own; returns the ranks' results in rank
    order. Raises RuntimeError, after killing every rank still running,
    when a rank raises or exits non-zero or the ranks are not all done
    within ``timeout_s`` seconds."""
    return start(fn, data, model, backend=backend, device=device,
                 timeout_s=timeout_s, args=args, verbose=verbose).join()


def _collect(procs, results, world: int, timeout_s: float,
             deadline: float) -> list:
    out: dict[int, Any] = {}
    while len(out) < world:
        try:
            rank, status, value = results.get(timeout=0.2)
        except queue_mod.Empty:
            dead = [(r, p.exitcode) for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and r not in out]
            if dead:
                raise RuntimeError(f"mesh.spawn: ranks exited without a "
                                   f"result (rank, exit code): {dead}")
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"mesh.spawn: timed out after {timeout_s:.0f}s with "
                    f"ranks {sorted(set(range(world)) - set(out))} running")
            continue
        if status == "error":
            raise RuntimeError(f"mesh.spawn: rank {rank} raised:\n{value}")
        out[rank] = value
    for p in procs:  # a rank with its result only shuts down now
        p.join(timeout=max(EXIT_GRACE_S, deadline - time.monotonic()))
        if p.exitcode != 0:
            raise RuntimeError(f"mesh.spawn: a rank exited with code "
                               f"{p.exitcode} after its result")
    return [out[r] for r in range(world)]


def local_rows(mesh: Optional[ServeMesh], n: int) -> slice:
    """The rows of an ``n``-row batch that this rank's data shard holds
    (all of them without a mesh); ``n`` must divide over "data"."""
    if mesh is None or mesh.data == 1:
        return slice(0, n)
    if n % mesh.data:
        raise ValueError(f"{n} rows do not divide over data={mesh.data}")
    per = n // mesh.data
    d = mesh.axis_index("data")
    return slice(d * per, (d + 1) * per)
