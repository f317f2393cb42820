"""Checkpoints with async save, and a reader for the JAX package's (port
of ``repro.training.checkpoint``, format 3).

A checkpoint is a directory ``step_<8 digits>`` holding ``arrays.npz``
(one array a leaf, ``leaf_<i>``) and ``manifest.json``: ``format``,
``step``, ``extra`` (the data cursor), ``leaves`` (each leaf's path),
``dtypes`` (each leaf's dtype; a bf16 leaf, which numpy cannot hold, is
stored as its raw bits) and ``weights``: the static metadata of every
N:M weight (``kind`` compressed / quantized / masked, ``n``, ``m``,
``axis``, and for the compressed kinds the kernel ``policy``). Restore
checks the paths, each leaf's shape and the weights' kind, pattern and
axis against the template, so a 1:4 checkpoint cannot restore into a
2:4 model. The policy is an execution preference, not data: the
template's wins.

A state is a tree of dicts (flattened in sorted key order, as JAX
flattens them), lists, tensors, Python numbers and ``nn.Module``s. A
module's leaves are its ``state_dict()`` (float weights, ``idx``, int8
values and scales); restore loads them into the module in place. A
train state is ``{"params": lm, "opt": opt_state}``.

Async: ``save(..., async_=True)`` copies the state to host memory at
once and writes on a thread; ``wait()`` joins it (and raises what the
write raised) before the next save or restore.

``read_jax_checkpoint`` reads a checkpoint the JAX package's
``Checkpointer`` wrote for ``{"params", "opt"}`` of its ``LM``: the
leaves by their manifest paths (``params/groups/[0]/[0]/mixer/wq/vals``)
and the ``weights`` metadata give the JAX param tree, which
``repro_torch.interop.lm_from_jax`` builds into an :class:`LM`; the
AdamW moments are built the same way and taken by parameter name. Not
ported: the JAX package's shim for its own pre-format-2 checkpoints.

Elastic restore (the counterpart of the JAX restore's ``shardings``,
which ``device_put``s each leaf onto the current mesh): a sharded train
state is saved whole, in this same format (its ranks gather each leaf
and rank 0 writes, ``repro_torch.training.sharded.save_sharded``), so
one process restores it as any other. ``restore(template, shardings=)``
takes {leaf path: :class:`Region`} (the leaf's whole shape, this
rank's index into it, and the stored leaf it comes from where that is
another path: an expert-parallel rank's ``experts.0`` is the whole
model's ``experts.<its global id>``) and loads into each such template
leaf only its region, one leaf at a time; the stored leaves no template
leaf reads (the other ranks' experts) are then skipped. A run saved at
one mesh resumes at another or in one process.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

_FORMAT = 3


def _walk(tree: Any, path: str = ""):
    """(path, leaf) of every leaf in flatten order; a module's leaves are
    its state_dict, a Python number is a leaf."""
    def join(k):
        return f"{path}/{k}" if path else str(k)

    if isinstance(tree, nn.Module):
        for k, t in tree.state_dict(keep_vars=True).items():
            yield join(k), t
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], join(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, join(f"[{i}]"))
    else:
        yield path, tree


def _policy_meta(pol) -> dict:
    return {"mode": pol.mode,
            "block": list(pol.block) if pol.block else None,
            "decode_block": list(pol.decode_block) if pol.decode_block
            else None,
            "backend": pol.backend}


def weight_meta(tree: Any, path: str = "") -> dict:
    """The static metadata of every N:M weight in ``tree``, by path."""
    from repro_torch.models.common import Linear

    out = {}
    if isinstance(tree, nn.Module):
        for name, mod in tree.named_modules():
            if not isinstance(mod, Linear):
                continue
            at = "/".join(p for p in (path, name) if p)
            if mod.mask_nm is not None:
                out[at] = {"kind": "masked", "n": mod.mask_nm.n,
                           "m": mod.mask_nm.m, "axis": mod.axis}
            elif mod.nm is not None:
                meta = {"kind": "quantized" if mod.quantized
                        else "compressed", "n": mod.nm.n, "m": mod.nm.m,
                        "axis": mod.axis,
                        "policy": _policy_meta(mod.kernel_policy)}
                if mod.quantized:
                    meta["scale_dtype"] = str(mod.scales.dtype).removeprefix(
                        "torch.")
                out[at] = meta
    elif isinstance(tree, dict):
        for k in sorted(tree):
            out.update(weight_meta(tree[k], f"{path}/{k}" if path else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(weight_meta(v, f"{path}/[{i}]" if path else f"[{i}]"))
    return out


def _host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` that nothing else holds (on the CPU
    ``.cpu()`` would share the live tensor's storage, which the next step
    updates in place while an async write reads it), and its dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        dt = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.to("cpu", copy=True).numpy(), dt
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def _write(self, step: int, named: dict, meta: dict) -> None:
        try:
            path = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(path + ".tmp", exist_ok=True)
            np.savez(os.path.join(path + ".tmp", "arrays.npz"), **named)
            with open(os.path.join(path + ".tmp", "manifest.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(path):  # a re-save after a restart replaces
                shutil.rmtree(path)
            os.rename(path + ".tmp", path)
            self._gc()
        except BaseException as e:  # surfaced by the next wait()
            self._error = e

    def _gc(self) -> None:
        for s in self.list_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"))

    def save(self, step: int, state: Any, extra: Optional[dict] = None,
             async_: bool = False) -> None:
        self.save_leaves(step, _walk(state), weight_meta(state), extra,
                         async_)

    def save_leaves(self, step: int, leaves, weights: dict,
                    extra: Optional[dict] = None,
                    async_: bool = False) -> None:
        """Save the (path, leaf) pairs ``leaves`` (a state's flatten
        order) with the N:M metadata ``weights`` as the checkpoint of
        ``step``: what :meth:`save` writes for a state."""
        self.wait()
        named, paths, dtypes = {}, [], []
        for i, (path, leaf) in enumerate(leaves):
            named[f"leaf_{i}"], dt = _host(leaf)
            paths.append(path)
            dtypes.append(dt)
        meta = {"format": _FORMAT, "step": step, "extra": extra or {},
                "leaves": paths, "dtypes": dtypes, "weights": weights}
        if async_:
            self._thread = threading.Thread(
                target=self._write, args=(step, named, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, named, meta)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # --------------------------------------------------------------- restore
    def list_steps(self) -> list[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def _load(self, step: Optional[int]):
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)
        return meta, np.load(os.path.join(path, "arrays.npz"))

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Optional[dict] = None):
        """(state, manifest) of ``step`` (default: the latest) in the
        structure of ``template``: a tensor leaf comes back as a new
        tensor in the template leaf's dtype and on its device, a number
        as a number, and a module is loaded in place and returned.
        ``shardings`` {leaf path: :class:`Region`} loads only the region
        of each such leaf (elastic restore: the template holds this
        rank's slices; module docstring); its stored shape must be the
        region's whole shape."""
        meta, data = self._load(step)
        shardings = shardings or {}
        if meta.get("format") != _FORMAT:
            raise ValueError(f"checkpoint format {meta.get('format')!r} is "
                             f"not {_FORMAT}")
        tleaves = list(_walk(template))
        tpaths = [p for p, _ in tleaves]
        source = {p: (shardings[p].leaf if p in shardings
                      and shardings[p].leaf is not None else p)
                  for p in tpaths}
        # a renamed leaf's weight (its module path) is stored under its
        # source's module path
        modules = {p.rsplit(".", 1)[0]: q.rsplit(".", 1)[0]
                   for p, q in source.items() if q != p}
        _check_weight_meta(meta.get("weights", {}), {
            modules.get(p, p): w for p, w in weight_meta(template).items()})
        # a template naming its leaves' sources holds only some of the
        # stored leaves (an expert-parallel rank's experts)
        named = any(r.leaf is not None for r in shardings.values())
        if (meta["leaves"] != tpaths if not named
                else not set(source.values()) <= set(meta["leaves"])):
            extra = set(meta["leaves"]) ^ set(source.values())
            raise ValueError("checkpoint tree does not match restore "
                             f"template (mismatched paths, e.g. "
                             f"{sorted(extra)[:3]})")
        unknown = set(shardings) - set(tpaths)
        if unknown:
            raise ValueError(f"shardings name paths the template lacks, "
                             f"e.g. {sorted(unknown)[:3]}")
        # every shape checked (from the members' headers) before a module
        # changes; then one leaf at a time, copied into its module in place
        index = {path: i for i, path in enumerate(meta["leaves"])}
        for path, leaf in tleaves:
            _check_shape(path, _header_shape(data, index[source[path]]),
                         leaf, shardings.get(path))
        leaves = dict(tleaves)

        def load(path):
            i, region = index[source[path]], shardings.get(path)
            arr = data[f"leaf_{i}"]
            if region is not None:
                arr = arr[region.index]
            return _from_host(arr, meta["dtypes"][i], leaves[path])

        return _rebuild(template, load), meta


class Region(NamedTuple):
    """One rank's piece of a leaf: the leaf's whole ``shape``, the
    ``index`` of the piece in it (a tuple of slices, or an integer array
    on a dim where the piece is several blocks) and ``leaf``, the stored
    leaf's path, given where the template holds only some of the stored
    leaves (an expert-parallel rank's experts, under their own names)."""

    shape: tuple
    index: tuple
    leaf: Optional[str] = None


def _header_shape(data, i: int) -> tuple:
    """The shape of the archive's leaf ``i``, read from its npy header
    alone (``data``: the ``np.load`` of the archive)."""
    readers = {(1, 0): np.lib.format.read_array_header_1_0,
               (2, 0): np.lib.format.read_array_header_2_0}
    with data.zip.open(f"leaf_{i}.npy") as f:
        return tuple(readers[np.lib.format.read_magic(f)](f)[0])


def _check_shape(path: str, stored: tuple, like, region) -> None:
    """Raise unless a stored leaf of shape ``stored`` (or its
    ``region``) has ``like``'s shape."""
    shape = tuple(like.shape) if hasattr(like, "shape") else ()
    if region is not None:
        if tuple(stored) != tuple(region.shape):
            raise ValueError(f"leaf {path}: checkpoint shape {stored} "
                             f"!= the sharding's whole shape "
                             f"{tuple(region.shape)}")
        stored = np.broadcast_to(False, stored)[region.index].shape
    if tuple(stored) != shape:
        raise ValueError(f"leaf {path}: checkpoint shape {stored} != "
                         f"template {shape}")


def _from_host(arr: np.ndarray, dtype: str, like):
    if not isinstance(like, torch.Tensor):
        return type(like)(arr.item()) if np.ndim(like) == 0 else arr
    t = torch.from_numpy(np.array(arr))  # a writable copy, 0-d kept
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device=like.device, dtype=like.dtype)


@torch.no_grad()
def _rebuild(tree: Any, load, path: str = ""):
    """``tree`` with each leaf ``load(path)``: a module's copied in
    place, one at a time."""
    def join(k):
        return f"{path}/{k}" if path else str(k)

    if isinstance(tree, nn.Module):
        for k, t in tree.state_dict(keep_vars=True).items():
            t.copy_(load(join(k)))
        return tree
    if isinstance(tree, dict):
        return {k: _rebuild(v, load, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, load, join(f"[{i}]"))
                          for i, v in enumerate(tree))
    return load(path)


def _check_weight_meta(stored: dict, want: dict) -> None:
    for path, tw in want.items():
        sw = stored.get(path)
        if sw is None:
            raise ValueError(
                f"checkpoint has no sparse-weight metadata for {path!r} "
                "(saved from a dense or differently sparsified model?)")
        for key in ("kind", "n", "m", "axis"):
            if sw.get(key) != tw.get(key):
                raise ValueError(
                    f"sparse-weight metadata mismatch at {path!r}: "
                    f"checkpoint {sw.get(key)!r} != template "
                    f"{tw.get(key)!r} for {key!r}")


# ---------------------------------------------------------------------------
# checkpoints the JAX package wrote
# ---------------------------------------------------------------------------


def _unflatten(pairs) -> Any:
    """A tree of dicts and lists from (path, array) pairs; a path part
    ``[i]`` is a list index."""
    root: dict = {}
    for path, arr in pairs:
        node = root
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr

    def fix(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(re.fullmatch(r"\[\d+\]", k) for k in keys):
            return [fix(node[f"[{i}]"]) for i in range(len(keys))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _node_at(tree, path: str):
    for part in path.split("/"):
        m = re.fullmatch(r"\[(\d+)\]", part)
        tree = tree[int(m.group(1))] if m else tree[part]
    return tree


def _mark_weights(tree, weights: dict, prefix: str) -> None:
    """Give every N:M weight node under ``prefix`` the metadata keys
    ``repro_torch.interop`` reads (n, m, axis, and mode of the policy)."""
    for path, w in weights.items():
        if not path.startswith(prefix + "/"):
            continue
        node = _node_at(tree, path[len(prefix) + 1:])
        node.update(n=w["n"], m=w["m"], axis=w["axis"])
        if w["kind"] != "masked":
            node["mode"] = w.get("policy", {}).get("mode", "off")


def read_jax_checkpoint(directory: str, cfg, *, step: Optional[int] = None,
                        dtype=torch.float32, device="cuda"):
    """(lm, opt_state, manifest) from a format-3 checkpoint of the JAX
    package's ``{"params": ..., "opt": adamw_init(...)}``. The moments
    are keyed by the LM's parameter names; the data cursor is
    ``manifest["extra"]["data"]``."""
    from repro_torch.interop import lm_from_jax

    meta, data = Checkpointer(directory)._load(step)
    if meta.get("format", 1) < 2 or "leaves" not in meta:
        raise ValueError("only format >= 2 checkpoints (with leaf paths) "
                         "are read; the legacy format is not ported")
    tree = _unflatten((p, data[f"leaf_{i}"])
                      for i, p in enumerate(meta["leaves"]))
    weights = meta.get("weights", {})
    params = tree["params"]
    _mark_weights(params, weights, "params")
    lm = lm_from_jax(cfg, params, dtype=dtype, device=device)
    opt = tree["opt"]
    moments = {}
    for part in ("m", "v"):
        _mark_weights(opt[part], weights, f"opt/{part}")
        for path, w in weights.items():
            if path.startswith(f"opt/{part}/") and w["kind"] != "masked":
                rel = path[len(f"opt/{part}/"):]
                # the moment trees hold a scalar placeholder for idx
                _node_at(opt[part], rel)["idx"] = _node_at(params, rel)["idx"]
        mlm = lm_from_jax(cfg, opt[part], dtype=torch.float32, device=device)
        moments[part] = {n: p.detach() for n, p in mlm.named_parameters()}
    dev = lm.device
    opt_state = {"step": torch.tensor(int(opt["step"]), dtype=torch.int32,
                                      device=dev), **moments}
    return lm, opt_state, meta
