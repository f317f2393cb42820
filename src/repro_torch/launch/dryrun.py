"""The dry-run: every (arch x shape x mesh) cell's memory, step cost and
roofline terms on the card, on the host (port of
``repro.launch.dryrun``). One rank's shard and step are made and run on
the meta device (``launch.specs``, ``roofline.step_cost``) and
analysed against the card's spec-sheet rates (``roofline.analysis``);
no card is needed and nothing is allocated.

    python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k \\
        --mesh single|multi|both [--dense] [--sharding fsdp|tp_only] \\
        --out DIR
    python -m repro_torch.launch.dryrun --all --out DIR
    python -m repro_torch.launch.dryrun --arch yi-9b \\
        --arch deepseek-v2-236b --out DIR   # each arch's runnable shapes

``--reduced`` runs each cell's reduced config (``get_reduced``) with its
shape cut to 64 positions and 8 sequences on a 2 x 2 ("single") or 4 x 2
("multi") mesh: a CPU-sized smoke of the same path.

Each cell writes ``{arch}_{shape}_{mesh}_{sparse|dense}_{sharding}{tag}
.json`` with the JAX package's keys (the report's fields and terms,
``arch``, ``shape``, ``mesh``, ``sparse``, ``sharding``, ``t_lower_s``:
the seconds to make the cell, ``t_compile_s``: the seconds to run its
step on meta), plus ``dispatches`` (the port's ops by (op, impl)).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, get_reduced, runnable_shapes
from repro_torch.launch.mesh import MetaMesh, make_production_mesh
from repro_torch.launch.specs import make_cell
from repro_torch.roofline.analysis import analyze
from repro_torch.roofline.step_cost import step_cost

CACHE_DTYPES = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


def reduced_cell(arch: str, shape: str, mesh_kind: str,
                 sparse: bool) -> dict:
    """``run_cell``'s overrides of a ``--reduced`` cell."""
    full = SHAPES[shape]
    return dict(mesh=MetaMesh(4 if mesh_kind == "multi" else 2, 2, 0),
                cfg_override=get_reduced(arch, sparse=sparse),
                shape_override=dataclasses.replace(
                    full, seq_len=min(full.seq_len, 64),
                    global_batch=min(full.global_batch, 8)))


def run_cell(arch: str, shape: str, mesh_kind: str, *, sparse: bool,
             sharding_mode: str, out_dir: str | None,
             microbatches: int = 8, attn_chunk=None, tag: str = "",
             remat: str = "dots", cache_dtype: str = "bf16", mesh=None,
             cfg_override=None, shape_override=None,
             verbose: bool = True) -> dict:
    """One cell on the production mesh of ``mesh_kind`` ("single": 16 x
    16, "multi": 32 x 16), or on ``mesh`` (a ``MetaMesh``) where given;
    returns the JSON it writes under ``out_dir``."""
    mesh = mesh or make_production_mesh(multi_pod=(mesh_kind == "multi"))
    t0 = time.time()
    cell = make_cell(arch, shape, mesh, sparse=sparse,
                     sharding_mode=sharding_mode, microbatches=microbatches,
                     attn_chunk=attn_chunk, remat=remat,
                     cfg_override=cfg_override,
                     shape_override=shape_override,
                     cache_dtype=CACHE_DTYPES[cache_dtype])
    t_make = time.time() - t0
    cost = step_cost(cell.fn, *cell.args)
    t_run = time.time() - t0 - t_make
    rep = analyze(cell.name + tag, cost, cell.chips, cell.model_flops,
                  cell.memory,
                  mesh_shape={"data": mesh.data, "model": mesh.model})
    result = rep.to_json()
    result.update(arch=arch, shape=shape, mesh=mesh_kind, sparse=sparse,
                  sharding=sharding_mode, t_lower_s=round(t_make, 1),
                  t_compile_s=round(t_run, 1),
                  dispatches={f"{op}/{impl}": n for (op, impl), n
                              in sorted(cost["dispatches"].items())})
    mem = result["memory"]
    if verbose:
        print(f"[ok] {cell.name}{tag}: args "
              f"{mem['argument_size_in_bytes'] / 2**30:.2f} GiB/dev, "
              f"t_comp {rep.t_compute * 1e3:.1f} ms, t_mem "
              f"{rep.t_memory * 1e3:.1f} ms, t_coll "
              f"{rep.t_collective * 1e3:.1f} ms -> {rep.bottleneck} "
              f"(make {t_make:.0f}s, step {t_run:.0f}s)", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = (f"{arch}_{shape}_{mesh_kind}_"
                 f"{'sparse' if sparse else 'dense'}_{sharding_mode}{tag}"
                 ".json")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=1)
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), action="append",
                    help="repeatable; without --shape every runnable "
                         "shape of each")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--sharding", default="fsdp",
                    choices=["fsdp", "tp_only"])
    ap.add_argument("--microbatches", type=int, default=16)
    ap.add_argument("--remat", default="full",
                    choices=["none", "dots", "full"])
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced configs, shapes and meshes (CPU smoke)")
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in ARCHS for s in runnable_shapes(a)]
    elif args.arch:
        cells = [(a, s) for a in args.arch
                 for s in ([args.shape] if args.shape
                           else runnable_shapes(a))]
    else:
        ap.error("--arch [--shape], or --all")

    failures = []
    for arch, shape in cells:
        for mk in meshes:
            fname = (f"{arch}_{shape}_{mk}_"
                     f"{'dense' if args.dense else 'sparse'}_"
                     f"{args.sharding}{args.tag}.json")
            if args.skip_existing and os.path.exists(
                    os.path.join(args.out, fname)):
                print(f"[skip] {arch}|{shape}|{mk} (exists)", flush=True)
                continue
            try:
                run_cell(arch, shape, mk, sparse=not args.dense,
                         sharding_mode=args.sharding, out_dir=args.out,
                         microbatches=args.microbatches,
                         attn_chunk=args.attn_chunk, tag=args.tag,
                         remat=args.remat,
                         **(reduced_cell(arch, shape, mk, not args.dense)
                            if args.reduced else {}))
            except Exception as e:  # noqa: BLE001 (every cell's failure)
                failures.append((arch, shape, mk, repr(e)))
                print(f"[FAIL] {arch}|{shape}|{mk}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: "
                         + "; ".join(f"{a}|{s}|{m}" for a, s, m, _
                                     in failures))
    print("all dry-run cells ran OK")


if __name__ == "__main__":
    main()
