"""The dry-run on the host: models made on the meta device, a rank's cell
against the tensors a real CPU rank holds, the step cost against a real
CPU run (the N:M ops' kept non-zeros, aten's FLOPs by FlopCounterMode,
the scans' trip counts, the collectives) and the CLI's JSON against the
JAX package's keys."""
import dataclasses
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.roofline import analysis as janalysis
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import scan
from repro_torch.launch import hillclimb
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import MetaMesh, make_production_mesh
from repro_torch.launch.specs import (
    make_cell,
    model_bytes,
    serve_shard,
    tree_bytes,
    with_kernels,
)
from repro_torch.models.common import Linear
from repro_torch.models.transformer import LM, count_params
from repro_torch.parallel.sharding import init_sharded, train_tp_plan
from repro_torch.roofline.step_cost import step_cost
from repro_torch.training.sharded import (
    init_sharded_train_state,
    make_sharded_train_step,
)
from repro_torch.training.train_loop import TrainConfig

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TRAIN = ShapeConfig("train", 16, 4, "train")
DECODE = ShapeConfig("decode", 24, 4, "decode")
PREFILL = ShapeConfig("prefill", 12, 4, "prefill")


def cpu_mesh(data, model):
    """The last rank of a data x model mesh on the CPU, recording its
    collectives as the meta one does (a copy stands for each result)."""
    return MetaMesh(data, model, data * model - 1, device=CPU)


def kinds(mesh) -> dict:
    """{kind: operand bytes} of the collectives ``mesh`` recorded."""
    out = {}
    for kind, _, nbytes in mesh.log:
        out[kind] = out.get(kind, 0) + nbytes
    return out


def _tensors(lm):
    return list(lm.parameters()) + list(lm.buffers())


@pytest.mark.parametrize("arch", ["yi-9b", "jamba-v0.1-52b"])
def test_full_width_model_on_meta_allocates_nothing(arch):
    cfg = get_config(arch)
    lm = LM.init(cfg, device="meta", dtype=torch.bfloat16)
    assert all(t.is_meta for t in _tensors(lm))
    assert sum(p.numel() for p in lm.parameters()
               if p.is_floating_point()) == count_params(cfg)


def test_production_meshes():
    single, multi = make_production_mesh(), make_production_mesh(True)
    assert (single.data, single.model, single.world) == (16, 16, 256)
    assert (multi.data, multi.model, multi.world) == (32, 16, 512)
    assert single.device == torch.device("meta") and single.coords == (0, 0)
    assert make_production_mesh(rank=37).coords == (2, 5)


def _real_rank(arch, kind, mesh, shape):
    """(params and buffers, optimizer state, cache) bytes of a real CPU
    rank made as ``make_cell`` makes its meta one."""
    cfg = with_kernels(get_reduced(arch))
    if kind == "train":
        lm = init_sharded(cfg, mesh, plan=train_tp_plan(cfg, mesh.model),
                          dtype=torch.float32)
        lm.set_compute_dtype(torch.bfloat16)
        lm, opt = init_sharded_train_state(lm, TrainConfig(), mesh)
        return model_bytes(lm), tree_bytes(opt), 0
    lm, _ = serve_shard(cfg, mesh)
    slots = shape.global_batch // mesh.data
    return model_bytes(lm), 0, tree_bytes(lm.init_cache(slots,
                                                        shape.seq_len))


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("dm", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v2-lite-16b",
                                  "rwkv6-3b"])
def test_cell_arguments_equal_a_real_rank(arch, dm, kind):
    """A rank's argument bytes on meta are the bytes of the tensors the
    same rank holds when made on the CPU: params (FSDP slices at 2x2),
    AdamW's m and v, or the serving shard and its cache."""
    shape = TRAIN if kind == "train" else DECODE
    cell = make_cell(arch, shape.name, MetaMesh(*dm, dm[0] * dm[1] - 1),
                     cfg_override=get_reduced(arch), shape_override=shape)
    assert all(t.is_meta for t in _tensors(cell.lm))
    mem = cell.memory
    real = _real_rank(arch, kind, cpu_mesh(*dm), shape)
    assert (mem["params_bytes"], mem["optimizer_bytes"],
            mem["cache_bytes"]) == real
    assert mem["argument_size_in_bytes"] == sum(real) + mem["batch_bytes"]


def _nm_linears(lm):
    return [m for m in lm.modules() if isinstance(m, Linear)
            and m.nm is not None]


@pytest.mark.parametrize("shape", [DECODE, PREFILL], ids=["decode",
                                                          "prefill"])
def test_step_cost_against_a_real_cpu_step(shape):
    """The N:M ops: one dispatch a compressed Linear, 2 M a kept value;
    aten's FLOPs outside them: FlopCounterMode's on the same step run on
    the CPU, less the CPU reference's dense products (2 M K N) that the
    kernels replace."""
    cfg = get_reduced("yi-9b")
    cell = make_cell("yi-9b", shape.name, MetaMesh(1, 1, 0),
                     cfg_override=cfg, shape_override=shape)
    cost = step_cost(cell.fn, *cell.args)
    lins = _nm_linears(cell.lm)
    rows = shape.global_batch * (1 if shape.kind == "decode"
                                 else shape.seq_len)
    assert sum(cost["dispatches"].values()) == len(lins)
    assert cost["op_flops"] == sum(2 * rows * m.vals.numel() for m in lins)

    mesh = cpu_mesh(1, 1)
    real = make_cell("yi-9b", shape.name, mesh, cfg_override=cfg,
                     shape_override=shape)
    caches, kw = real.args
    kw = dict(kw, tokens=torch.randint(0, cfg.vocab_size,
                                       kw["tokens"].shape))
    with FlopCounterMode(display=False) as fc:
        real.fn(caches, kw)
    dense = sum(2 * rows * m.vals.shape[0] * 2 * m.vals.shape[1]
                for m in _nm_linears(real.lm))
    assert fc.get_total_flops() == cost["aten_flops"] + dense


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_scan_trip_counts_equal_the_whole_loop(arch, kind, monkeypatch):
    """A recurrent scan run at steps 0, 1, s - 2 and s - 1, step 1
    charged for steps 1 to s - 3 (forward, and the backward of what it
    made), counts what the whole loop counts."""
    shape = dataclasses.replace(TRAIN if kind == "train" else PREFILL,
                                seq_len=8)

    def cost():
        cell = make_cell(arch, shape.name, MetaMesh(1, 1, 0),
                         cfg_override=get_reduced(arch), shape_override=shape,
                         microbatches=1, remat="none")
        return step_cost(cell.fn, *cell.args)

    weighted = cost()
    monkeypatch.setattr(scan, "active", lambda: None)  # the plain loop
    whole = cost()
    for key in ("flops", "bytes", "aten_flops", "op_flops"):
        assert weighted[key] == whole[key], key
    assert weighted["dispatches"] == whole["dispatches"]


def test_meta_mesh_records_the_collectives_of_a_real_cpu_step():
    """The 2x2 fsdp train step of reduced yi-9b on meta makes the same
    collectives, kind, axis and operand bytes in order, as the same
    rank's step on real CPU tensors (a recording mesh in one process)."""
    cfg = with_kernels(get_reduced("yi-9b"))
    tcfg = TrainConfig(microbatches=2)
    cell = make_cell("yi-9b", "train", MetaMesh(2, 2, 3), cfg_override=cfg,
                     shape_override=TRAIN, microbatches=2)
    cell.mesh.log.clear()
    cost = step_cost(cell.fn, *cell.args)

    mesh = cpu_mesh(2, 2)
    lm = init_sharded(cfg, mesh, plan=train_tp_plan(cfg, 2),
                      dtype=torch.float32)
    lm.set_compute_dtype(torch.bfloat16)
    lm, opt = init_sharded_train_state(lm, tcfg, mesh)
    step = make_sharded_train_step(lm, tcfg, mesh)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen,
                         dtype=torch.int32)
    mesh.log.clear()
    step(lm, opt, {"tokens": toks, "labels": toks})
    assert mesh.log and cell.mesh.log == mesh.log
    assert cost["collectives"] == kinds(mesh)
    axes = {}
    for _, axis, nbytes in mesh.log:
        axes[axis] = axes.get(axis, 0) + nbytes
    assert cost["collective_axes"] == axes


def test_microbatch_trip_counts_equal_the_whole_loop(monkeypatch):
    """The train step's 8 microbatches run as 4 (step 1 charged for 5):
    the same FLOPs, bytes, dispatches and collectives as all 8."""
    shape = ShapeConfig("train", 16, 8, "train")

    def cost():
        cell = make_cell("yi-9b", "train", MetaMesh(1, 2, 1),
                         cfg_override=get_reduced("yi-9b"),
                         shape_override=shape, microbatches=8)
        return step_cost(cell.fn, *cell.args), cell.mesh

    weighted, _ = cost()
    monkeypatch.setattr(scan, "active", lambda: None)  # and no count
    whole, mesh = cost()  # of the collectives but the mesh's own
    assert weighted["dispatches"] == whole["dispatches"] == {
        ("nm_matmul", "meta"): 8 * 14 * 2}  # a forward, and its remat
    for key in ("flops", "bytes"):
        assert weighted[key] == whole[key], key
    assert weighted["collectives"] == kinds(mesh)


def test_dryrun_cli_writes_jax_keys(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--reduced",
         "--arch", "yi-9b", "--shape", "decode_32k", "--mesh", "both",
         "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "all dry-run cells ran OK" in out.stdout
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["yi-9b_decode_32k_multi_sparse_fsdp.json",
                     "yi-9b_decode_32k_single_sparse_fsdp.json"]
    jax_keys = set(janalysis.RooflineReport(
        "c", 1, 1.0, 1.0, 0.0, {}, 1.0, {}).to_json()) | {
        "arch", "shape", "mesh", "sparse", "sharding", "t_lower_s",
        "t_compile_s"}
    for name in files:
        row = json.loads((tmp_path / name).read_text())
        assert jax_keys <= set(row)
        assert row["memory"]["argument_size_in_bytes"] > 0
        assert row["dispatches"] == {"nm_matmul_decode/meta": 14}


def test_production_decode_cell_on_the_host():
    """A full-width cell of the 16 x 16 mesh: yi-9b's decode_32k rank
    holds its FFN's 1/16 (d_ff 11008 divides, the 4 KV heads do not:
    attention whole) and 8 slots of 32,768 positions."""
    row = run_cell("yi-9b", "decode_32k", "single", sparse=True,
                   sharding_mode="fsdp", out_dir=None, verbose=False)
    cfg = get_config("yi-9b")
    cache = 48 * 2 * 8 * 32_768 * 4 * 128 * 2  # layers, k / v, slots, ...
    assert row["memory"]["cache_bytes"] == cache
    assert row["dispatches"] == {"nm_matmul_decode/meta": 48 * 7}
    assert row["bottleneck"] == "memory" and row["chips"] == 256
    assert row["model_flops"] == 2.0 * count_params(
        cfg, active_only=True) * 128


def test_hillclimb_variants_name_run_cell_knobs():
    params = set(inspect.signature(run_cell).parameters)
    for spec in hillclimb.CELLS.values():
        assert set(spec["base"]) <= params
        for tag, kw in spec["variants"]:
            assert set(kw) <= params, tag
            assert "gather_compressed" not in tag
