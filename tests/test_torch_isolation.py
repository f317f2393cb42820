"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card unless told otherwise."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def test_module_walk_covers_the_int8_slice():
    """Both checks below walk the package tree, so new modules are
    covered as they land; the int8 slice's are among them."""
    assert {"repro_torch.api", "repro_torch.quant",
            "repro_torch.quant.calibrate",
            "repro_torch.quant.qnmweight"} <= set(_port_modules())


def test_module_walk_covers_the_cnn_and_gather_slice():
    assert {"repro_torch.configs.resnet50", "repro_torch.configs.densenet121",
            "repro_torch.core.cost_model", "repro_torch.core.sparse_matmul",
            "repro_torch.models.conv", "repro_torch.kernels.indexmac_gather",
            "repro_torch.kernels.indexmac_gather.kernel",
            "repro_torch.kernels.indexmac_gather.ops",
            "repro_torch.kernels.indexmac_gather.ref"} <= set(_port_modules())


def test_module_walk_covers_the_blocksparse_slice():
    assert {"repro_torch.kernels.blocksparse_attn",
            "repro_torch.kernels.blocksparse_attn.kernel",
            "repro_torch.kernels.blocksparse_attn.mask",
            "repro_torch.kernels.blocksparse_attn.ops",
            "repro_torch.kernels.blocksparse_attn.ref"} <= set(_port_modules())
    assert (PORT / "kernels" / "blocksparse_attn" / "csrc"
            / "bs_attention.cu").is_file()


def test_module_walk_covers_the_training_slice():
    assert {"repro_torch.data.pipeline", "repro_torch.optim",
            "repro_torch.optim.optimizer", "repro_torch.training.checkpoint",
            "repro_torch.training.fault_tolerance",
            "repro_torch.training.train_loop",
            "repro_torch.launch.train"} <= set(_port_modules())


def test_module_walk_covers_the_multi_device_slice():
    assert {"repro_torch.parallel", "repro_torch.parallel.sharding",
            "repro_torch.parallel.hints", "repro_torch.launch.mesh",
            "repro_torch.launch.sharded",
            "repro_torch.configs.deepseek_v2_236b"} <= set(_port_modules())


def test_module_walk_covers_the_sharded_training_slice():
    assert {"repro_torch.training.sharded", "repro_torch.launch.sharded",
            "repro_torch.parallel.sharding"} <= set(_port_modules())


def test_module_walk_covers_the_sharded_moe_and_recurrent_slice():
    """The modules this slice changed (the training plan, the
    tensor-parallel Mamba and RWKV, the expert-parallel MoE under the
    train step, the checkpoint's regions, the shard-wise reference)."""
    assert {"repro_torch.parallel.sharding", "repro_torch.models.mamba",
            "repro_torch.models.rwkv", "repro_torch.models.moe",
            "repro_torch.models.ffn", "repro_torch.training.sharded",
            "repro_torch.training.checkpoint",
            "repro_torch.launch.sharded"} <= set(_port_modules())


def test_module_walk_covers_the_dryrun_slice():
    """The dry-run and roofline layer, and the modules it changed (the
    card's kernel costs, the meta backend, the meta mesh, count_params,
    the scans' and microbatches' trip counts)."""
    assert {"repro_torch.roofline", "repro_torch.roofline.analysis",
            "repro_torch.roofline.report", "repro_torch.roofline.step_cost",
            "repro_torch.core.scan", "repro_torch.launch.specs",
            "repro_torch.launch.dryrun", "repro_torch.launch.hillclimb",
            "repro_torch.launch.mesh", "repro_torch.core.cost_model",
            "repro_torch.kernels.registry", "repro_torch.models.transformer",
            "repro_torch.models.mamba", "repro_torch.models.rwkv",
            "repro_torch.training.sharded"} <= set(_port_modules())


EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


def test_the_port_has_the_three_examples():
    assert [p.name for p in EXAMPLES] == [
        "torch_quickstart.py", "torch_serve_decode.py",
        "torch_train_sparse_lm.py"]


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_examples_import_no_jax_or_repro(path):
    """The port's examples, run whole: importing each module they import
    loads no JAX and nothing of the JAX package."""
    tree = ast.parse(path.read_text())
    mods = sorted({n.module for n in ast.walk(tree)
                   if isinstance(n, ast.ImportFrom) and n.module}
                  | {a.name for n in ast.walk(tree)
                     if isinstance(n, ast.Import) for a in n.names})
    assert not [m for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "repro")], mods
    code = ("import importlib, sys\n"
            f"for name in {mods!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def test_importing_every_port_module_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for name in {_port_modules()!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_no_jax_or_repro_import_statements(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}")


def test_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import build_model
    from repro_torch.models.common import resolve_device
    from repro_torch.models.transformer import LM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM.init(get_reduced("yi-9b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("yi-9b", full=False, kernels=True)
    assert resolve_device("cpu") == torch.device("cpu")


def test_cnn_entry_point_defaults_to_the_card(monkeypatch):
    from repro_torch.configs import get_cnn_reduced
    from repro_torch.models.conv import SparseCNN

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseCNN.init(get_cnn_reduced("resnet50"))
    model = SparseCNN.init(get_cnn_reduced("resnet50"), device="cpu")
    assert model.head.w.device == torch.device("cpu")


def test_serve_cli_runs_on_the_cpu_when_asked():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--dtype", "f32", "--kernels", "--requests", "3", "--slots", "2",
         "--prefill-len", "8", "--max-new", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "served 3 requests, 9 tokens" in out.stdout


def test_train_cli_runs_on_the_cpu_when_asked(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "12", "--batch", "4", "--seq", "32", "--warmup", "4",
         "--log-every", "6", "--ckpt-dir", str(tmp_path), "--ckpt-every",
         "6"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "yi-9b-reduced: 2 layers" in out.stdout
    assert "step    12 loss" in out.stdout
    assert "first-6 mean loss" in out.stdout
    assert sorted(os.listdir(tmp_path)) == ["step_00000006",
                                            "step_00000012"]


def test_train_entry_point_defaults_to_the_card(monkeypatch):
    from repro_torch.launch.train import build_trainer
    from repro_torch.training.train_loop import TrainConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_trainer("yi-9b", full=False, tcfg=TrainConfig())


def test_serve_cli_int8_runs_on_the_cpu_when_asked():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--dtype", "f32", "--kernels", "--quantize", "int8", "--requests",
         "3", "--slots", "2", "--prefill-len", "8", "--max-new", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "int8 weights" in out.stdout
    assert "served 3 requests, 9 tokens" in out.stdout


def test_profile_cnn_cli_runs_on_the_cpu_when_asked():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.profile_cnn", "--device",
         "cpu", "--reduced", "--arch", "densenet121", "--quantize", "int8",
         "--batch", "2", "--iters", "1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "logits (2, 10)" in out.stdout
    assert "nm_matmul_q/nm_spmm_q/cpu=9" in out.stdout


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
