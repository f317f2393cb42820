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


def test_serve_cli_runs_on_the_cpu_when_asked():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--dtype", "f32", "--kernels", "--requests", "3", "--slots", "2",
         "--prefill-len", "8", "--max-new", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "served 3 requests, 9 tokens" in out.stdout


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


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
