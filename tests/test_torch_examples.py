"""The port's examples (``examples/torch_*.py``, the counterparts of the
JAX package's ``quickstart.py``, ``serve_decode.py`` and
``train_sparse_lm.py``) run as subprocesses, the way a user runs them,
with ``--device cpu`` (each runs on the card by default), and print the
JAX examples' marker lines. Each subprocess runs one intra-op thread
beside the suite's workers; the training example runs 3 steps of its
model cut to one layer (the 10-layer model's plain CPU steps take about
15 s each: every compressed product decompresses its weight there)."""
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run_example(name: str, *args: str, timeout: int = 300):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, str(REPO / "examples" / name), "--device", "cpu",
         *args], capture_output=True, text=True, timeout=timeout, env=env,
        cwd=str(REPO))


def _assert_ok(out, name):
    assert out.returncode == 0, (
        f"{name} failed\n--- stdout ---\n{out.stdout[-2000:]}\n"
        f"--- stderr ---\n{out.stderr[-2000:]}")


def test_torch_quickstart_runs_end_to_end():
    out = _run_example("torch_quickstart.py")
    _assert_ok(out, "torch_quickstart.py")
    assert "kernel vs dense max err" in out.stdout
    assert "model carries 14 NMWeight nodes" in out.stdout
    assert "quickstart OK" in out.stdout


def test_torch_serve_decode_example_runs():
    out = _run_example("torch_serve_decode.py")
    _assert_ok(out, "torch_serve_decode.py")
    assert "served 10 requests" in out.stdout
    assert "serve_decode OK" in out.stdout


def test_torch_train_sparse_lm_example_runs():
    out = _run_example("torch_train_sparse_lm.py", "--steps", "3",
                       "--layers", "1", "--batch", "2", "--seq", "16")
    _assert_ok(out, "torch_train_sparse_lm.py")
    assert "steps=3 loss" in out.stdout
    assert "train_sparse_lm OK" in out.stdout


def test_examples_default_to_the_card():
    """Without a card and without ``--device cpu`` an example raises at
    its device check (the port runs on the card unless asked)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_quickstart.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(REPO))
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
