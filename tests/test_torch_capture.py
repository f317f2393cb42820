"""CUDA-graph capture on the CPU: ``kernels.capture.Graphed`` and
``SparseCNN.graphed`` run eagerly there (a graph is a card's), with the
same result as the plain call.

On the card the same API captures one graph per input signature and
replays it; ``tests/test_torch_gpu.py`` holds the replays bit-equal to
eager forwards.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_cnn_reduced
from repro_torch.kernels import capture, registry
from repro_torch.models.conv import SparseCNN


def _cnn(arch, quantize):
    cfg = get_cnn_reduced(arch)
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, use_kernel=True))
    return cfg, SparseCNN.init(cfg, seed=0, device="cpu", quantize=quantize)


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("arch", ["resnet50", "densenet121"])
def test_graphed_cnn_equals_forward_on_the_cpu(arch, quantize):
    cfg, model = _cnn(arch, quantize)
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal(
        (2, cfg.input_hw, cfg.input_hw, 3)).astype(np.float32))
        for _ in range(2)]
    with torch.inference_mode():
        for x in xs:  # a second call of the signature: eager again
            registry.clear_history()
            got = model.graphed(x)
            counts = registry.dispatch_counts()
            assert torch.equal(got, model(x))
            op = "nm_matmul_q" if quantize else "nm_matmul"
            impl = "nm_spmm_q" if quantize else "nm_spmm"
            assert set(counts) == {(op, impl, "cpu")}
    assert model.graphs_captured() == []  # no graph on the CPU
    g, = model._graphs.values()
    assert not g.graphed and len(g.built) == 1  # one signature


def test_graphed_keeps_held_and_checks_inputs():
    """``Graphed`` on the CPU: the check sees the inputs as given, held
    arguments pass through, None inputs are dropped, each signature is
    counted once."""
    seen = []

    def fn(state, *, a, b=None):
        assert b is None
        state.append(a.sum())
        return a * 2

    def check(state, **inputs):
        seen.append(sorted(inputs))

    g = capture.Graphed(fn, device=torch.device("cpu"), check=check)
    state = []
    out = g(state, a=np.arange(4, dtype=np.float32), b=None)
    assert torch.equal(out, torch.arange(4, dtype=torch.float32) * 2)
    g(state, a=np.ones(4, dtype=np.float32))
    g(state, a=np.ones(5, dtype=np.float32))
    assert seen == [["a"]] * 3 and len(state) == 3
    assert len(g.built) == 2 and g.captured == [] and g.replayed is None


def test_ran_counts_count_each_replay():
    """The capture counted once, the replays run: count x replays."""
    rec = capture.CapturedStep(("sig",), {("op", "impl", "cuda"): 2},
                               {"k": 3}, replays=5)
    d, n = capture.ran_counts([rec], {("op", "impl", "cuda"): 4},
                              {"k": 6, "j": 1})
    assert d == {("op", "impl", "cuda"): 4 + 2 * 4}
    assert n == {"k": 6 + 3 * 4, "j": 1}
