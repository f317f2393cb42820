"""The port's fault tolerance: the JAX package's
``tests/test_fault_tolerance.py`` ported (injected failures, checkpoint
and restart, the data cursor resumed, stragglers), and a run of reduced
yi-9b through ``run_resilient`` with failures injected that ends
bit-identical to an uninterrupted run on the CPU (every step runs
exactly once, on its batch)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.models.transformer import LM
from repro_torch.optim.optimizer import AdamWConfig
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.fault_tolerance import (
    SimulatedFailure,
    StepTimer,
    run_resilient,
)
from repro_torch.training.train_loop import (
    TrainConfig,
    init_train_state,
    make_train_step,
)


def _toy_setup(tmp_path):
    """A tiny 'model' so steps are fast and deterministic."""

    def init_state():
        return {"w": torch.zeros(4), "n": 0}

    def train_step(state, batch):
        w = state["w"] + float(batch["tokens"].mean()) * 0.01
        s = {"w": w, "n": state["n"] + 1}
        return s, {"n": s["n"]}

    pipe = DataPipeline(PipelineConfig(vocab_size=64, seq_len=8,
                                       global_batch=4))
    return init_state, train_step, pipe, Checkpointer(str(tmp_path))


def test_run_without_failures(tmp_path):
    init_state, train_step, pipe, ckpt = _toy_setup(tmp_path)
    res = run_resilient(train_step=train_step, init_state=init_state,
                        pipeline=pipe, ckpt=ckpt, total_steps=25,
                        ckpt_every=10)
    assert res["restarts"] == 0 and res["steps_run"] == 25
    assert ckpt.latest_step() == 25


def test_survives_injected_failures(tmp_path):
    init_state, train_step, pipe, ckpt = _toy_setup(tmp_path)
    fail_at = {7, 13}

    def hook(step):
        if step in fail_at:
            fail_at.discard(step)
            raise SimulatedFailure(f"node lost at step {step}")

    res = run_resilient(train_step=train_step, init_state=init_state,
                        pipeline=pipe, ckpt=ckpt, total_steps=20,
                        ckpt_every=5, failure_hook=hook)
    assert res["restarts"] == 2
    assert res["final_state"]["n"] == 20  # every step ran exactly once


def test_resumed_run_matches_uninterrupted(tmp_path):
    init_a, step_a, pipe_a, ck_a = _toy_setup(tmp_path / "a")
    ref = run_resilient(train_step=step_a, init_state=init_a,
                        pipeline=pipe_a, ckpt=ck_a, total_steps=20,
                        ckpt_every=4)
    init_b, step_b, pipe_b, ck_b = _toy_setup(tmp_path / "b")
    flaky = {5, 11, 17}

    def hook(step):
        if step in flaky:
            flaky.discard(step)
            raise SimulatedFailure("boom")

    res = run_resilient(train_step=step_b, init_state=init_b,
                        pipeline=pipe_b, ckpt=ck_b, total_steps=20,
                        ckpt_every=4, failure_hook=hook)
    assert torch.equal(ref["final_state"]["w"], res["final_state"]["w"])


def test_too_many_failures_raises(tmp_path):
    init_state, train_step, pipe, ckpt = _toy_setup(tmp_path)

    def hook(step):
        raise SimulatedFailure("always down")

    with pytest.raises(SimulatedFailure):
        run_resilient(train_step=train_step, init_state=init_state,
                      pipeline=pipe, ckpt=ckpt, total_steps=5,
                      ckpt_every=2, failure_hook=hook, max_restarts=3)


def test_straggler_detection():
    t = StepTimer(straggler_factor=3.0)
    for _ in range(10):
        assert not t.record(1.0)
    assert t.record(10.0)
    assert not t.record(1.1)


def _lm_run(tmp_path, failures):
    """Reduced yi-9b (f32 weights, bf16 compute) for 6 steps through
    run_resilient, a checkpoint every 2 steps."""
    cfg = get_reduced("yi-9b")
    tc = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=6), remat="none")

    def init_state():
        lm = LM.init(cfg, seed=0, dtype=torch.float32,
                     device="cpu").set_compute_dtype(torch.bfloat16)
        lm, opt = init_train_state(lm, tc)
        return {"params": lm, "opt": opt}

    step = make_train_step(init_state()["params"], tc)

    def train_step(state, batch):
        lm, opt, metrics = step(state["params"], state["opt"], batch)
        return {"params": lm, "opt": opt}, metrics

    left = set(failures)

    def hook(s):
        if s in left:
            left.discard(s)
            raise SimulatedFailure(f"lost at {s}")

    pipe = DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                       seq_len=16, global_batch=4))
    return run_resilient(train_step=train_step, init_state=init_state,
                         pipeline=pipe, ckpt=Checkpointer(str(tmp_path)),
                         total_steps=6, ckpt_every=2, failure_hook=hook)


def test_resilient_lm_run_matches_uninterrupted(tmp_path):
    ref = _lm_run(tmp_path / "a", ())
    res = _lm_run(tmp_path / "b", (1, 3, 4))
    assert res["restarts"] == 3
    assert float(ref["metrics"]["loss"]) == float(res["metrics"]["loss"])
    a, b = ref["final_state"], res["final_state"]
    for (n, p), (_, q) in zip(a["params"].named_parameters(),
                              b["params"].named_parameters()):
        assert torch.equal(p, q), n
    assert int(b["opt"]["step"]) == 6
    for n in a["opt"]["m"]:
        assert torch.equal(a["opt"]["m"][n], b["opt"]["m"][n])
    assert np.isfinite(float(res["metrics"]["grad_norm"]))
