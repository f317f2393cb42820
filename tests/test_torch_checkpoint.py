"""The port's checkpoints: the JAX package's ``tests/test_checkpoint.py``
ported (roundtrip, async save and gc, a given step, shape and N:M
metadata checks; not its legacy-format or elastic cases, which are not
ported), a train state that resumes bit-identically on the CPU, and a
checkpoint written by the JAX package's ``Checkpointer`` read by
``read_jax_checkpoint``: its logits and its next train step against
JAX's (f32; logits to 1e-4 as in ``tests/test_torch_model.py``, the step
as in ``tests/test_torch_training.py``: loss, lr and grad_norm to 1e-5
relative, parameters and moments to 2e-5)."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.data.pipeline import DataPipeline as JaxPipeline
from repro.data.pipeline import PipelineConfig as JaxPipelineConfig
from repro.models import common as jcommon
from repro.models.cache import CacheView as JaxCacheView
from repro.models.transformer import LM as JaxLM
from repro.optim.optimizer import AdamWConfig as JaxAdamW
from repro.optim.optimizer import adamw_init as jax_adamw_init
from repro.training import train_loop as jtrain
from repro.training.checkpoint import Checkpointer as JaxCheckpointer
from repro_torch.api import sparsify
from repro_torch.configs import get_reduced
from repro_torch.core.nmweight import KernelPolicy, MaskedNMWeight
from repro_torch.core.sparsity import NMConfig
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.models.common import Linear, RMSNorm
from repro_torch.models.transformer import LM
from repro_torch.optim.optimizer import AdamWConfig
from repro_torch.training.checkpoint import Checkpointer, read_jax_checkpoint
from repro_torch.training.train_loop import (
    TrainConfig,
    init_train_state,
    make_train_step,
)

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 8, generator=g),
                       "idx": torch.arange(16, dtype=torch.int8)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "m": torch.ones(8, 8)}}


def _equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    else:
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    st = _state()
    ck.save(10, st, extra={"data": {"step": 10, "seed": 0}})
    got, meta = ck.restore(_state(1))
    assert meta["step"] == 10 and meta["format"] == 3
    assert meta["extra"]["data"]["step"] == 10
    _equal(got, st)


def test_async_save_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(s), async_=True)
    ck.wait()
    assert ck.list_steps() == [3, 4]
    got, meta = ck.restore(_state(0))
    assert meta["step"] == 4
    _equal(got, _state(4))


def test_restore_specific_step(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    ck.save(1, _state(1))
    ck.save(2, _state(2))
    got, _ = ck.restore(_state(0), step=1)
    _equal(got, _state(1))


def test_shape_and_path_mismatch_rejected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore({"w": torch.ones(5)})
    with pytest.raises(ValueError, match="does not match"):
        ck.restore({"v": torch.ones(4)})


def test_bf16_and_number_leaves_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    st = {"b": torch.randn(3, 5).to(torch.bfloat16), "n": 7, "x": 0.25}
    ck.save(1, st)
    got, _ = ck.restore({"b": torch.zeros(3, 5, dtype=torch.bfloat16),
                         "n": 0, "x": 0.0})
    assert torch.equal(got["b"], st["b"]) and got["b"].dtype == torch.bfloat16
    assert got["n"] == 7 and isinstance(got["n"], int) and got["x"] == 0.25


def _weights(seed):
    g = torch.Generator().manual_seed(seed)
    w24 = sparsify(torch.randn(16, 8, generator=g), NMConfig(2, 4),
                   kernel_policy=KernelPolicy("auto", block=(64, 64, 32)))
    w14 = sparsify(torch.randn(16, 4, generator=g), NMConfig(1, 4),
                   kernel_policy="off")
    masked = MaskedNMWeight(torch.randn(8, 8, generator=g), NMConfig(2, 4))
    return torch.nn.ModuleDict({
        "ffn": Linear(w24), "attn": Linear(w14), "masked": Linear(masked),
        "norm": RMSNorm(torch.rand(8, generator=g))})


def test_nmweight_roundtrip_bit_exact(tmp_path):
    """A module of N:M weights restores into a fresh one: vals, idx and
    the masked storage bit-exact, the manifest carrying each weight's
    kind, pattern, axis and policy."""
    ck = Checkpointer(str(tmp_path))
    st = {"params": _weights(0)}
    ck.save(5, st)
    fresh = {"params": _weights(1)}
    got, meta = ck.restore(fresh)
    assert got["params"] is fresh["params"]  # loaded in place
    for (n, a), (_, b) in zip(st["params"].state_dict().items(),
                              got["params"].state_dict().items()):
        assert torch.equal(a, b), n
    w = meta["weights"]
    assert {v["n"] for v in w.values()} == {1, 2}
    assert w["params/ffn"] == {"kind": "compressed", "n": 2, "m": 4,
                               "axis": 0, "policy": {
                                   "mode": "auto", "block": [64, 64, 32],
                                   "decode_block": None, "backend": "auto"}}
    assert w["params/masked"]["kind"] == "masked"


def test_nm_metadata_mismatch_rejected(tmp_path):
    """A 2:4 checkpoint must not restore into a 2:8 weight of the same
    tensor shapes."""
    ck = Checkpointer(str(tmp_path))
    st = {"params": _weights(0)}
    ck.save(1, st)
    bad = _weights(0)
    w = bad["ffn"].weight
    bad["ffn"].hold(dataclasses.replace(w, nm=NMConfig(2, 8)))
    with pytest.raises(ValueError, match="metadata mismatch"):
        ck.restore({"params": bad})


def _lm(seed):
    return LM.init(get_reduced("yi-9b"), seed=seed, dtype=torch.float32,
                   device="cpu").set_compute_dtype(torch.bfloat16)


def test_train_state_resumes_bit_identically(tmp_path):
    tc = TrainConfig(opt=AdamWConfig(**OPT), remat="none")
    pipe = DataPipeline(PipelineConfig(vocab_size=512, seq_len=16,
                                       global_batch=4))
    lm, opt = init_train_state(_lm(0), tc)
    step = make_train_step(lm, tc)
    for _ in range(2):
        lm, opt, _ = step(lm, opt, pipe.next())
    ck = Checkpointer(str(tmp_path))
    ck.save(2, {"params": lm, "opt": opt}, extra={"data": pipe.state()},
            async_=True)
    batch = pipe.next()
    _, opt_a, m_a = step(lm, opt, batch)
    lm_b, opt_b = init_train_state(_lm(1), tc)
    state, meta = ck.restore({"params": lm_b, "opt": opt_b})
    pipe_b = DataPipeline(PipelineConfig(vocab_size=512, seq_len=16,
                                         global_batch=4))
    pipe_b.restore(meta["extra"]["data"])
    _, opt_b, m_b = step(state["params"], state["opt"], pipe_b.next())
    for key in ("loss", "grad_norm", "lr"):
        assert float(m_a[key]) == float(m_b[key])
    for (n, a), (_, b) in zip(lm.named_parameters(),
                              lm_b.named_parameters()):
        assert torch.equal(a, b), n
    assert int(opt_b["step"]) == 3
    for n in opt_a["m"]:
        assert torch.equal(opt_a["m"][n], opt_b["m"][n])
        assert torch.equal(opt_a["v"][n], opt_b["v"][n])


def test_async_save_holds_the_state_at_save_time(tmp_path, monkeypatch):
    """A train step updates the parameters and moments in place right
    after an async save returns; the checkpoint holds the values of save
    time. The write is held back until the step has run, so a save that
    kept the live tensors would write the step's values."""
    go = threading.Event()
    write = Checkpointer._write

    def held(self, *args):
        go.wait(30)
        write(self, *args)

    monkeypatch.setattr(Checkpointer, "_write", held)
    tc = TrainConfig(opt=AdamWConfig(**OPT), remat="none")
    pipe = DataPipeline(PipelineConfig(vocab_size=512, seq_len=16,
                                       global_batch=4))
    lm, opt = init_train_state(_lm(0), tc)
    step = make_train_step(lm, tc)
    lm, opt, _ = step(lm, opt, pipe.next())
    want = ({n: p.detach().clone() for n, p in lm.named_parameters()},
            {n: t.clone() for n, t in opt["m"].items()},
            {n: t.clone() for n, t in opt["v"].items()})
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"params": lm, "opt": opt}, async_=True)
    step(lm, opt, pipe.next())
    go.set()
    ck.wait()
    lm_b, opt_b = init_train_state(_lm(1), tc)
    state, _ = ck.restore({"params": lm_b, "opt": opt_b})
    assert int(state["opt"]["step"]) == 1
    for n, p in lm_b.named_parameters():
        assert torch.equal(p, want[0][n]), n
    for i, part in ((1, "m"), (2, "v")):
        for n, t in state["opt"][part].items():
            assert torch.equal(t, want[i][n]), (part, n)


def test_jax_checkpoint_restores_and_continues(tmp_path):
    """JAX trains one step of reduced yi-9b and saves {"params", "opt"}
    with its data cursor; the port reads it: equal logits on the same
    tokens, the next batch, and an equal next train step."""
    from repro_torch.models.cache import CacheView

    jcommon.set_compute_dtype(jnp.float32)
    try:
        jcfg = jax_reduced("yi-9b")
        jlm = JaxLM(jcfg)
        params = jax.jit(jlm.init)(jax.random.PRNGKey(0))
        jopt = jax_adamw_init(params)
        jstep = jax.jit(jtrain.make_train_step(jlm, jtrain.TrainConfig(
            opt=JaxAdamW(**OPT), remat="none")))
        jpipe = JaxPipeline(JaxPipelineConfig(vocab_size=512, seq_len=16,
                                              global_batch=4))
        params, jopt, _ = jstep(params, jopt, {
            k: jnp.asarray(v) for k, v in jpipe.next().items()})
        JaxCheckpointer(str(tmp_path)).save(
            1, {"params": params, "opt": jopt},
            extra={"data": jpipe.state()})
        toks = np.random.default_rng(0).integers(0, 512, (2, 8)).astype(
            np.int32)
        jl, _, _ = jlm.forward(params, jnp.asarray(toks),
                               view=JaxCacheView.train())
        nxt = jpipe.next()
        params2, jopt2, jm = jstep(params, jopt, {
            k: jnp.asarray(v) for k, v in nxt.items()})
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)

    cfg = get_reduced("yi-9b")
    lm, opt, meta = read_jax_checkpoint(str(tmp_path), cfg, device="cpu")
    assert meta["step"] == 1 and int(opt["step"]) == 1
    with torch.inference_mode():
        tl, _ = lm(torch.from_numpy(toks), view=CacheView.train())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    pipe = DataPipeline(PipelineConfig(vocab_size=512, seq_len=16,
                                       global_batch=4))
    pipe.restore(meta["extra"]["data"])
    batch = pipe.next()
    np.testing.assert_array_equal(batch["tokens"], nxt["tokens"])
    tc = TrainConfig(opt=AdamWConfig(**OPT), remat="none")
    lm, opt, tm = make_train_step(lm, tc)(lm, opt, batch)
    for key in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    # JAX's state after that step, read back the same way: every
    # parameter and both moments, by name
    JaxCheckpointer(str(tmp_path / "next")).save(
        2, {"params": params2, "opt": jopt2})
    want_lm, want_opt, _ = read_jax_checkpoint(str(tmp_path / "next"), cfg,
                                               device="cpu")
    want = dict(want_lm.named_parameters())
    assert set(opt["m"]) == set(want) == set(want_opt["m"])
    for name, p in lm.named_parameters():
        for got, ref in ((p.detach(), want[name].detach()),
                         (opt["m"][name], want_opt["m"][name]),
                         (opt["v"][name], want_opt["v"][name])):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                       atol=2e-5, err_msg=name)
    assert int(opt["step"]) == int(want_opt["step"]) == 2
