"""The port's synthetic data pipeline: the JAX package's
``tests/test_data_pipeline.py`` ported, and every batch bit-equal to the
JAX package's ``DataPipeline`` (the same ``SeedSequence([seed, step,
host_id])``)."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.data.pipeline import DataPipeline as JaxPipeline
from repro.data.pipeline import PipelineConfig as JaxConfig
from repro_torch.data.pipeline import DataPipeline, PipelineConfig


def _cfg(**kw):
    d = dict(vocab_size=128, seq_len=16, global_batch=8, seed=3)
    d.update(kw)
    return PipelineConfig(**d)


@pytest.mark.parametrize("seed,host,hosts,seq", [
    (0, 0, 1, 16), (3, 1, 2, 16), (7, 3, 4, 64), (1, 0, 1, 256)])
def test_batches_bit_equal_to_jax(seed, host, hosts, seq):
    kw = dict(vocab_size=512, seq_len=seq, global_batch=8, seed=seed)
    ours = DataPipeline(PipelineConfig(**kw), host_id=host, num_hosts=hosts)
    jax_ = JaxPipeline(JaxConfig(**kw), host_id=host, num_hosts=hosts)
    for _ in range(4):
        a, b = ours.next(), jax_.next()
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(a[key], b[key])
            assert a[key].dtype == b[key].dtype == np.int32
    assert ours.state() == jax_.state()


def test_deterministic():
    a = DataPipeline(_cfg()).next()
    b = DataPipeline(_cfg()).next()
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_labels_are_shifted_tokens():
    b = DataPipeline(_cfg()).next()
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["labels"][:, -1] == -100).all()


def test_host_sharding_partitions_batch():
    h0 = DataPipeline(_cfg(), host_id=0, num_hosts=2)
    h1 = DataPipeline(_cfg(), host_id=1, num_hosts=2)
    assert h0.host_batch == 4 and h1.host_batch == 4
    t0, t1 = h0.next()["tokens"], h1.next()["tokens"]
    assert t0.shape == (4, 16)
    assert not np.array_equal(t0, t1)


def test_cursor_restore_resumes_exactly():
    p = DataPipeline(_cfg())
    for _ in range(5):
        p.next()
    state = p.state()
    want = p.next()["tokens"]
    q = DataPipeline(_cfg())
    q.restore(state)
    np.testing.assert_array_equal(want, q.next()["tokens"])


def test_seed_mismatch_rejected():
    p = DataPipeline(_cfg(seed=1))
    with pytest.raises(AssertionError):
        p.restore({"step": 3, "seed": 2})


@settings(max_examples=10, deadline=None)
@given(step=st.integers(0, 50), seed=st.integers(0, 5))
def test_property_any_step_reproducible(step, seed):
    p = DataPipeline(_cfg(seed=seed))
    p.step = step
    a = p.next()["tokens"]
    q = DataPipeline(_cfg(seed=seed))
    q.restore({"step": step, "seed": seed})
    np.testing.assert_array_equal(a, q.next()["tokens"])


def test_copy_span_present():
    b = DataPipeline(_cfg(seq_len=64)).next()["tokens"]
    found = any(np.array_equal(row[s:s + 8], row[s + 8:s + 16])
                for row in b for s in range(0, 64 - 16))
    assert found
