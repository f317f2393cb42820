"""The port's serving engine against the JAX engine: chunked prefill,
the paged cache with and without chunks, forced preemption and a paged
masked model give the same greedy streams, plans and paging statistics
on the same requests and weights (reduced yi-9b in f32, weights through
``interop``); the head projects only the sampled position.

Greedy streams and integer statistics are compared exactly; logits of
the last-position head against the all-position head's last row within
1e-5 (the same f32 ops on one row, which may take another reduction
order). ``compiled_cache_sizes()`` counts the distinct step shapes on
the CPU, so it pins one prefill and one decode shape per engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core.nmweight import NMWeight as JaxNMWeight
from repro.kernels.blocksparse_attn import mask as jmask
from repro.models import common as jcommon
from repro.models.transformer import LM as JaxLM
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_reduced
from repro_torch.interop import lm_from_jax, mask_from_jax
from repro_torch.kernels import registry
from repro_torch.models.cache import CacheView
from repro_torch.serving.engine import (
    Request,
    ServeEngine,
    make_serve_steps,
    ran_counts,
)

HEAD_TOL = 1e-5


def _numpy_tree(tree):
    if isinstance(tree, JaxNMWeight):
        return {"vals": np.asarray(tree.vals), "idx": np.asarray(tree.idx),
                "n": tree.nm.n, "m": tree.nm.m, "axis": tree.axis,
                "mode": tree.kernel_policy.mode}
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def _variant(cfg, mask=None):
    (blk, rep), = cfg.plan
    if mask is not None:
        blk = dataclasses.replace(blk, mixer=dataclasses.replace(
            blk.mixer, mask=mask, window=None))
    return dataclasses.replace(
        cfg, plan=((blk, rep),),
        sparsity=dataclasses.replace(cfg.sparsity, use_kernel=True))


def _pair(jspec=None):
    jlm = JaxLM(_variant(jax_reduced("yi-9b"), jspec))
    params = jlm.init(jax.random.PRNGKey(0))
    tspec = None if jspec is None else mask_from_jax(jspec)
    tlm = lm_from_jax(_variant(get_reduced("yi-9b"), tspec),
                      _numpy_tree(params), dtype=torch.float32, device="cpu")
    return jlm, params, tlm


@pytest.fixture(scope="module")
def yi():
    jcommon.set_compute_dtype(jnp.float32)
    yield _pair()
    jcommon.set_compute_dtype(jnp.bfloat16)


@pytest.fixture(scope="module")
def masked_yi(yi):
    yield _pair(jmask.MaskSpec("local", block=8, window=12))


def _mixed_stream(n=7, seed=0, vocab=512):
    """Mixed lengths; three share a prefix with request 0."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, vocab, size=ln).astype(np.int32)
               for ln in (8, 5, 8, 3, 8, 6, 8)[:n]]
    prompts[2][:4] = prompts[0][:4]
    if n > 4:
        prompts[4] = prompts[0].copy()
    return prompts, [3 + i % 4 for i in range(n)]


def _serve_both(pair, prompts, max_news, **kw):
    """Both engines on the same requests: (JAX streams, port streams,
    JAX engine, port engine)."""
    jlm, params, tlm = pair
    jeng = JaxServeEngine(jlm, params, **kw)
    teng = ServeEngine(tlm, **kw)
    for i, (p, n) in enumerate(zip(prompts, max_news)):
        jeng.submit(JaxRequest(rid=i, prompt=p.copy(), max_new=n))
        teng.submit(Request(rid=i, prompt=p.copy(), max_new=n))
    want = {r.rid: tuple(r.out) for r in jeng.run()}
    got = {r.rid: tuple(r.out) for r in teng.run()}
    return want, got, jeng, teng


PAGING_KEYS = ("prefix_hit_pages", "prefix_lookup_pages", "prefix_hit_rate",
               "page_evictions", "preemptions", "page_util_max",
               "page_util_mean")


def _same_engine(jeng, teng):
    assert [r.rid for r in teng.finished] == [r.rid for r in jeng.finished]
    assert teng.steps == jeng.steps
    assert teng.queue_depths == jeng.queue_depths
    assert teng.page_utils == jeng.page_utils
    want, got = jeng.throughput_stats(), teng.throughput_stats()
    assert set(got) == set(want)
    for key in PAGING_KEYS + ("requests", "tokens", "decode_steps",
                              "queue_depth_max", "queue_depth_mean"):
        if key in want:
            assert got[key] == want[key], key
    assert teng.compiled_cache_sizes() == {"prefill": 1, "decode": 1}


@pytest.mark.parametrize("chunk", [4, 2])
def test_chunked_prefill_equals_jax_and_full(yi, chunk):
    """Chunked prefill: the JAX engine's streams, and the full-prefill
    engine's (per-token writes and causal reads do not see the chunks)."""
    prompts, max_news = _mixed_stream(n=5, seed=1)
    kw = dict(slots=2, max_seq=32, prefill_len=8)
    want, got, jeng, teng = _serve_both(yi, prompts, max_news,
                                        prefill_chunk=chunk, **kw)
    assert got == want
    _same_engine(jeng, teng)
    _, full, _, _ = _serve_both(yi, prompts, max_news, **kw)
    assert got == full


@pytest.mark.parametrize("chunk", [4, None], ids=["chunk4", "full"])
def test_paged_engine_equals_jax(yi, chunk):
    """Paged, with and without chunks: streams, steps, page utilization
    and prefix-cache statistics equal the JAX paged engine's; with chunks
    the shared prefixes hit the cache."""
    prompts, max_news = _mixed_stream()
    kw = dict(slots=2, max_seq=32, prefill_len=8, prefill_chunk=chunk,
              paged=True)
    registry.clear_history()
    want, got, jeng, teng = _serve_both(yi, prompts, max_news, **kw)
    assert got == want
    _same_engine(jeng, teng)
    assert (teng.throughput_stats()["prefix_hit_pages"] > 0) == bool(chunk)
    counts = registry.dispatch_counts()
    assert counts[("nm_matmul_decode", "nm_spmm_decode", "cpu")] > 0
    assert not any(k[1].startswith("reference") for k in counts), counts
    slot_want, _, _, _ = _serve_both(yi, prompts, max_news, slots=2,
                                     max_seq=32, prefill_len=8,
                                     prefill_chunk=chunk)
    assert got == slot_want


def test_forced_preemption_equals_jax(yi):
    """Nine pages of 4 cannot hold two requests decoding to 26 tokens:
    decode preempts the later slot, which recomputes; the streams, the
    preemptions and the evictions equal JAX's and the slot engine's."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 512, size=8).astype(np.int32)
               for _ in range(3)]
    max_news = [18, 18, 6]
    kw = dict(slots=2, max_seq=32, prefill_len=8, prefill_chunk=4)
    want, got, jeng, teng = _serve_both(yi, prompts, max_news, paged=True,
                                        pool_pages=9, **kw)
    assert teng.scheduler.preemptions == jeng.scheduler.preemptions > 0
    assert got == want
    _same_engine(jeng, teng)
    _, slot_got, _, _ = _serve_both(yi, prompts, max_news, **kw)
    assert got == slot_got


def test_paged_masked_model_equals_jax(masked_yi):
    """A local MaskSpec on every block, paged with chunks: the JAX paged
    engine's streams, through the mask-aware decode family."""
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, 512, size=32).astype(np.int32)
               for _ in range(4)]
    kw = dict(slots=2, max_seq=64, prefill_len=32, prefill_chunk=16)
    registry.clear_history()
    want, got, jeng, teng = _serve_both(masked_yi, prompts, [4] * 4,
                                        paged=True, **kw)
    assert got == want
    _same_engine(jeng, teng)
    counts = registry.dispatch_counts("bs_attention")
    assert counts[("bs_attention_decode", "masked_decode", "cpu")] > 0
    _, slot_got, _, _ = _serve_both(masked_yi, prompts, [4] * 4, **kw)
    assert got == slot_got


def test_zero_new_shapes_after_warmup(yi):
    """More requests through a warm engine build no new step shape."""
    _, _, tlm = yi
    eng = ServeEngine(tlm, slots=2, max_seq=64, prefill_len=8,
                      prefill_chunk=4, paged=True)
    rng = np.random.default_rng(9)
    eng.submit(Request(rid=0, prompt=rng.integers(0, 512, 8).astype(
        np.int32), max_new=3))
    eng.run()
    warm = eng.compiled_cache_sizes()
    assert warm == {"prefill": 1, "decode": 1}
    for i in range(1, 6):
        eng.submit(Request(rid=i, prompt=rng.integers(0, 512, 8).astype(
            np.int32), max_new=2 + i))
    eng.run()
    assert eng.compiled_cache_sizes() == warm
    assert eng.captured() == {"prefill": [], "decode": []}  # CPU: eager


def test_prefill_chunk_must_divide_prefill_len(yi):
    _, _, tlm = yi
    with pytest.raises(ValueError, match="multiple of prefill_chunk"):
        ServeEngine(tlm, slots=1, max_seq=32, prefill_len=8,
                    prefill_chunk=3)


def test_env_var_page_geometry(yi, monkeypatch):
    _, _, tlm = yi
    monkeypatch.setenv("REPRO_KV_PAGE_SIZE", "8")
    monkeypatch.setenv("REPRO_KV_POOL_PAGES", "6")
    eng = ServeEngine(tlm, slots=2, max_seq=32, prefill_len=8, paged=True)
    assert eng.page_manager.page_size == 8
    assert eng.page_manager.capacity == 6
    assert eng.caches[0]["k"].shape[:2] == (7, 8)  # 6 pages + the null page
    eng = ServeEngine(tlm, slots=2, max_seq=32, prefill_len=8, paged=True,
                      page_size=4, pool_pages=16)
    assert eng.page_manager.page_size == 4
    assert eng.page_manager.capacity == 16


@pytest.mark.parametrize("kw,match", [
    (dict(page_size=5), "multiple"),
    (dict(page_size=4, pool_pages=4), "full-length"),
    (dict(page_size=16), "page_size"),
])
def test_paged_validation_errors_match_jax(yi, kw, match):
    jlm, params, tlm = yi
    base = dict(slots=2, max_seq=32, prefill_len=8, paged=True)
    with pytest.raises(ValueError, match=match):
        JaxServeEngine(jlm, params, **base, **kw)
    with pytest.raises(ValueError, match=match):
        ServeEngine(tlm, **base, **kw)


def test_last_position_head_equals_the_all_position_head(yi):
    """``last_only`` projects one position: equal (within 1e-5) to the
    last row of the all-position logits, in prefill, chunk and decode."""
    _, _, tlm = yi
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (2, 8)).astype(np.int64))
    with torch.inference_mode():
        views = (lambda: CacheView.prefill(),
                 lambda: CacheView.chunk(torch.tensor([4, 8])),
                 lambda: CacheView.decode(torch.tensor([5, 9])))
        for make, t in zip(views, (toks, toks[:, :4], toks[:, :1])):
            full, _ = tlm(t, view=make(), caches=tlm.init_cache(2, 16))
            last, _ = tlm(t, view=make(), caches=tlm.init_cache(2, 16),
                          last_only=True)
            assert last.shape == (2, 1, full.shape[-1])
            torch.testing.assert_close(last[:, 0], full[:, -1],
                                       rtol=HEAD_TOL, atol=HEAD_TOL)


def test_serve_steps_run_eagerly_on_the_cpu(yi):
    """``make_serve_steps`` (graphs on by default) runs eagerly on the
    CPU: the prefill step's last logits and a decode step's equal the
    model's, and each distinct shape is built once."""
    _, _, tlm = yi
    prefill, decode = make_serve_steps(tlm)
    toks = np.random.default_rng(4).integers(0, 512, (2, 8)).astype(np.int32)
    caches, ref = tlm.init_cache(2, 16), tlm.init_cache(2, 16)
    with torch.inference_mode():
        got = prefill(caches, tokens=toks)
        want, _ = tlm(torch.from_numpy(toks), view=CacheView.prefill(),
                      caches=ref)
        torch.testing.assert_close(got, want[:, -1], rtol=HEAD_TOL,
                                   atol=HEAD_TOL)
        nxt = want[:, -1].argmax(-1, keepdim=True).numpy().astype(np.int32)
        lens = np.array([8, 8], np.int32)
        got = decode(caches, tokens=nxt, cache_len=lens)
        want, _ = tlm(torch.from_numpy(nxt),
                      view=CacheView.decode(torch.from_numpy(lens)),
                      caches=ref)
        torch.testing.assert_close(got, want[:, 0], rtol=HEAD_TOL,
                                   atol=HEAD_TOL)
        decode(caches, tokens=nxt, cache_len=lens + 1)
    assert len(prefill.built) == len(decode.built) == 1
    with pytest.raises(ValueError, match="exceeds cache bounds"):
        decode(caches, tokens=nxt, cache_len=np.array([16, 3], np.int32))


def test_ran_counts_multiply_each_graph_by_its_replays(yi):
    """What ran = eager counts + each graph's capture counts x (replays
    - 1), the capture already counted once."""
    from repro_torch.serving.engine import CapturedStep

    _, _, tlm = yi
    eng = ServeEngine(tlm, slots=1, max_seq=16, prefill_len=8)
    rec = CapturedStep(("sig",), {("op", "impl", "cuda"): 2}, {"k": 3},
                       replays=5)
    eng._decode.built["fake"] = type("G", (), {"record": rec})()
    d, n = ran_counts(eng, {("op", "impl", "cuda"): 4}, {"k": 6, "j": 1})
    assert d == {("op", "impl", "cuda"): 4 + 2 * 4}
    assert n == {"k": 6 + 3 * 4, "j": 1}
