"""The port's model and serving path against the JAX package on reduced
yi-9b in f32, on the same weights (the JAX ``LM.init`` tree handed over
through ``repro_torch.interop`` as numpy arrays).

Tolerance: logits agree to 1e-4 (two layers of f32 products whose sums
run in another order; |logits| is O(1)). Greedy token streams must be
identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core.nmweight import NMWeight as JaxNMWeight
from repro.models import common as jcommon
from repro.models.cache import CacheView as JaxCacheView
from repro.models.transformer import LM as JaxLM
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_reduced
from repro_torch.interop import lm_from_jax
from repro_torch.kernels import registry
from repro_torch.models.attention import CacheLenError
from repro_torch.models.cache import CacheView
from repro_torch.serving.engine import Request, ServeEngine

LOGIT_TOL = 1e-4


def numpy_tree(tree):
    """The JAX param tree as numpy arrays, each NMWeight as the dict
    ``repro_torch.interop`` takes."""
    if isinstance(tree, JaxNMWeight):
        return {"vals": np.asarray(tree.vals), "idx": np.asarray(tree.idx),
                "n": tree.nm.n, "m": tree.nm.m, "axis": tree.axis,
                "mode": tree.kernel_policy.mode}
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    return np.asarray(tree)


def _with_kernels(cfg):
    return dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, use_kernel=True))


@pytest.fixture(scope="module")
def yi():
    jcommon.set_compute_dtype(jnp.float32)
    jcfg = _with_kernels(jax_reduced("yi-9b"))
    jlm = JaxLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    tcfg = _with_kernels(get_reduced("yi-9b"))
    tlm = lm_from_jax(tcfg, numpy_tree(params), dtype=torch.float32,
                      device="cpu")
    yield jlm, params, tlm
    jcommon.set_compute_dtype(jnp.bfloat16)


def test_reduced_configs_agree():
    j, t = jax_reduced("yi-9b"), get_reduced("yi-9b")
    assert (j.vocab_size, j.d_model, j.n_layers, j.max_seq, j.rope_theta,
            j.norm_eps, j.attn_chunk) == (
        t.vocab_size, t.d_model, t.n_layers, t.max_seq, t.rope_theta,
        t.norm_eps, t.attn_chunk)
    (jb, _), = j.plan
    (tb, _), = t.plan
    assert (jb.mixer.q_heads, jb.mixer.kv_heads, jb.mixer.head_dim,
            jb.mlp.d_ff, jb.mlp.act) == (
        tb.mixer.q_heads, tb.mixer.kv_heads, tb.mixer.head_dim,
        tb.mlp.d_ff, tb.mlp.act)
    assert j.sparsity.nm.tag == t.sparsity.nm.tag


def test_interop_unstacks_layers(yi):
    _, params, tlm = yi
    assert len(tlm.layers) == 2
    wq = params["groups"][0][0]["mixer"]["wq"]
    for i, layer in enumerate(tlm.layers):
        w = layer.mixer.wq.weight
        np.testing.assert_array_equal(w.vals.numpy(), np.asarray(wq.vals[i]))
        np.testing.assert_array_equal(w.idx.numpy(), np.asarray(wq.idx[i]))
        assert w.nm.tag == "2:4" and w.kernel_policy.mode == "auto"
    assert tlm.lm_head.w.dtype == torch.float32


def test_prefill_and_decode_logits_match_jax(yi):
    jlm, params, tlm = yi
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 8)).astype(np.int32)
    jl, jc, _ = jlm.forward(params, jnp.asarray(toks),
                            view=JaxCacheView.prefill(),
                            caches=jlm.init_cache(2, 16, jnp.float32))
    registry.clear_history()
    with torch.inference_mode():
        tl, tc = tlm(torch.from_numpy(toks), view=CacheView.prefill(),
                     caches=tlm.init_cache(2, 16))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert registry.dispatch_counts("nm_matmul")[
        ("nm_matmul", "nm_spmm", "cpu")] > 0
    for layer_t, layer_j in zip(tc, [jax.tree.map(lambda a, i=i: a[i], jc[0])
                                     for i in range(2)]):
        np.testing.assert_allclose(layer_t["k"].numpy(),
                                   np.asarray(layer_j[0]["k"]),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    lens = np.array([8, 8], np.int32)
    jd, _, _ = jlm.forward(params, jnp.asarray(nxt),
                           view=JaxCacheView.decode(jnp.asarray(lens)),
                           caches=jc)
    with torch.inference_mode():
        td, _ = tlm(torch.from_numpy(nxt),
                    view=CacheView.decode(torch.from_numpy(lens)), caches=tc)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert registry.dispatch_counts("nm_matmul_decode")[
        ("nm_matmul_decode", "nm_spmm_decode", "cpu")] > 0


def test_train_mode_logits_match_jax(yi):
    jlm, params, tlm = yi
    toks = np.random.default_rng(1).integers(0, 512, (1, 12)).astype(np.int32)
    jl, _, _ = jlm.forward(params, jnp.asarray(toks))
    with torch.inference_mode():
        tl, _ = tlm(torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def _requests(cls, n, vocab, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=int(
        rng.integers(3, 11))).astype(np.int32), max_new=3 + i % 3)
        for i in range(n)]


def test_greedy_streams_identical_to_jax_engine(yi):
    """Same requests (short prompts left-padded, long ones cut to the
    tail), same slot schedule: the token streams must be identical."""
    jlm, params, tlm = yi
    jeng = JaxServeEngine(jlm, params, slots=2, max_seq=32, prefill_len=8)
    teng = ServeEngine(tlm, slots=2, max_seq=32, prefill_len=8)
    for r in _requests(JaxRequest, 5, 512, seed=3):
        jeng.submit(r)
    for r in _requests(Request, 5, 512, seed=3):
        teng.submit(r)
    registry.clear_history()
    want = {r.rid: r.out for r in jeng.run()}
    got = {r.rid: r.out for r in teng.run()}
    assert got == want
    assert set(got) == set(range(5))
    assert [len(got[i]) for i in range(5)] == [3, 4, 5, 3, 4]
    counts = registry.dispatch_counts()
    assert counts[("nm_matmul_decode", "nm_spmm_decode", "cpu")] > 0
    assert not any(k[0] == "nm_matmul_decode" and k[1].startswith("reference")
                   for k in counts), counts


@pytest.mark.parametrize("n_req,slots", [(2, 2), (6, 2)],
                         ids=["fits", "queued"])
def test_engine_surface_equals_jax_engine(yi, n_req, slots):
    """``finished``, ``queue``, ``steps``, ``queue_depths`` and the
    queue-depth stats equal the JAX engine's on the same requests (more
    requests than slots leave a backlog after the first steps)."""
    jlm, params, tlm = yi
    jeng = JaxServeEngine(jlm, params, slots=slots, max_seq=32,
                          prefill_len=8)
    teng = ServeEngine(tlm, slots=slots, max_seq=32, prefill_len=8)
    for r in _requests(JaxRequest, n_req, 512, seed=5):
        jeng.submit(r)
    for r in _requests(Request, n_req, 512, seed=5):
        teng.submit(r)
    assert len(teng.queue) == len(jeng.queue) == n_req
    jeng.run()
    teng.run()
    assert [r.rid for r in teng.finished] == [r.rid for r in jeng.finished]
    assert teng.queue == [] and jeng.queue == []
    assert teng.steps == jeng.steps
    assert teng.queue_depths == jeng.queue_depths
    assert max(teng.queue_depths) == (n_req > slots) * (n_req - slots)
    want, got = jeng.throughput_stats(), teng.throughput_stats()
    for key in ("queue_depth_mean", "queue_depth_max"):
        assert got[key] == want[key]
    assert (got["queue_depth_max"] > 0) == (n_req > slots)


def test_engine_truncates_and_counts(yi):
    _, _, tlm = yi
    eng = ServeEngine(tlm, slots=2, max_seq=32, prefill_len=8, strict=False)
    long = Request(rid=0, prompt=np.arange(12, dtype=np.int32), max_new=2)
    eng.submit(long)
    done = eng.run()
    assert long.truncated and done[0].out and len(done[0].out) == 2
    stats = eng.throughput_stats()
    assert stats["requests"] == 1 and stats["tokens"] == 2
    assert stats["decode_steps"] == 1 and stats["ttft_s"] >= 0
    strict = ServeEngine(tlm, slots=1, max_seq=32, prefill_len=8, strict=True)
    with pytest.raises(ValueError, match="strict"):
        strict.submit(Request(rid=1, prompt=np.arange(9, dtype=np.int32),
                              max_new=1))


def test_write_mask_writes_only_its_slots_in_place(yi):
    """The cache rows of slots outside ``write_mask`` stay as they were
    (what the JAX engine's ``merge_cache_slots`` keeps); the written
    slots get the rows an unmasked call writes."""
    _, _, tlm = yi
    toks = torch.from_numpy(
        np.random.default_rng(7).integers(0, 512, (2, 8)).astype(np.int64))
    with torch.inference_mode():
        full = tlm.init_cache(2, 16)
        tlm(toks, view=CacheView.prefill(), caches=full)
        part = tlm.init_cache(2, 16)
        _, out = tlm(toks, view=CacheView.prefill(np.array([True, False])),
                     caches=part)
        assert out is part
        old = [{n: t.clone() for n, t in layer.items()} for layer in part]
        tlm(toks[:, :1], view=CacheView.decode(torch.tensor([8, 3]),
                                               np.array([False, True])),
            caches=part)
    for lf, lp, lo in zip(full, part, old):
        for name in ("k", "v"):
            torch.testing.assert_close(lp[name][0], lf[name][0], rtol=0,
                                       atol=0)
            assert not lp[name][1, :3].any() and lp[name][1, 3].any()
            torch.testing.assert_close(lp[name][0], lo[name][0], rtol=0,
                                       atol=0)


def test_cache_len_out_of_bounds_raises(yi):
    _, _, tlm = yi
    caches = tlm.init_cache(2, 8)
    with pytest.raises(CacheLenError):
        tlm(torch.zeros(2, 1, dtype=torch.long),
            view=CacheView.decode(torch.tensor([3, 8])), caches=caches)


@pytest.mark.parametrize("pos_shape", [(6,), (2, 6)])
def test_rope_matches_jax(pos_shape):
    """Same formula; XLA's and PyTorch's f32 cos/sin differ by an ulp, so
    the tolerance is 1e-6 on O(1) values."""
    from repro.models.common import apply_rope as jax_rope
    from repro_torch.models.common import apply_rope

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 100, pos_shape).astype(np.int32)
    want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_chunk_mode_matches_jax(yi):
    """A prompt written in two chunks at per-slot offsets (causal against
    the partly filled cache) gives the JAX package's logits."""
    jlm, params, tlm = yi
    toks = np.random.default_rng(5).integers(0, 512, (2, 8)).astype(np.int32)
    jc = jlm.init_cache(2, 16, jnp.float32)
    tc = tlm.init_cache(2, 16)
    for c0 in (0, 4):
        lens = np.full(2, c0, np.int32)
        jl, jc, _ = jlm.forward(params, jnp.asarray(toks[:, c0:c0 + 4]),
                                view=JaxCacheView.chunk(jnp.asarray(lens)),
                                caches=jc)
        with torch.inference_mode():
            tl, tc = tlm(torch.from_numpy(toks[:, c0:c0 + 4]),
                         view=CacheView.chunk(torch.from_numpy(lens)),
                         caches=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_temperature_sampling_is_one_stream_per_seed(yi):
    """The two PRNGs differ, so the port is held only to its own seed."""
    _, _, tlm = yi

    def run(seed):
        eng = ServeEngine(tlm, slots=2, max_seq=32, prefill_len=8,
                          temperature=1.0, seed=seed)
        for r in _requests(Request, 3, 512, seed=6):
            eng.submit(r)
        return {r.rid: r.out for r in eng.run()}

    a, b = run(7), run(7)
    assert a == b and all(0 <= t < 512 for out in a.values() for t in out)
    assert run(8) != a


def test_nmweight_to_dense_is_the_pruned_weight(yi):
    _, params, tlm = yi
    w = tlm.layers[0].mlp.w_down.weight
    jw = params["groups"][0][0]["mlp"]["w_down"]
    from repro.core.sparsity import decompress_nm

    np.testing.assert_array_equal(  # layer 0 of the stacked JAX leaves
        w.to_dense().numpy(),
        np.asarray(decompress_nm(jw.vals[0], jw.idx[0], jw.nm, axis=0)))


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu_sq"])
@pytest.mark.parametrize("rows", [3, 24], ids=["decode", "prefill"])
def test_ffn_activations_match_jax(act, rows):
    """Each FFN kind, its activation riding on the up/gate projection as
    the epilogue: fused in the decode family, after the GEMM otherwise."""
    from repro.configs.base import FFNConfig as JaxFFNConfig
    from repro.configs.base import SparsityConfig as JaxSparsityConfig
    from repro.models.ffn import ffn_apply, ffn_init
    from repro_torch.configs.base import FFNConfig
    from repro_torch.interop import weight_from_jax
    from repro_torch.models.ffn import FFN

    jcfg = JaxFFNConfig(d_ff=96, act=act)
    p = ffn_init(jax.random.PRNGKey(3), 64, jcfg,
                 sp=JaxSparsityConfig(use_kernel=True))
    tree = numpy_tree(p)
    ffn = FFN(FFNConfig(d_ff=96, act=act),
              *(weight_from_jax(tree[k], dtype=torch.float32, device="cpu")
                if k in tree else None for k in ("w_up", "w_down", "w_gate")))
    x = np.random.default_rng(rows).standard_normal((1, rows, 64))
    x = x.astype(np.float32)
    prev = jcommon.get_compute_dtype()
    jcommon.set_compute_dtype(jnp.float32)
    try:
        want = np.asarray(ffn_apply(p, jnp.asarray(x), jcfg))
    finally:
        jcommon.set_compute_dtype(prev)
    with torch.inference_mode():
        got = ffn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_greedy_takes_the_first_index_on_ties():
    from repro_torch.serving.sampling import make_sampler

    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    assert make_sampler(0.0)(logits, None).tolist() == [1, 0]
    assert np.argmax(logits.numpy(), -1).tolist() == [1, 0]
