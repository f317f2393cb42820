"""The fp8 (e4m3) KV cache of the port against the JAX package's, on
reduced yi-9b in f32 compute with the same weights (the JAX tree handed
over through ``repro_torch.interop``).

The cache is written and read through ``cache.dtype``, with no kernel
change: the port moves fp8 entries as their bytes, which is exact. So
the port's fp8 logits equal JAX's fp8 logits to 1e-5 (both round the
same f32 K/V to e4m3; the sums run in another order), and the paged
cache holds the same bytes as the slot cache. deepseek-v2-lite-16b
waits for MLA in the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import common as jcommon
from repro.models.cache import CacheView as JaxCacheView
from repro.models.transformer import LM as JaxLM
from repro_torch.configs import get_reduced
from repro_torch.interop import lm_from_jax
from repro_torch.models.attention import paged_gather, paged_write
from repro_torch.models.cache import CacheView
from test_torch_model import numpy_tree

FP8 = torch.float8_e4m3fn
TOL = 1e-5


@pytest.fixture(scope="module")
def yi():
    jcommon.set_compute_dtype(jnp.float32)
    jcfg = jax_reduced("yi-9b")
    jlm = JaxLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    tlm = lm_from_jax(get_reduced("yi-9b"), numpy_tree(params),
                      dtype=torch.float32, device="cpu")
    yield jlm, params, tlm
    jcommon.set_compute_dtype(jnp.bfloat16)


def _tokens(vocab):
    return np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                       vocab))


def _jax_logits(jlm, params, tokens, dtype):
    caches = jlm.init_cache(2, 32, dtype=dtype)
    lp, caches, _ = jlm.forward(params, jnp.asarray(tokens),
                                view=JaxCacheView.prefill(), caches=caches)
    nxt = jnp.argmax(lp[:, -1:], -1)
    ld, _, _ = jlm.forward(params, nxt, view=JaxCacheView.decode(
        jnp.int32(16)), caches=caches)
    return (np.asarray(lp, np.float32), np.asarray(nxt),
            np.asarray(ld, np.float32))


@torch.inference_mode()
def _port_logits(tlm, tokens, nxt, dtype):
    caches = tlm.init_cache(2, 32, dtype=dtype)
    lp, _ = tlm(torch.from_numpy(tokens), view=CacheView.prefill(),
                caches=caches)
    ld, _ = tlm(torch.from_numpy(nxt).to(torch.int32),
                view=CacheView.decode(torch.tensor(16)), caches=caches)
    return lp.numpy(), ld.numpy(), caches


def test_fp8_cache_logits_match_jax(yi):
    """Prefill and decode logits with an fp8 cache equal JAX's fp8 run."""
    jlm, params, tlm = yi
    tokens = _tokens(tlm.cfg.vocab_size)
    jp, nxt, jd = _jax_logits(jlm, params, tokens, jnp.float8_e4m3fn)
    tp, td, caches = _port_logits(tlm, tokens, nxt, FP8)
    assert all(c["k"].dtype == FP8 and c["v"].dtype == FP8 for c in caches)
    np.testing.assert_allclose(tp, jp, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(td, jd, rtol=TOL, atol=TOL)


def test_fp8_cache_decode_top1_matches_bf16(yi):
    """JAX's own bound on the port: fp8 noise stays below 0.15 of the
    bf16 cache's logits, and greedy decoding is unchanged."""
    jlm, params, tlm = yi
    tokens = _tokens(tlm.cfg.vocab_size)
    _, nxt, _ = _jax_logits(jlm, params, tokens, jnp.bfloat16)
    _, b16, _ = _port_logits(tlm, tokens, nxt, torch.bfloat16)
    _, f8, _ = _port_logits(tlm, tokens, nxt, FP8)
    rel = np.abs(b16 - f8).max() / (np.abs(b16).max() + 1e-9)
    assert rel < 0.15, rel
    assert (b16.argmax(-1) == f8.argmax(-1)).all()


def test_fp8_cache_halves_bytes(yi):
    _, _, tlm = yi
    b16 = sum(t.numel() * t.element_size() for c in tlm.init_cache(
        2, 32, dtype=torch.bfloat16) for t in c.values())
    b8 = sum(t.numel() * t.element_size() for c in tlm.init_cache(
        2, 32, dtype=FP8) for t in c.values())
    assert b8 == b16 // 2


def test_fp8_paged_write_and_gather_are_exact():
    """The paged pool in fp8 holds the bytes the slot cache holds: a write
    through the block table, then the gather, gives back each slot's
    rows cast to e4m3, bit for bit; masked-off slots write the null
    page."""
    gen = torch.Generator().manual_seed(0)
    rows, ps, h, d = 9, 4, 2, 8
    pool = torch.zeros(rows, ps, h, d, dtype=FP8)
    new = torch.randn(2, 3, h, d, generator=gen)
    table = torch.tensor([[3, 5, 0], [7, 2, 0]], dtype=torch.int32)
    cache_len = torch.tensor([2, 4])
    paged_write(pool, new, cache_len, table, torch.tensor([True, True]))
    view = paged_gather(pool, table)
    assert view.dtype == FP8
    want = new.to(FP8)
    for b in range(2):
        got = view[b, int(cache_len[b]):int(cache_len[b]) + 3]
        assert torch.equal(got.view(torch.uint8), want[b].view(torch.uint8))
    before = pool.view(torch.uint8).clone()
    paged_write(pool, new, cache_len, table, torch.tensor([False, False]))
    changed = (pool.view(torch.uint8) != before).flatten(1).any(1)
    assert changed.nonzero().flatten().tolist() in ([], [0])  # null page
