"""Reduced gemma3-27b (GeGLU, 5 local layers of window 16 to 1 global
with their own rope thetas, qk-norm, a period plus a tail, the tied
head) against the JAX package on the CPU at f32, on the same weights
through ``repro_torch.interop``; the tied head's bounded temporary; the
serving engines (slot, chunked, paged) against the JAX engine.

Tolerances: FFN outputs 1e-5 (``tests/test_torch_moe.py``'s ``TOL``),
logits and cache leaves 1e-4 (``LOGIT_TOL``); the chunked head against
one f32 product 1e-6 (the same products, summed in chunks of the
vocabulary). Greedy token streams must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_reduced as jax_reduced
from repro.configs.base import FFNConfig as JaxFFNConfig
from repro.configs.base import SparsityConfig as JaxSparsityConfig
from repro.models import common as jcommon
from repro.models.cache import CacheView as JaxCacheView
from repro.models.ffn import ffn_apply, ffn_init
from repro.models.transformer import LM as JaxLM
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_reduced
from repro_torch.configs.base import FFNConfig
from repro_torch.interop import lm_from_jax, mlp_from_jax
from repro_torch.kernels import registry
from repro_torch.models import common
from repro_torch.models.cache import CacheView
from repro_torch.serving.engine import Request, ServeEngine
from test_torch_moe import TOL, numpy_tree
from test_torch_rwkv import _jax_layer_caches

LOGIT_TOL = 1e-4
GEMMA = "gemma3-27b"
B, S, STEPS = 2, 20, 4  # S > the reduced window (16)


def _close(got, want, tol=LOGIT_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def _with_kernels(cfg, **kw):
    return dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, use_kernel=True), **kw)


@pytest.fixture(scope="module")
def gemma():
    """The JAX model and params, the port's model on them, and JAX's
    prefill of S tokens and STEPS greedy decode steps (logits, the tokens
    fed, every layer's cache after each call)."""
    jcommon.set_compute_dtype(jnp.float32)
    try:
        jlm = JaxLM(_with_kernels(jax_reduced(GEMMA)))
        params = jax.jit(jlm.init)(jax.random.PRNGKey(0))
        toks = np.random.default_rng(0).integers(0, 512, (B, S)).astype(
            np.int32)
        jc = jlm.init_cache(B, S + STEPS, jnp.float32)
        jl, jc, _ = jlm.forward(params, jnp.asarray(toks),
                                view=JaxCacheView.prefill(), caches=jc)
        calls = [(np.asarray(jl), toks, _jax_layer_caches(
            jax.tree.map(np.asarray, jc), jlm.cfg.plan))]
        for i in range(STEPS):
            nxt = np.argmax(calls[-1][0][:, -1], -1).astype(np.int32)[:, None]
            jl, jc, _ = jlm.forward(
                params, jnp.asarray(nxt), view=JaxCacheView.decode(
                    jnp.asarray(np.full((B,), S + i, np.int32))), caches=jc)
            calls.append((np.asarray(jl), nxt, _jax_layer_caches(
                jax.tree.map(np.asarray, jc), jlm.cfg.plan)))
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)
    tlm = lm_from_jax(_with_kernels(get_reduced(GEMMA)), numpy_tree(params),
                      device="cpu")
    return jlm, params, tlm, calls


def test_interop_unstacks_the_period_and_the_tail(gemma):
    """7 layers: a period of 5 local (window 16, theta 1e4) and 1 global
    (theta 1e6), then the tail's local one; no lm_head (tied)."""
    _, _, tlm, _ = gemma
    got = [(layer.block.mixer.window, layer.block.mixer.rope_theta)
           for layer in tlm.layers]
    assert got == [(16, 1e4)] * 5 + [(None, 1e6), (16, 1e4)]
    assert tlm.lm_head is None and tlm.pos is None
    assert all(layer.mlp.w_gate is not None for layer in tlm.layers)


@pytest.mark.parametrize("m", [4, 24], ids=["decode", "prefill"])
def test_geglu_matches_ffn_apply(m):
    """GeGLU: gelu(x @ w_gate) * (x @ w_up) @ w_down, the gelu the
    gate's epilogue (fused into the decode kernel family at M = 4)."""
    jcfg = JaxFFNConfig(d_ff=256, act="geglu")
    params = ffn_init(jax.random.PRNGKey(3), 128, jcfg,
                      sp=JaxSparsityConfig(use_kernel=True))
    x = np.random.default_rng(4).standard_normal((m, 128)).astype(np.float32)
    jcommon.set_compute_dtype(jnp.float32)
    try:
        want = np.asarray(ffn_apply(params, jnp.asarray(x), jcfg))
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)
    ffn = mlp_from_jax(FFNConfig(d_ff=256, act="geglu"), numpy_tree(params),
                       device="cpu")
    registry.clear_history()
    with torch.inference_mode():
        got = ffn(torch.from_numpy(x))
    _close(got, want, tol=TOL)
    fam = "nm_matmul_decode" if m <= 8 else "nm_matmul"
    assert registry.dispatch_counts(fam)[(fam, fam.replace(
        "nm_matmul", "nm_spmm"), "cpu")] == 3


def test_prefill_and_decode_across_the_window_match_jax(gemma):
    """A 20-token prefill and 4 decode steps: every local layer's window
    (16) cuts positions in both; logits and every cache leaf."""
    _, _, tlm, calls = gemma
    cache = tlm.init_cache(B, S + STEPS)
    with torch.inference_mode():
        for step, (jl, fed, jc) in enumerate(calls):
            view = (CacheView.prefill() if step == 0 else
                    CacheView.decode(torch.full((B,), S + step - 1)))
            tl, _ = tlm(torch.from_numpy(fed), view=view, caches=cache)
            _close(tl, jl, msg=f"logits, call {step}")
            for layer, (t, j) in enumerate(zip(cache, jc)):
                for k in ("k", "v"):
                    _close(t[k], j[k], msg=f"call {step} layer {layer} {k}")


def test_logit_softcap_matches_jax(gemma):
    """``logit_softcap`` set by ``dataclasses.replace`` on both sides (c =
    2, so it bites): train logits equal JAX's and lie within (-c, c)."""
    _, params, _, calls = gemma
    c = 2.0
    jlm = JaxLM(_with_kernels(jax_reduced(GEMMA), logit_softcap=c))
    toks = calls[0][1]
    jcommon.set_compute_dtype(jnp.float32)
    try:
        jl = np.asarray(jlm.forward(params, jnp.asarray(toks))[0])
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)
    tlm = lm_from_jax(_with_kernels(get_reduced(GEMMA), logit_softcap=c),
                      numpy_tree(params), device="cpu")
    with torch.inference_mode():
        tl, _ = tlm(torch.from_numpy(toks))
    _close(tl, jl)
    assert float(tl.abs().max()) < c


class _Sizes(TorchDispatchMode):
    """The bytes of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.made.append((str(func), tuple(t.shape),
                                  t.numel() * t.element_size()))
        return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_tied_head_bounds_its_temporary(monkeypatch, dtype):
    """``Embedding.attend`` gives x.float() @ table.float().T (1e-6) and
    no op in it returns more than ``HEAD_TEMP_BYTES`` but the logits
    (an f32 copy of the whole table would be 10x the bound)."""
    monkeypatch.setattr(common, "HEAD_TEMP_BYTES", 4 * 64 * 100)
    g = torch.Generator().manual_seed(0)
    emb = common.Embedding(torch.randn(1000, 64, generator=g).to(dtype))
    x = torch.randn(2, 3, 64, generator=g).to(dtype)
    assert common.head_rows(1000, 64) == 100
    with torch.inference_mode(), _Sizes() as sizes:
        got = emb.attend(x)
    want = x.float() @ emb.table.float().t()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    temps = [m for m in sizes.made if m[1] != tuple(got.shape)]
    assert temps and max(n for _, _, n in temps) <= 4 * 64 * 100, temps


def _prompts(n=5, seed=1):
    """Mixed lengths up to 24, most past the window; two share 8 tokens
    with request 0."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 512, size=ln).astype(np.int32)
               for ln in (24, 18, 24, 10, 24)[:n]]
    prompts[2][:8] = prompts[0][:8]
    prompts[4][:8] = prompts[0][:8]
    return prompts, [3 + i % 4 for i in range(n)]


def _cut(cfg):
    """The period's last local and its global layer (window 16, theta
    1e4; no window, theta 1e6), the tied head: every kind of layer at a
    third of the JAX engine's compile time."""
    period = cfg.plan[0][0]
    return dataclasses.replace(cfg, plan=((period[-2:], 1),))


@pytest.fixture(scope="module")
def gemma_cut():
    jlm = JaxLM(_with_kernels(_cut(jax_reduced(GEMMA))))
    params = jax.jit(jlm.init)(jax.random.PRNGKey(1))
    tlm = lm_from_jax(_with_kernels(_cut(get_reduced(GEMMA))),
                      numpy_tree(params), device="cpu")
    return jlm, params, tlm


@pytest.mark.parametrize("layout", ["slot", "chunked", "paged"])
def test_engine_streams_equal_jax(gemma_cut, layout):
    """The serving engine on reduced gemma3 cut to a local and a global
    layer (prompts past the window), slot, chunked (chunks of 8) and
    paged (pages of 8): greedy streams equal the JAX engine's, one step
    shape a kind."""
    jlm, params, tlm = gemma_cut
    assert [layer.block.mixer.window for layer in tlm.layers] == [16, None]
    kw = dict(slots=2, max_seq=32, prefill_len=24)
    kw.update({"slot": {}, "chunked": dict(prefill_chunk=8),
               "paged": dict(prefill_chunk=8, paged=True,
                             page_size=8)}[layout])
    prompts, max_news = _prompts()
    jcommon.set_compute_dtype(jnp.float32)
    try:
        jeng = JaxServeEngine(jlm, params, **kw)
        for i, (p, n) in enumerate(zip(prompts, max_news)):
            jeng.submit(JaxRequest(rid=i, prompt=p.copy(), max_new=n))
        want = {r.rid: tuple(r.out) for r in jeng.run()}
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)
    teng = ServeEngine(tlm, **kw)
    for i, (p, n) in enumerate(zip(prompts, max_news)):
        teng.submit(Request(rid=i, prompt=p.copy(), max_new=n))
    got = {r.rid: tuple(r.out) for r in teng.run()}
    assert got == want
    assert teng.compiled_cache_sizes() == {"prefill": 1, "decode": 1}
