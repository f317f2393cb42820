"""The port's MoE layer and reduced deepseek-v2-lite-16b against the JAX
package, in f32 compute on the CPU, on the same weights (the JAX trees
handed over through ``repro_torch.interop`` as numpy arrays) and the
same inputs (made with numpy from a seed).

Tolerances:

* MoE: y and the aux loss to 1e-5 (f32 products summed in another
  order; |y| is O(1)); the selected experts equal. ``torch.topk`` and
  ``jax.lax.top_k`` may order tied scores differently, so where the k-th
  and (k+1)-th scores of a token lie within 1e-6 the failure says so.
* reduced deepseek logits: 1e-4 (three layers of f32 products; |logits|
  is O(1)), prefill and one decode step, with float weights rounded to
  bf16 values (computed in f32) and with int8 weights quantized by the
  JAX package.
* serving: greedy streams equal to the JAX engine's (slot, chunked and
  paged).

The MoE properties of ``tests/test_moe.py`` are held on the port too:
the capacity formula, overflow dropped, the shared expert always
contributing, per-token determinism across batching, and an aux loss
that penalises imbalance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.configs.base import SparsityConfig as JaxSparsityConfig
from repro.core.nmweight import NMWeight as JaxNMWeight
from repro.models import common as jcommon
from repro.models.cache import CacheView as JaxCacheView
from repro.models.common import linear_apply as jax_linear_apply
from repro.models.moe import _moe_apply_local
from repro.models.moe import capacity as jax_capacity
from repro.models.moe import moe_init
from repro.models.transformer import LM as JaxLM
from repro.quant import QNMWeight as JaxQNMWeight
from repro.quant import quantize_tree as jax_quantize_tree
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_reduced
from repro_torch.configs.base import MoEConfig
from repro_torch.interop import lm_from_jax, mlp_from_jax
from repro_torch.kernels import registry
from repro_torch.models.cache import CacheView
from repro_torch.models.moe import MoE, capacity
from repro_torch.serving.engine import Request, ServeEngine

TOL = 1e-5
LOGIT_TOL = 1e-4
D = 32


def numpy_tree(tree):
    """The JAX param tree as numpy arrays, each NMWeight / QNMWeight as
    the dict ``repro_torch.interop`` takes."""
    if isinstance(tree, (JaxNMWeight, JaxQNMWeight)):
        node = {"vals": np.asarray(tree.vals), "idx": np.asarray(tree.idx),
                "n": tree.nm.n, "m": tree.nm.m, "axis": tree.axis,
                "mode": tree.kernel_policy.mode}
        if isinstance(tree, JaxQNMWeight):
            node["scales"] = np.asarray(tree.scales)
        return node
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module", autouse=True)
def f32_compute():
    jcommon.set_compute_dtype(jnp.float32)
    yield
    jcommon.set_compute_dtype(jnp.bfloat16)


def _pair(e=8, k=2, dexp=64, shared=1, cf=1.25, sparse=True, seed=0):
    """(JAX MoEConfig, JAX params, port MoE) on the same weights."""
    kw = dict(n_experts=e, top_k=k, d_expert=dexp, n_shared=shared,
              capacity_factor=cf)
    jcfg = JaxMoEConfig(**kw)
    sp = JaxSparsityConfig(use_kernel=True) if sparse else None
    params = moe_init(jax.random.PRNGKey(seed), D, jcfg, sp=sp)
    tmoe = mlp_from_jax(MoEConfig(**kw), numpy_tree(params),
                        dtype=torch.float32, device="cpu")
    return jcfg, params, tmoe


def _x(shape, seed, positive=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.abs(x) if positive else x


def _port(tmoe, x):
    with torch.inference_mode():
        y, aux = tmoe(torch.from_numpy(x))
    return y.numpy(), float(aux)


def _jax_selection(params, x, cfg):
    """(scores, selected experts) of the JAX router on flat x."""
    xf = jnp.asarray(x.reshape(-1, x.shape[-1]))
    logits = jax_linear_apply(params["router"], xf,
                              compute_dtype=jnp.float32)
    scores = jax.nn.softmax(logits, axis=-1)
    _, sel = jax.lax.top_k(scores, cfg.top_k)
    return np.asarray(scores), np.asarray(sel)


@pytest.mark.parametrize("shared,cf,sparse", [
    (1, 1.25, True), (2, 1.25, False), (0, 0.01, True)],
    ids=["shared1-2:4", "shared2-dense", "overflow-2:4"])
def test_moe_matches_jax(shared, cf, sparse):
    """y, aux and the selected experts equal JAX's _moe_apply_local; at
    capacity factor 0.01 (capacity 8 for 64 assignments a slot) the
    dropped overflow too."""
    jcfg, params, tmoe = _pair(shared=shared, cf=cf, sparse=sparse)
    x = _x((2, 16, D), seed=1)
    jy, jaux = _moe_apply_local(params, jnp.asarray(x), jcfg)
    scores, jsel = _jax_selection(params, x, jcfg)
    with torch.inference_mode():
        _, _, tsel = tmoe.route(torch.from_numpy(x.reshape(-1, D)))
    top = np.sort(scores, -1)[:, ::-1]
    ties = np.nonzero(top[:, jcfg.top_k - 1] - top[:, jcfg.top_k] < 1e-6)[0]
    assert np.array_equal(tsel.numpy(), jsel), (
        f"selected experts differ; tokens whose k-th and (k+1)-th scores "
        f"lie within 1e-6 (a tie top_k may order either way): "
        f"{ties.tolist()}")
    ty, taux = _port(tmoe, x)
    np.testing.assert_allclose(ty, np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(taux, float(jaux), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tokens,e,k,cf", [
    (256, 8, 2, 1.0), (4, 8, 2, 1.0), (4, 64, 6, 1.25), (512, 64, 6, 1.25),
    (256, 64, 6, 1.25), (64, 4, 2, 0.01), (1000, 16, 3, 1.1)])
def test_capacity_formula(tokens, e, k, cf):
    """The JAX formula: max(8, round_up(int(T k / E * cf), 8))."""
    kw = dict(n_experts=e, top_k=k, capacity_factor=cf)
    assert capacity(tokens, MoEConfig(**kw)) == jax_capacity(
        tokens, JaxMoEConfig(**kw))
    assert capacity(256, MoEConfig(n_experts=8, top_k=2,
                                   capacity_factor=1.0)) == 64


def test_overflow_dropped():
    """Capacity 8 for 128 assignments over 8 experts: each expert keeps
    its 8 first assignments in token order; a token whose k assignments
    were all dropped gets no routed output (no shared expert here)."""
    jcfg, _, tmoe = _pair(shared=0, cf=0.01)
    x = _x((1, 64, D), seed=3)
    assert capacity(64, tmoe.cfg) == 8
    y, _ = _port(tmoe, x)
    assert np.isfinite(y).all()
    with torch.inference_mode():
        _, _, sel = tmoe.route(torch.from_numpy(x[0]))
    sel = sel.numpy()
    kept = np.zeros_like(sel, bool)
    seen = np.zeros(tmoe.cfg.n_experts, int)
    for a, ex in enumerate(sel.reshape(-1)):  # stable order: token, slot
        kept.reshape(-1)[a] = seen[ex] < 8
        seen[ex] += 1
    assert (~kept).any()
    dropped = ~kept.any(-1)
    np.testing.assert_array_equal(y[0][dropped], 0.0)
    assert (np.abs(y[0][~dropped]).max(-1) > 0).all()


def test_shared_expert_always_contributes():
    _, _, tmoe = _pair(shared=1)
    x = _x((1, 8, D), seed=4)
    y_s, _ = _port(tmoe, x)
    tmoe.shared = None
    y_n, _ = _port(tmoe, x)
    assert (np.abs(y_s - y_n).max(-1) > 1e-6).all()  # every token


def test_per_token_determinism_across_batching():
    _, _, tmoe = _pair()
    x = _x((1, 32, D), seed=2)
    y_full, _ = _port(tmoe, x)
    y_a, _ = _port(tmoe, x[:, :16])
    y_b, _ = _port(tmoe, x[:, 16:])
    np.testing.assert_allclose(y_full[:, :16], y_a, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y_full[:, 16:], y_b, rtol=TOL, atol=TOL)


def test_aux_loss_penalizes_imbalance():
    """A router projecting positive inputs onto expert 0 routes every
    token there: E f_0 P_0 = 4 * 0.5 * 1 = 2 (x coef 1e-3) for top-2 of
    4; random routing stays below it."""
    _, _, tmoe = _pair(e=4, shared=0)
    x = _x((1, 128, D), seed=5, positive=True)
    _, aux_rand = _port(tmoe, x)
    w = torch.zeros(D, 4)
    w[:, 0] = 1.0
    tmoe.router.hold(w)
    _, aux_skew = _port(tmoe, x)
    assert aux_skew > 0.0019
    assert aux_rand < aux_skew


def test_aux_loss_only_when_asked():
    """Without ``with_aux`` the layer skips the loss (a serving step runs
    none of its ops) and its output is bit-equal to the one with it."""
    _, _, tmoe = _pair()
    x = torch.from_numpy(_x((2, 16, D), seed=6))
    with torch.inference_mode():
        y_aux, aux = tmoe(x)
        y, none = tmoe(x, with_aux=False)
    assert none is None and aux is not None
    assert torch.equal(y, y_aux)


# ---------------------------------------------------------------------------
# reduced deepseek-v2-lite-16b: the LM and the engines
# ---------------------------------------------------------------------------


def _with_kernels(cfg):
    return dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, use_kernel=True))


def _bf16_values(tree):
    """Every float leaf rounded to bf16 values, kept f32."""
    return jax.tree.map(
        lambda a: a.astype(jnp.bfloat16).astype(jnp.float32)
        if a.dtype == jnp.float32 else a, tree)


@pytest.fixture(scope="module")
def deepseek():
    jlm = JaxLM(_with_kernels(jax_reduced("deepseek-v2-lite-16b")))
    params = jlm.init(jax.random.PRNGKey(0))
    return jlm, params


@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_reduced_deepseek_logits_match_jax(deepseek, weights):
    """Prefill and one decode step; the aux loss of the prefill too."""
    jlm, params = deepseek
    params = (_bf16_values(params) if weights == "bf16"
              else jax_quantize_tree(params))
    tlm = lm_from_jax(_with_kernels(get_reduced("deepseek-v2-lite-16b")),
                      numpy_tree(params), dtype=torch.float32, device="cpu")
    toks = np.random.default_rng(0).integers(0, 512, (2, 8)).astype(np.int32)
    jl, jc, jaux = jlm.forward(params, jnp.asarray(toks),
                               view=JaxCacheView.prefill(),
                               caches=jlm.init_cache(2, 16, jnp.float32))
    registry.clear_history()
    with torch.inference_mode():
        tl, tc, taux = tlm(torch.from_numpy(toks), view=CacheView.prefill(),
                           caches=tlm.init_cache(2, 16), with_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL, atol=TOL)
    family = "nm_matmul_q" if weights == "int8" else "nm_matmul"
    assert sum(registry.dispatch_counts(family).values()) > 0
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
    assert all(set(c) == {"ckv", "kr"} for c in tc)


def _mixed_stream(n=5, seed=3, vocab=512):
    """Mixed lengths; request 2 shares a prefix with request 0."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, vocab, size=ln).astype(np.int32)
               for ln in (8, 5, 8, 3, 8)[:n]]
    prompts[2][:4] = prompts[0][:4]
    return prompts, [3 + i % 4 for i in range(n)]


@pytest.fixture(scope="module")
def deepseek_engines():
    """The JAX reduced deepseek (reference policy, as the JAX package's
    MLA paging test serves it) and the port's on the same weights."""
    cfg = jax_reduced("deepseek-v2-lite-16b")
    jlm = JaxLM(cfg)
    params = jlm.init(jax.random.PRNGKey(1))
    tlm = lm_from_jax(get_reduced("deepseek-v2-lite-16b"),
                      numpy_tree(params), dtype=torch.float32, device="cpu")
    return jlm, params, tlm


@pytest.mark.parametrize("kw", [
    dict(), dict(prefill_chunk=4), dict(prefill_chunk=4, paged=True)],
    ids=["slot", "chunked", "paged"])
def test_engine_streams_equal_jax(deepseek_engines, kw):
    jlm, params, tlm = deepseek_engines
    prompts, max_news = _mixed_stream()
    kw = dict(slots=2, max_seq=32, prefill_len=8, **kw)
    jeng = JaxServeEngine(jlm, params, **kw)
    teng = ServeEngine(tlm, **kw)
    for i, (p, n) in enumerate(zip(prompts, max_news)):
        jeng.submit(JaxRequest(rid=i, prompt=p.copy(), max_new=n))
        teng.submit(Request(rid=i, prompt=p.copy(), max_new=n))
    want = {r.rid: tuple(r.out) for r in jeng.run()}
    got = {r.rid: tuple(r.out) for r in teng.run()}
    assert got == want
    assert teng.compiled_cache_sizes() == {"prefill": 1, "decode": 1}
    if kw.get("paged"):
        assert teng.throughput_stats()["prefix_hit_pages"] == \
            jeng.throughput_stats()["prefix_hit_pages"]


def test_moe_module_is_capturable_shape_static():
    """Every buffer of the dispatch follows from (T, E, k, C): two inputs
    of one shape run the same ops whatever their routing (no host read
    of a routed count), so the MoE can sit inside a captured step."""
    _, _, tmoe = _pair()
    assert isinstance(tmoe, MoE)
    calls = []

    def record(mod, args, out):
        calls.append(tuple(args[0].shape))

    hooks = [ex.register_forward_hook(record) for ex in tmoe.experts]
    try:
        _port(tmoe, _x((2, 16, D), seed=7))
        first = list(calls)
        calls.clear()
        _port(tmoe, _x((2, 16, D), seed=8, positive=True))
    finally:
        for h in hooks:
            h.remove()
    c = capacity(32, tmoe.cfg)
    assert first == calls == [(c, D)] * tmoe.cfg.n_experts


def test_quantize_tree_covers_experts_shared_and_mla(deepseek):
    """The port's quantize_tree on reduced deepseek switches every expert,
    shared-expert and MLA projection to int8 with the scales JAX's
    quantize_tree gives the same weights (bit-equal), and leaves the f32
    router and the dense w_uk / w_uv as they were."""
    from repro_torch.models.common import Linear
    from repro_torch.quant import QNMWeight, quantize_tree

    _, params = deepseek
    tcfg = _with_kernels(get_reduced("deepseek-v2-lite-16b"))
    tlm = quantize_tree(lm_from_jax(tcfg, numpy_tree(params),
                                    dtype=torch.float32, device="cpu"))
    want = lm_from_jax(tcfg, numpy_tree(jax_quantize_tree(params)),
                       dtype=torch.float32, device="cpu")
    pairs = [(a, b) for a, b in zip(tlm.modules(), want.modules())
             if isinstance(a, Linear)]
    # 3 MLA x 4 projections, layer 0's FFN, 2 MoE x (8 experts + shared)
    # x 3; dense: 2 routers and lm_head
    assert len(pairs) == 3 * 4 + 3 + 2 * 3 * (8 + 1) + 2 + 1
    quantized = 0
    for got, ref in pairs:
        if ref.nm is None:  # dense: the router, lm_head
            assert got.nm is None and got.w.dtype == torch.float32
            torch.testing.assert_close(got.w, ref.w, rtol=0, atol=0)
            continue
        assert isinstance(got.weight, QNMWeight)
        torch.testing.assert_close(got.scales, ref.scales, rtol=0, atol=0)
        assert torch.equal(got.vals, ref.vals)
        quantized += 1
    assert quantized == 3 * 4 + 3 + 2 * 3 * (8 + 1)
    for layer, ref in zip(tlm.layers, want.layers):
        assert layer.mixer.w_uk.dtype == torch.float32
        assert torch.equal(layer.mixer.w_uk, ref.mixer.w_uk)
