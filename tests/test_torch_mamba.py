"""The port's Mamba-1 mixer against the JAX package's
(``repro.models.mamba``) on the CPU, at f32 on the same weights (the
JAX tree handed over through ``repro_torch.interop``).

Tolerance: outputs and cache leaves 1e-4 (``LOGIT_TOL``: f32 sums in
another order; |values| are O(1)). In bf16 (weights rounded to bf16,
bf16 activations) the port is held against JAX's bf16 compute on the
same weights: XLA rounds a fused chain of bf16 ops once where PyTorch
rounds each op, so neither bf16 path is held to the other; each output
may lie at most ``BF16_C`` times as far from JAX's f32 answer as JAX's
bf16 path does (``assert_bf16_as_close``; the CPU readings on these
weights: at most 1.32 for the mixers, 1.30 for the reduced models). A
leaf both compute in f32 from the same bf16 inputs is held to JAX's bf16
run within ``LOGIT_TOL``.

* Train, prefill from a zero cache and from a non-zero one (JAX starts
  the scan from the cache's state), decode; the new ``conv`` history and
  ``ssm`` state, both f32; a write mask keeps the slots outside it.
* bf16: the output, the ``ssm`` state (within ``BF16_C``) and the
  ``conv`` history (``LOGIT_TOL``) against JAX's bf16 run.
* The projections: ``w_in`` / ``w_x`` / ``w_out`` compressed on the
  "attn_proj" target (``w_x``'s N = dt_rank + 2 d_state is not a
  multiple of any tile at full width: 288), ``w_dt`` dense; int8 through
  ``quantize_tree`` leaves ``w_dt`` and the vectors alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MambaConfig as JaxMambaConfig
from repro.configs.base import SparsityConfig as JaxSparsity
from repro.models import common as jcommon
from repro.models import mamba as jmamba
from repro.quant import quantize_tree as jax_quantize_tree
from repro_torch.configs import get_config
from repro_torch.configs.base import MambaConfig
from repro_torch.interop import mixer_from_jax
from repro_torch.models.cache import CacheView
from repro_torch.models.common import Linear
from repro_torch.models.mamba import Mamba, mamba_empty_cache
from repro_torch.quant import QNMWeight, quantize_tree
from test_torch_moe import numpy_tree

LOGIT_TOL = 1e-4
BF16_C = 2.0
D = 64
CFG = dict(d_state=8, d_conv=4, expand=2, dt_rank=12)


@pytest.fixture(scope="module", autouse=True)
def f32_compute():
    jcommon.set_compute_dtype(jnp.float32)
    yield
    jcommon.set_compute_dtype(jnp.bfloat16)


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL, err_msg=msg)


def bf16_params(params):
    """The JAX tree with every float leaf rounded to bf16 (kept in its
    dtype): the weights a bf16 model of the port holds."""
    def rnd(a):
        if jnp.issubdtype(a.dtype, jnp.floating):
            return a.astype(jnp.bfloat16).astype(a.dtype)
        return a
    return jax.tree_util.tree_map(rnd, params)


def jax_f32_and_bf16(run):
    """(run(jnp.float32), run(jnp.bfloat16)), each under that JAX compute
    dtype (left at f32)."""
    out = []
    for dt in (jnp.float32, jnp.bfloat16):
        jcommon.set_compute_dtype(dt)
        try:
            out.append(run(dt))
        finally:
            jcommon.set_compute_dtype(jnp.float32)
    return out


def assert_bf16_as_close(got, want32, want16, msg=""):
    """max|port bf16 - JAX f32| <= BF16_C * max|JAX bf16 - JAX f32|."""
    got = got.float().numpy()
    w32, w16 = (np.asarray(a, np.float32) for a in (want32, want16))
    port, jax_bf16 = np.abs(got - w32).max(), np.abs(w16 - w32).max()
    assert port <= BF16_C * jax_bf16, (
        f"{msg}: max|port bf16 - f32| = {port} beyond {BF16_C} x "
        f"max|JAX bf16 - f32| = {jax_bf16}")


def _mixer(seed=0, **kw):
    """A JAX Mamba tree (random conv bias, dt bias and skip, so every term
    counts) and the port's module on the same weights."""
    jcfg = JaxMambaConfig(**CFG)
    key = jax.random.PRNGKey(seed)
    params = jmamba.mamba_init(key, D, jcfg, sp=JaxSparsity(use_kernel=True))
    ks = jax.random.split(jax.random.fold_in(key, 5), 3)
    d_in = 2 * D
    params["conv_b"] = 0.1 * jax.random.normal(ks[0], (d_in,))
    params["dt_bias"] = jax.random.uniform(ks[1], (d_in,), minval=-3.0,
                                           maxval=0.0)
    params["d_skip"] = jax.random.normal(ks[2], (d_in,))
    tm = mixer_from_jax(MambaConfig(**CFG), numpy_tree(params),
                        device="cpu")
    assert isinstance(tm, Mamba)
    return jcfg, params, tm


def _cache(b, seed, zero):
    c = mamba_empty_cache(b, D, MambaConfig(**CFG), "cpu")
    if not zero:
        g = torch.Generator().manual_seed(seed)
        for v in c.values():
            v.copy_(torch.randn(v.shape, generator=g))
    return {k: v.numpy() for k, v in c.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("mode,zero", [("train", True), ("prefill", True),
                                       ("prefill", False),
                                       ("decode", False)],
                         ids=["train", "prefill-zero", "prefill-state",
                              "decode"])
def test_mamba_matches_jax(mode, zero):
    jcfg, params, tm = _mixer()
    s = 1 if mode == "decode" else 9
    x = _x((2, s, D), seed=1)
    cache = None if mode == "train" else _cache(2, seed=2, zero=zero)
    jy, jc = jmamba.mamba_apply(
        params, jnp.asarray(x), jcfg, mode=mode,
        cache=None if cache is None else {k: jnp.asarray(v)
                                          for k, v in cache.items()})
    tc = (None if cache is None
          else {k: torch.from_numpy(v.copy()) for k, v in cache.items()})
    view = (CacheView.decode(torch.full((2,), 3)) if mode == "decode"
            else CacheView(mode=mode))
    with torch.inference_mode():
        ty = tm(torch.from_numpy(x), view=view, cache=tc)
    _close(ty, jy, "output")
    if tc is not None:
        assert {k: v.dtype for k, v in tc.items()} == {
            "conv": torch.float32, "ssm": torch.float32}
        _close(tc["conv"], jc["conv"], "conv")
        _close(tc["ssm"], jc["ssm"], "ssm")


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mamba_bf16_matches_jax_bf16(mode):
    """bf16 weights and activations (the served model's dtypes): the
    output and the ``ssm`` state lie at most BF16_C times as far from
    JAX's f32 answer as JAX's bf16 path; the f32 ``conv`` history equals
    JAX's bf16 run's."""
    jcfg, params, _ = _mixer()
    params = bf16_params(params)
    tm = mixer_from_jax(MambaConfig(**CFG), numpy_tree(params),
                        dtype=torch.bfloat16, device="cpu")
    s = 1 if mode == "decode" else 9
    x = torch.from_numpy(_x((2, s, D), seed=1)).bfloat16()
    cache = None if mode == "train" else _cache(2, seed=2, zero=False)

    def run(dt):
        return jmamba.mamba_apply(
            params, jnp.asarray(x.float().numpy()).astype(dt), jcfg,
            mode=mode, cache=None if cache is None
            else {k: jnp.asarray(v) for k, v in cache.items()})

    (y32, c32), (y16, c16) = jax_f32_and_bf16(run)
    tc = (None if cache is None
          else {k: torch.from_numpy(v.copy()) for k, v in cache.items()})
    view = (CacheView.decode(torch.full((2,), 3)) if mode == "decode"
            else CacheView(mode=mode))
    with torch.inference_mode():
        ty = tm(x, view=view, cache=tc)
    assert ty.dtype == torch.bfloat16 and y16.dtype == jnp.bfloat16
    assert_bf16_as_close(ty, y32, y16, "output")
    if tc is not None:
        # JAX's decode returns the history in x's dtype (its cache keeps
        # f32); the values are bf16's either way
        assert {k: v.dtype for k, v in tc.items()} == {
            "conv": torch.float32, "ssm": torch.float32}
        _close(tc["conv"], c16["conv"], "conv")
        assert_bf16_as_close(tc["ssm"], c32["ssm"], c16["ssm"], "ssm")


def test_prefill_shorter_than_the_conv_keeps_zero_history():
    """A 2-token prefill: the history is [zeros, x0, x1], as JAX's."""
    jcfg, params, tm = _mixer(seed=3)
    x = _x((1, 2, D), seed=4)
    jy, jc = jmamba.mamba_apply(params, jnp.asarray(x), jcfg, mode="prefill",
                                cache={k: jnp.asarray(v) for k, v in
                                       _cache(1, 0, True).items()})
    tc = {k: torch.from_numpy(v) for k, v in _cache(1, 0, True).items()}
    with torch.inference_mode():
        ty = tm(torch.from_numpy(x), view=CacheView.prefill(), cache=tc)
    _close(ty, jy)
    _close(tc["conv"], jc["conv"])
    assert bool((tc["conv"][:, 0] == 0).all())


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_write_mask_keeps_the_other_slots(mode):
    _, _, tm = _mixer()
    s = 1 if mode == "decode" else 6
    x = torch.from_numpy(_x((2, s, D), seed=5))
    start = _cache(2, seed=6, zero=False)
    full = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    part = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    mask = torch.tensor([False, True])
    if mode == "decode":
        views = (CacheView.decode(torch.full((2,), 3)),
                 CacheView.decode(torch.full((2,), 3), mask))
    else:
        views = (CacheView.prefill(), CacheView.prefill(mask))
    with torch.inference_mode():
        y_full = tm(x, view=views[0], cache=full)
        y_part = tm(x, view=views[1], cache=part)
    assert torch.equal(y_full, y_part)
    for k in start:
        assert torch.equal(part[k][1], full[k][1]), k
        assert torch.equal(part[k][0], torch.from_numpy(start[k][0])), k


def test_chunk_and_paged_views_are_refused():
    _, _, tm = _mixer()
    cache = {k: torch.from_numpy(v) for k, v in _cache(1, 0, True).items()}
    with pytest.raises(NotImplementedError, match="attention"):
        tm(torch.zeros(1, 2, D), view=CacheView.chunk(torch.tensor([0])),
           cache=cache)
    with pytest.raises(NotImplementedError, match="attention"):
        tm(torch.zeros(1, 1, D), view=CacheView.decode(
            torch.tensor([0]), torch.tensor([True]),
            block_table=torch.zeros((1, 2), dtype=torch.long)), cache=cache)


def test_projections_targets_and_int8():
    """w_in, w_x and w_out compressed (attn_proj), w_dt dense; the port's
    quantize_tree gives JAX's int8 scales bit for bit and leaves w_dt,
    the conv and the vectors as they were."""
    _, params, tm = _mixer()
    assert [getattr(tm, n).nm is not None for n in
            ("w_in", "w_x", "w_dt", "w_out")] == [True, True, False, True]
    want = mixer_from_jax(MambaConfig(**CFG),
                          numpy_tree(jax_quantize_tree(params)),
                          device="cpu")
    w_dt = tm.w_dt.w.clone()
    quantize_tree(tm)
    for name in ("w_in", "w_x", "w_out"):
        got, ref = getattr(tm, name), getattr(want, name)
        assert isinstance(got.weight, QNMWeight), name
        assert torch.equal(got.scales, ref.scales), name
        assert torch.equal(got.vals, ref.vals), name
    assert not isinstance(tm.w_dt.weight, QNMWeight)
    assert torch.equal(tm.w_dt.w, w_dt)
    assert sum(isinstance(m, Linear) and m.quantized
               for m in tm.modules()) == 3


def test_full_width_shapes():
    """jamba's Mamba at full width: d_inner 8192, w_x 8192 -> 288 (ragged
    against every tile), the cache f32 whatever the model dtype."""
    cfg = get_config("jamba-v0.1-52b")
    mx = cfg.plan[0][0][0].mixer
    assert isinstance(mx, MambaConfig)
    d_in = mx.expand * cfg.d_model
    assert (d_in, mx.dt_rank + 2 * mx.d_state) == (8192, 288)
    c = mamba_empty_cache(4, cfg.d_model, mx, "meta")
    assert {k: (tuple(v.shape), v.dtype) for k, v in c.items()} == {
        "conv": ((4, 3, 8192), torch.float32),
        "ssm": ((4, 8192, 16), torch.float32)}
