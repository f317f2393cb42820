"""int8 weights of the PyTorch port against the JAX package, on the CPU:
quantization, the int8 plain versions, routing, interop, the reduced
yi-9b forward and the serving engine.

Inputs are made once with numpy from a seed and fed to both packages.
The JAX side runs its int8 kernels as its own tests do (``force`` runs
the Pallas kernels in interpret mode on the CPU) or through its plain
reference; the port's wrappers run their plain versions because the
tensors lie on the CPU.

Tolerances: absmax quantization of f32 values is the same f32
arithmetic in both packages, so scales and int8 values are bit-equal.
The percentile sorts and interpolates in f32 as ``jnp.percentile``
does; it is held to 1e-6 relative. Products on the integer lattice are
exact in any order, and the one f32 scale multiply is deterministic, so
they are bit-equal (with a bias after the scale, power-of-two scales
keep every step exact: XLA may fuse the JAX side's multiply and add
into one FMA); on random f32 inputs sums in another order differ
by a few ulps of the largest partial sum (1e-5, |y| is O(1)). Logits of
the reduced model agree to 1e-4 (two layers of such products); greedy
token streams must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.quant import AbsMaxObserver as JaxAbsMax
from repro.quant import PercentileObserver as JaxPercentile
from repro.quant import QNMWeight as JaxQNMWeight
from repro.quant import quantize_nm as jax_quantize_nm
from repro.quant import quantize_tree as jax_quantize_tree
from repro_torch import api
from repro_torch.core.nmweight import KernelPolicy, NMWeight
from repro_torch.core.sparsity import NMConfig
from repro_torch.kernels import registry
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.indexmac import decode_kernel, kernel
from repro_torch.kernels.indexmac.ops import (
    explain_dispatch,
    nm_matmul,
    nm_matmul_q,
)
from repro_torch.quant import (
    AbsMaxObserver,
    PercentileObserver,
    QNMWeight,
    dequantize,
    dequantize_tree,
    quantize_nm,
    quantize_tree,
)

F32_TOL = 1e-5
LOGIT_TOL = 1e-4
ACTS = [None, "relu", "gelu", "silu", "relu_sq"]


def _sparse_pair(k, n, nm, seed, scale=1.0):
    """The same N:M weight in both packages (pruned and compressed by the
    JAX package, handed over as numpy), f32."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * scale * k ** -0.5).astype(np.float32)
    jw = japi.sparsify(jnp.asarray(w), japi.NMConfig(*nm),
                       kernel_policy="force")
    tw = NMWeight(torch.from_numpy(np.array(jw.vals)),
                  torch.from_numpy(np.array(jw.idx)), NMConfig(*nm), 0,
                  KernelPolicy("force"))
    return jw, tw


def _as_torch(jq: JaxQNMWeight, mode="force") -> QNMWeight:
    return QNMWeight(torch.from_numpy(np.array(jq.vals)),
                     torch.from_numpy(np.array(jq.idx)),
                     torch.from_numpy(np.array(jq.scales)),
                     NMConfig(jq.nm.n, jq.nm.m), jq.axis, KernelPolicy(mode))


def _lattice_q(k, n, nm, seed, mode="force", pow2_scales=False):
    """int8 weights on the integer lattice (random int8 values, zero in
    the padded slots, random f32 scales, or powers of two), in both
    packages."""
    rng = np.random.default_rng(seed)
    jw, _ = _sparse_pair(k, n, nm, seed)
    q = rng.integers(-127, 128, jw.vals.shape).astype(np.int8)
    q = np.where(np.asarray(jw.vals) == 0, 0, q).astype(np.int8)
    if pow2_scales:
        scales = (2.0 ** -rng.integers(2, 8, n)).astype(np.float32)
    else:
        scales = rng.uniform(0.01, 0.1, n).astype(np.float32)
    jq = JaxQNMWeight(vals=jnp.asarray(q), idx=jw.idx,
                      scales=jnp.asarray(scales), nm=jw.nm,
                      kernel_policy=japi.KernelPolicy(mode))
    return jq, _as_torch(jq, mode)


def _x(m, k, seed, lattice=False):
    rng = np.random.default_rng(seed + 1000)
    if lattice:
        return rng.integers(-8, 9, (m, k)).astype(np.float32)
    return rng.standard_normal((m, k)).astype(np.float32)


def _run_both(x, jq, tq, bias=None, act=None):
    jep = tep = None
    if bias is not None or act is not None:
        jep = japi.Epilogue(bias=None if bias is None else jnp.asarray(bias),
                            activation=act)
        tep = Epilogue(bias=None if bias is None else torch.from_numpy(bias),
                       activation=act)
    want = np.asarray(japi.nm_matmul(jnp.asarray(x), jq, epilogue=jep))
    got = nm_matmul(torch.from_numpy(x), tq, epilogue=tep).numpy()
    return got, want


# ---------------------------------------------------------------------------
# quantization against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nm", [(2, 4), (1, 4), (3, 8)],
                         ids=lambda c: "%d:%d" % c)
@pytest.mark.parametrize("kn", [(64, 24), (256, 200), (96, 7)],
                         ids=lambda s: "K%dN%d" % s)
def test_absmax_quantize_bit_equal_to_jax(kn, nm):
    k, n = kn
    jw, tw = _sparse_pair(k, n, nm, seed=k + n)
    jq, tq = jax_quantize_nm(jw), quantize_nm(tw)
    assert tq.vals.dtype == torch.int8 and tq.scales.dtype == torch.float32
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(tq.vals.numpy(), np.asarray(jq.vals))
    np.testing.assert_array_equal(tq.idx.numpy(), np.asarray(jq.idx))
    assert tq.kernel_policy.mode == "force" and tq.nm == tw.nm
    # dequantize and to_dense: one f32 multiply each, bit-equal too
    np.testing.assert_array_equal(dequantize(tq).vals.numpy(),
                                  np.asarray(japi.dequantize(jq).vals))
    np.testing.assert_array_equal(tq.to_dense().numpy(),
                                  np.asarray(jq.to_dense()))


def test_quantize_dense_input_bit_equal_to_jax():
    w = np.random.default_rng(5).standard_normal((32, 12)).astype(np.float32)
    jq = japi.quantize(jnp.asarray(w), japi.NMConfig(2, 4))
    tq = api.quantize(torch.from_numpy(w), NMConfig(2, 4))
    np.testing.assert_array_equal(tq.vals.numpy(), np.asarray(jq.vals))
    np.testing.assert_array_equal(tq.idx.numpy(), np.asarray(jq.idx))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    assert tq.kernel_policy.mode == "auto"


@pytest.mark.parametrize("pct", [50.0, 90.0, 99.9, 100.0])
def test_percentile_matches_jax(pct):
    jw, tw = _sparse_pair(512, 16, (2, 4), seed=int(pct))
    jq = jax_quantize_nm(jw, method=JaxPercentile(pct))
    tq = quantize_nm(tw, method=PercentileObserver(pct))
    np.testing.assert_allclose(tq.scales.numpy(), np.asarray(jq.scales),
                               rtol=1e-6, atol=0)
    # equal scales quantize alike; a scale one ulp off may move a value
    # that sits on a rounding boundary by one step
    assert np.abs(tq.vals.numpy().astype(np.int32)
                  - np.asarray(jq.vals).astype(np.int32)).max() <= 1


def test_percentile_over_2_24_kept_values():
    """A full-width w_up keeps 22.5 M values; torch.quantile refuses
    inputs over 2**24 elements, the port's percentile sorts."""
    kc, n = 2 ** 22 + 4, 4  # (2**22 + 4) * 4 > 2**24
    rng = np.random.default_rng(24)
    vals = rng.standard_normal((kc, n)).astype(np.float32)
    vals[7] = 50.0  # an outlier row the percentile clips
    idx = np.tile(np.array([[0], [1]], np.int8), (kc // 2, n))
    jw = japi.NMWeight(jnp.asarray(vals), jnp.asarray(idx),
                       japi.NMConfig(2, 4))
    tw = NMWeight(torch.from_numpy(vals), torch.from_numpy(idx),
                  NMConfig(2, 4))
    assert tw.vals.numel() > 2 ** 24
    want = np.asarray(jax_quantize_nm(jw, method=JaxPercentile(99.0)).scales)
    got = quantize_nm(tw, method=PercentileObserver(99.0)).scales.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_observers_match_jax_over_several_observations():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((40, 6)).astype(np.float32)
    b = 3 * rng.standard_normal((24, 6)).astype(np.float32)
    tabs, jabs = AbsMaxObserver(), JaxAbsMax()
    tpct, jpct = PercentileObserver(95.0), JaxPercentile(95.0)
    for arr in (a, b):
        tabs.observe(torch.from_numpy(arr))
        jabs.observe(jnp.asarray(arr))
        tpct.observe(torch.from_numpy(arr))
        jpct.observe(jnp.asarray(arr))
    np.testing.assert_array_equal(tabs.scales().numpy(),
                                  np.asarray(jabs.scales()))
    np.testing.assert_allclose(tpct.scales().numpy(),
                               np.asarray(jpct.scales()), rtol=1e-6, atol=0)


def test_dequantize_error_bound_per_channel():
    """Absmax int8: |deq(q(w)) - w| <= scale / 2 with each channel's own
    scale (tests/test_quant.py's bound)."""
    _, tw = _sparse_pair(96, 20, (2, 4), seed=11)
    tq = quantize_nm(tw)
    err = (dequantize(tq).vals - tw.vals).abs()
    bound = tq.scales[None, :] * 0.5 * (1 + 1e-5) + 1e-7
    assert bool((err <= bound).all())


# ---------------------------------------------------------------------------
# validation (tests/test_quant.py:57-100, 142-150)
# ---------------------------------------------------------------------------


def test_quantize_dense_input_and_validation():
    nm = NMConfig(2, 4)
    qw = api.quantize(torch.randn(16, 8, generator=torch.Generator()
                                  .manual_seed(0)), nm)
    assert isinstance(qw, QNMWeight) and qw.vals.shape == (8, 8)
    with pytest.raises(ValueError, match="nm is required"):
        api.quantize(torch.ones(8, 4))
    with pytest.raises(ValueError, match="conflicts"):
        api.quantize(api.sparsify(torch.ones(8, 4), nm), NMConfig(1, 4))
    with pytest.raises(TypeError, match="already quantized"):
        api.quantize(qw)
    with pytest.raises(TypeError, match="QNMWeight"):
        api.dequantize(api.sparsify(torch.ones(8, 4), nm))


def test_percentile_observer_clips_outliers():
    nm = NMConfig(2, 4)
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((512, 4)).astype(np.float32))
    w[0, :] = 1e3  # an outlier in every channel
    sw = api.sparsify(w, nm)
    q_abs = api.quantize(sw, method="absmax")
    q_pct = api.quantize(sw, method=PercentileObserver(pct=90.0))
    assert float(q_pct.scales.max()) < float(q_abs.scales.min())
    assert int(q_pct.vals.max()) == 127  # the outlier saturated


def test_observer_api_validation():
    with pytest.raises(ValueError, match="no data"):
        AbsMaxObserver().scales()
    with pytest.raises(ValueError, match="no data"):
        PercentileObserver().scales()
    with pytest.raises(ValueError, match="pct"):
        PercentileObserver(pct=0.0)
    with pytest.raises(ValueError, match="unknown calibration"):
        quantize_nm(api.sparsify(torch.ones(8, 4), NMConfig(2, 4)),
                    method="zen")
    with pytest.raises(TypeError, match="method"):
        quantize_nm(api.sparsify(torch.ones(8, 4), NMConfig(2, 4)),
                    method=3)
    with pytest.raises(ValueError, match="axis changed"):
        PercentileObserver().observe(torch.ones(4, 4)).observe(
            torch.ones(4, 4), axis=1)
    obs = AbsMaxObserver()
    obs.observe(torch.ones(8, 4))
    obs.observe(2 * torch.ones(8, 4))  # a running max
    np.testing.assert_allclose(obs.scales().numpy(), 2.0 / 127)


def test_quantize_tree_rejects_shared_observer_instances():
    nm = NMConfig(2, 4)
    rng = np.random.default_rng(20)
    tree = {"a": api.sparsify(torch.from_numpy(
        rng.standard_normal((16, 8)).astype(np.float32)), nm)}
    with pytest.raises(TypeError, match="observer instance"):
        quantize_tree(tree, method=AbsMaxObserver())
    big = api.sparsify(torch.from_numpy(
        1e3 * rng.standard_normal((16, 8)).astype(np.float32)), nm)
    small = api.sparsify(torch.from_numpy(
        1e-3 * rng.standard_normal((16, 8)).astype(np.float32)), nm)
    qt = quantize_tree({"big": big, "small": small})
    assert float(qt["small"].scales.max()) < 1e-3
    assert int(qt["small"].vals.abs().max()) > 0


def test_quantize_tree_walks_weights_like_jax():
    """Dense leaves pass through, every compressed weight is quantized
    as quantize_nm quantizes it (bit-equal to the JAX tree walk), and
    dequantize_tree gives float weights back."""
    (j0, t0), (j1, t1) = (_sparse_pair(32, 16, (2, 4), seed=s)
                          for s in range(2))
    dense = torch.ones(4, 4)
    qt = quantize_tree({"a": t0, "dense": {"w": dense}, "list": [t1]})
    jqt = jax_quantize_tree({"a": j0, "list": [j1]})
    assert qt["dense"]["w"] is dense
    for got, want in ((qt["a"], jqt["a"]), (qt["list"][0], jqt["list"][0])):
        assert isinstance(got, QNMWeight)
        np.testing.assert_array_equal(got.scales.numpy(),
                                      np.asarray(want.scales))
        np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))
    back = dequantize_tree(qt)
    assert isinstance(back["list"][0], NMWeight)
    assert back["a"].vals.dtype == torch.float32
    stacked = NMWeight(torch.stack([t0.vals, t1.vals]),
                       torch.stack([t0.idx, t1.idx]), t0.nm)
    with pytest.raises(ValueError, match="2D"):
        quantize_tree({"stack": stacked})


# ---------------------------------------------------------------------------
# the int8 plain versions and nm_matmul against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nm", [(2, 4), (1, 4)], ids=lambda c: "%d:%d" % c)
@pytest.mark.parametrize("mkn", [(7, 128, 136), (36, 96, 20),
                                 (70, 132, 200)],
                         ids=lambda s: "M%dK%dN%d" % s)
def test_int8_lattice_bit_exact_vs_jax_kernels(mkn, nm):
    """The JAX package's Pallas int8 kernels (interpret mode, padded
    geometry) and its int8 oracle against the port's plain versions."""
    from repro.kernels.indexmac.ref import nm_matmul_q_ref

    m, k, n = mkn
    jq, tq = _lattice_q(k, n, nm, seed=m)
    x = _x(m, k, seed=m, lattice=True)
    registry.clear_history()
    got, want = _run_both(x, jq, tq)
    np.testing.assert_array_equal(got, want)
    oracle = np.asarray(nm_matmul_q_ref(jnp.asarray(x), jq.vals, jq.idx,
                                        jq.scales, jq.nm))
    np.testing.assert_array_equal(got, oracle)
    plain = kernel.nm_spmm_q_plain(torch.from_numpy(x), tq.vals, tq.idx,
                                   tq.scales, tq.nm)
    np.testing.assert_array_equal(plain.numpy(), oracle)
    op = "nm_matmul_decode_q" if m <= 8 else "nm_matmul_q"
    assert registry.dispatch_counts() == {
        (op, "nm_spmm_decode_q" if m <= 8 else "nm_spmm_q", "cpu"): 1}


@pytest.mark.parametrize("m", [1, 4, 7])
def test_int8_decode_lattice_epilogues_bit_exact(m):
    """The int8 decode kernel's epilogue order (x scales, + bias, then
    the activation) against the JAX decode kernel in interpret mode and
    the JAX int8 decode reference (policy off). The scales are powers of
    two, so that every step stays exact: XLA may fuse the JAX side's
    scale multiply and bias add into one FMA, which rounds once where
    the composition rounds twice (random scales with a bias are held to
    1e-5 in test_int8_f32_matches_jax)."""
    k, n = 256, 136
    jq, tq = _lattice_q(k, n, (2, 4), seed=m, pow2_scales=True)
    x = _x(m, k, seed=m, lattice=True)
    bias = np.arange(n, dtype=np.float32) - n // 2
    joff = dataclasses.replace(jq, kernel_policy=japi.KernelPolicy("off"))
    for b, act in ((None, None), (bias, "relu"), (bias, "relu_sq")):
        got, want = _run_both(x, jq, tq, b, act)
        np.testing.assert_array_equal(got, want)
        ref, _ = _run_both(x, joff, tq, b, act)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bias_on", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m", [1, 4, 7, 24])
def test_int8_f32_matches_jax(m, act, bias_on):
    k, n = 256, 136
    jw, tw = _sparse_pair(k, n, (2, 4), seed=3)
    jq, tq = jax_quantize_nm(jw), quantize_nm(tw)
    bias = (np.random.default_rng(m).standard_normal(n).astype(np.float32)
            if bias_on else None)
    got, want = _run_both(_x(m, k, seed=m), jq, tq, bias, act)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    want_plain = (decode_kernel.nm_spmm_decode_q_plain if m <= 8 else None)
    if want_plain is not None:
        plain = want_plain(torch.from_numpy(_x(m, k, seed=m)), tq.vals,
                           tq.idx, tq.scales,
                           None if bias is None else torch.from_numpy(bias),
                           tq.nm, act)
        np.testing.assert_allclose(got, plain.numpy(), rtol=0, atol=0)


def test_int8_prefill_applies_the_epilogue_after_the_cast():
    """The prefill families apply bias and activation to the output
    already cast to x's dtype (JAX ``_epilogue_after``); in bf16 that
    rounding shows."""
    jw, tw = _sparse_pair(128, 64, (2, 4), seed=5)
    jq, tq = jax_quantize_nm(jw), quantize_nm(tw)
    x = _x(24, 128, seed=5)
    bias = np.random.default_rng(5).standard_normal(64).astype(np.float32)
    want = np.asarray(japi.nm_matmul(
        jnp.asarray(x, jnp.bfloat16), jq,
        epilogue=japi.Epilogue(bias=jnp.asarray(bias), activation="silu"))
        .astype(jnp.float32))
    got = nm_matmul(torch.from_numpy(x).bfloat16(), tq,
                    epilogue=Epilogue(bias=torch.from_numpy(bias),
                                      activation="silu"))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-2)
    y = kernel.nm_spmm_q_plain(torch.from_numpy(x).bfloat16(), tq.vals,
                               tq.idx, tq.scales, tq.nm)
    after = torch.nn.functional.silu(y.float() + torch.from_numpy(bias))
    torch.testing.assert_close(got, after.bfloat16(), rtol=0, atol=0)


def test_int8_weight_is_never_cast():
    """An int8 payload reaches the int8 families as int8, whatever x's
    dtype; a float weight in another dtype than x is cast."""
    _, tw = _sparse_pair(64, 16, (2, 4), seed=2)
    tq = quantize_nm(tw)
    seen = []
    orig = kernel.nm_spmm_q_plain

    def spy(x, vals, idx, scales, cfg):
        seen.append((x.dtype, vals.dtype))
        return orig(x, vals, idx, scales, cfg)

    import repro_torch.kernels.indexmac.ops as ops

    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "nm_spmm_q", lambda x, v, i, s, cfg: spy(x, v, i, s, cfg))
    try:
        nm_matmul(torch.zeros(12, 64, dtype=torch.bfloat16), tq)
        nm_matmul(torch.zeros(12, 64), tq)
    finally:
        mp.undo()
    assert seen == [(torch.bfloat16, torch.int8), (torch.float32, torch.int8)]


# ---------------------------------------------------------------------------
# routing and explain_dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["off", "auto", "force"])
@pytest.mark.parametrize("xshape", [(1, 256), (2, 3, 256), (8, 256),
                                    (9, 256), (4, 32, 256)])
def test_int8_routing_by_m_and_explain_dispatch(xshape, mode):
    jw, tw = _sparse_pair(256, 40, (2, 4), seed=1)
    tq = dataclasses.replace(quantize_nm(tw), kernel_policy=KernelPolicy(mode))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        xshape).astype(np.float32))
    predicted = explain_dispatch(xshape, tq)
    registry.clear_history()
    y = nm_matmul(x, tq)
    assert y.shape == (*xshape[:-1], 40)
    assert registry.last_dispatch() == predicted
    decode = np.prod(xshape[:-1]) <= 8
    assert predicted.op == ("nm_matmul_decode_q" if decode else "nm_matmul_q")
    jq = dataclasses.replace(jax_quantize_nm(jw),
                             kernel_policy=japi.KernelPolicy(mode))
    assert japi.explain_dispatch(xshape, jq).op == predicted.op
    if mode == "off":
        assert predicted.impl == ("reference_decode_q" if decode
                                  else "reference_q")
        assert predicted.reason.endswith("use_kernel=False")
    else:
        assert predicted.impl == ("nm_spmm_decode_q" if decode
                                  else "nm_spmm_q")
        assert predicted.padded is not None


def test_int8_policy_off_pins_reference():
    jq, tq = _lattice_q(64, 16, (2, 4), seed=0, mode="off")
    x = torch.from_numpy(_x(4, 64, seed=0, lattice=True))
    registry.clear_history()
    nm_matmul(x, tq)
    rec = registry.last_dispatch("nm_matmul_decode_q")
    assert rec.impl == "reference_decode_q"
    assert "use_kernel=False" in rec.reason
    nm_matmul(torch.cat([x] * 4), tq)
    assert registry.last_dispatch("nm_matmul_q").impl == "reference_q"


def test_int8_on_cuda_raises_without_a_kernel():
    """On the cuda backend an int8 weight runs its kernel or raises; the
    int8 families' gate is x's dtype (f32 or bf16), never vals'."""
    _, tw = _sparse_pair(128, 64, (2, 4), seed=6)
    tq = dataclasses.replace(quantize_nm(tw), kernel_policy=KernelPolicy("auto"))
    for shape in ((16, 128), (2, 128)):
        rec = explain_dispatch(shape, tq, device="cuda")
        assert rec.backend == "cuda" and rec.impl.startswith("nm_spmm")
        assert rec.op.endswith("_q")
        with pytest.raises(registry.KernelForceError, match="QNMWeight"):
            explain_dispatch(shape, tq, dtype=torch.float16, device="cuda")
    assert explain_dispatch((16, 128), tq, dtype=torch.bfloat16,
                            device="cuda").impl == "nm_spmm_q"


def test_int8_decode_block_follows_the_int8_vector_width():
    from repro_torch.kernels import padding

    _, tw = _sparse_pair(128, 64, (2, 4), seed=8)
    tq = quantize_nm(tw)
    rec = explain_dispatch((4, 128), tq)
    assert rec.block == (8, 32 * padding.decode_vec(64, 1), 1024)
    assert explain_dispatch((32, 128), tq).block == (64, 64, 32)


def test_nm_matmul_q_name_and_type_errors():
    _, tw = _sparse_pair(128, 64, (2, 4), seed=9)
    tq = quantize_nm(tw)
    x = torch.from_numpy(_x(3, 128, seed=9))
    torch.testing.assert_close(nm_matmul_q(x, tq), nm_matmul(x, tq))
    with pytest.raises(TypeError, match="QNMWeight"):
        nm_matmul_q(x, tw)
    with pytest.raises(ValueError, match="axis"):
        nm_matmul(x, dataclasses.replace(tq, axis=1))
    with pytest.raises(ValueError, match="inconsistent"):
        nm_matmul(torch.zeros(3, 120), tq)


# ---------------------------------------------------------------------------
# interop, the reduced model and the serving engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def yi():
    """Reduced yi-9b in f32 with the kernel policy, both packages, on
    the JAX package's f32 params; and the JAX int8 tree."""
    from repro.configs import get_reduced as jax_reduced
    from repro.models import common as jcommon
    from repro.models.transformer import LM as JaxLM
    from repro_torch.configs import get_reduced

    jcommon.set_compute_dtype(jnp.float32)
    jcfg = jax_reduced("yi-9b")
    jcfg = dataclasses.replace(jcfg, sparsity=dataclasses.replace(
        jcfg.sparsity, use_kernel=True))
    jlm = JaxLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    tcfg = get_reduced("yi-9b")
    tcfg = dataclasses.replace(tcfg, sparsity=dataclasses.replace(
        tcfg.sparsity, use_kernel=True))
    yield jlm, params, jax_quantize_tree(params), tcfg
    jcommon.set_compute_dtype(jnp.bfloat16)


def _numpy_tree(tree):
    """The JAX param tree as numpy, each (Q)NMWeight as interop's dict."""
    from repro.core.nmweight import NMWeight as JaxNMWeight

    if isinstance(tree, (JaxNMWeight, JaxQNMWeight)):
        d = {"vals": np.asarray(tree.vals), "idx": np.asarray(tree.idx),
             "n": tree.nm.n, "m": tree.nm.m, "axis": tree.axis,
             "mode": tree.kernel_policy.mode}
        if isinstance(tree, JaxQNMWeight):
            d["scales"] = np.asarray(tree.scales)
        return d
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def _port_lm(tree, tcfg):
    from repro_torch.interop import lm_from_jax

    return lm_from_jax(tcfg, _numpy_tree(tree), dtype=torch.float32,
                       device="cpu")


def test_interop_of_a_quantized_tree(yi):
    """A quantized JAX leaf becomes a QNMWeight: int8 values kept int8,
    scales unstacked per layer; the port quantizing the f32 model in
    place gives the same buffers bit for bit."""
    from repro_torch.models.common import Linear

    _, params, qparams, tcfg = yi
    tq = _port_lm(qparams, tcfg)
    wq = qparams["groups"][0][0]["mixer"]["wq"]
    for i, layer in enumerate(tq.layers):
        w = layer.mixer.wq.weight
        assert isinstance(w, QNMWeight) and w.vals.dtype == torch.int8
        np.testing.assert_array_equal(w.vals.numpy(), np.asarray(wq.vals[i]))
        np.testing.assert_array_equal(w.scales.numpy(),
                                      np.asarray(wq.scales[i]))
        assert w.kernel_policy.mode == "auto"
    tf = quantize_tree(_port_lm(params, tcfg))
    lin_q = [m for m in tq.modules() if isinstance(m, Linear) and m.nm]
    lin_f = [m for m in tf.modules() if isinstance(m, Linear) and m.nm]
    assert len(lin_q) == len(lin_f) == 14
    for a, b in zip(lin_q, lin_f):
        assert b.quantized and set(b._buffers) == {"vals", "idx", "scales"}
        for name in ("vals", "idx", "scales"):
            assert torch.equal(getattr(a, name), getattr(b, name))
    assert tq.lm_head.w.dtype == torch.float32  # dense: not quantized


def test_reduced_yi_int8_logits_match_jax(yi):
    from repro.models.cache import CacheView as JaxCacheView
    from repro_torch.models.cache import CacheView

    jlm, _, qparams, tcfg = yi
    tlm = _port_lm(qparams, tcfg)
    toks = np.random.default_rng(0).integers(0, 512, (2, 8)).astype(np.int32)
    jl, jc, _ = jlm.forward(qparams, jnp.asarray(toks),
                            view=JaxCacheView.prefill(),
                            caches=jlm.init_cache(2, 16, jnp.float32))
    registry.clear_history()
    with torch.inference_mode():
        tl, tc = tlm(torch.from_numpy(toks), view=CacheView.prefill(),
                     caches=tlm.init_cache(2, 16))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    lens = np.array([8, 8], np.int32)
    jd, _, _ = jlm.forward(qparams, jnp.asarray(nxt),
                           view=JaxCacheView.decode(jnp.asarray(lens)),
                           caches=jc)
    with torch.inference_mode():
        td, _ = tlm(torch.from_numpy(nxt),
                    view=CacheView.decode(torch.from_numpy(lens)), caches=tc)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    counts = registry.dispatch_counts()
    assert set(counts) == {("nm_matmul_q", "nm_spmm_q", "cpu"),
                           ("nm_matmul_decode_q", "nm_spmm_decode_q", "cpu")}


def _requests(cls, n, vocab, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=int(
        rng.integers(3, 11))).astype(np.int32), max_new=3 + i % 3)
        for i in range(n)]


def test_greedy_streams_identical_to_jax_int8_engine(yi):
    """Both engines quantize the same f32 weights at construction."""
    from repro.serving.engine import Request as JaxRequest
    from repro.serving.engine import ServeEngine as JaxServeEngine
    from repro_torch.serving.engine import Request, ServeEngine

    jlm, params, _, tcfg = yi
    jeng = JaxServeEngine(jlm, params, slots=2, max_seq=32, prefill_len=8,
                          quantize="int8")
    teng = ServeEngine(_port_lm(params, tcfg), slots=2, max_seq=32,
                       prefill_len=8, quantize="int8")
    for r in _requests(JaxRequest, 5, 512, seed=3):
        jeng.submit(r)
    for r in _requests(Request, 5, 512, seed=3):
        teng.submit(r)
    registry.clear_history()
    want = {r.rid: r.out for r in jeng.run()}
    got = {r.rid: r.out for r in teng.run()}
    assert got == want and set(got) == set(range(5))
    counts = registry.dispatch_counts()
    assert counts[("nm_matmul_decode_q", "nm_spmm_decode_q", "cpu")] > 0
    assert not [k for k in counts if not k[0].endswith("_q")
                and k[2] == "cpu" and k[0].startswith("nm_matmul")
                and k[1].startswith("nm_spmm")], counts


def test_serve_engine_rejects_other_quantize_values(yi):
    from repro_torch.serving.engine import ServeEngine

    _, params, _, tcfg = yi
    with pytest.raises(ValueError, match="quantize"):
        ServeEngine(_port_lm(params, tcfg), slots=1, max_seq=16,
                    prefill_len=8, quantize="int4")


def test_lm_init_int8_quantizes_the_f32_values():
    """LM.init(quantize="int8") quantizes each compressed weight from its
    f32 values: the same int8 payload as quantizing the f32 model, in a
    bf16 model too (whose activations and dense weights are bf16)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.common import Linear
    from repro_torch.models.transformer import LM

    cfg = get_reduced("yi-9b")
    f32 = quantize_tree(LM.init(cfg, seed=3, dtype=torch.float32,
                                device="cpu"))
    bf = LM.init(cfg, seed=3, dtype=torch.bfloat16, device="cpu",
                 quantize="int8")
    la = [m for m in f32.modules() if isinstance(m, Linear) and m.nm]
    lb = [m for m in bf.modules() if isinstance(m, Linear) and m.nm]
    assert la and len(la) == len(lb)
    for a, b in zip(la, lb):
        assert torch.equal(a.vals, b.vals) and torch.equal(a.scales, b.scales)
    assert bf.embed.table.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="quantize"):
        LM.init(cfg, device="cpu", quantize="fp8")
