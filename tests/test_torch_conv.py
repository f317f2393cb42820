"""The CNN workload of the PyTorch port (im2col convs, SparseCNN,
ResNet-50 / DenseNet-121 configs) against the JAX package's, on the CPU.

Inputs are made once with numpy (or by the JAX package's init, handed
over as numpy through ``repro_torch.interop``) and fed to both.

Tolerances: im2col and the pools are pure slicing, padding and maxima,
so they are bit-equal; an average of four f32 values may round in
another order (1e-6). Float convs and logits agree to 1e-4 (f32 products
summed in another order, through a few layers; |y| is O(1)). On the
integer lattice (integer activations, int8 values, power-of-two scales)
every float operation is exact, so the int8 conv is bit-equal to the
JAX package's kernel and to a dense conv.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_cnn_config as jax_cnn_config
from repro.configs import get_cnn_reduced as jax_cnn_reduced
from repro.core.nmweight import NMWeight as JaxNMWeight
from repro.models import conv as jconv
from repro.quant import QNMWeight as JaxQNMWeight
from repro_torch.configs import (
    CNN_ARCHS,
    DEFAULT_CNN_SPARSITY,
    get_cnn_config,
    get_cnn_reduced,
)
from repro_torch.configs.base import ConvSpec, SparsityConfig
from repro_torch.core.nmweight import KernelPolicy, NMWeight
from repro_torch.core.sparsity import NMConfig
from repro_torch.interop import cnn_from_jax
from repro_torch.kernels import registry
from repro_torch.models import conv as tconv
from repro_torch.quant import QNMWeight, quantize_tree

TOL = dict(rtol=1e-4, atol=1e-4)
CONV_CASES = [  # kh, kw, stride, padding, c_in, c_out, h, w
    (3, 3, 1, "SAME", 8, 16, 10, 10),
    (3, 3, 2, "SAME", 8, 16, 11, 13),   # odd spatial, stride
    (1, 1, 2, "SAME", 8, 12, 7, 9),
    (7, 7, 2, "SAME", 4, 8, 23, 23),    # resnet-stem-like window
    (3, 3, 2, "VALID", 8, 16, 11, 13),
    (5, 3, 1, "VALID", 4, 8, 9, 12),    # non-square window
]


def _numpy_tree(tree, mode=None):
    """The JAX param tree as numpy, each (Q)NMWeight as interop's dict
    (its policy mode replaced by ``mode`` when given)."""
    if isinstance(tree, (JaxNMWeight, JaxQNMWeight)):
        d = {"vals": np.asarray(tree.vals), "idx": np.asarray(tree.idx),
             "n": tree.nm.n, "m": tree.nm.m, "axis": tree.axis,
             "mode": mode or tree.kernel_policy.mode}
        if isinstance(tree, JaxQNMWeight):
            d["scales"] = np.asarray(tree.scales)
        return d
    if isinstance(tree, dict):
        return {k: _numpy_tree(v, mode) for k, v in tree.items()}
    return np.asarray(tree)


def _x(shape, seed, lattice=False):
    rng = np.random.default_rng(seed)
    if lattice:
        return rng.integers(-8, 9, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kh,kw,stride,pad,cin,cout,h,w", CONV_CASES)
def test_im2col_and_conv2d_match_jax(kh, kw, stride, pad, cin, cout, h, w):
    x = _x((2, h, w, cin), seed=kh * 10 + h)
    want = np.asarray(jconv.im2col(jnp.asarray(x), kh, kw, stride=stride,
                                   padding=pad))
    got = tconv.im2col(torch.from_numpy(x), kh, kw, stride=stride,
                       padding=pad)
    np.testing.assert_array_equal(got.numpy(), want)

    spec = jconv.ConvSpec("c", cin, cout, kh, kw, stride, padding=pad)
    sp = jconv.SparsityConfig(targets=("conv",))
    jw = jconv.SparseConv2D(spec).init(jax.random.PRNGKey(0), sp=sp)
    assert isinstance(jw, JaxNMWeight)
    y_j = np.asarray(jconv.SparseConv2D(spec).apply(
        jw, jnp.asarray(x), compute_dtype=jnp.float32))
    tw = NMWeight(torch.from_numpy(np.array(jw.vals)),
                  torch.from_numpy(np.array(jw.idx)), NMConfig(2, 4), 0,
                  KernelPolicy("auto"))
    registry.clear_history()
    y_t = tconv.conv2d(torch.from_numpy(x), tw, kh=kh, kw=kw, stride=stride,
                       padding=pad)
    assert registry.last_dispatch("nm_matmul").impl == "nm_spmm"
    assert y_t.shape == y_j.shape
    np.testing.assert_allclose(y_t.numpy(), y_j, **TOL)
    layer = tconv.SparseConv2D(
        ConvSpec("c", cin, cout, kh, kw, stride, padding=pad), tw)
    np.testing.assert_array_equal(layer(torch.from_numpy(x)).numpy(),
                                  y_t.numpy())


def test_im2col_rejects_what_jax_rejects():
    x = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match="padding"):
        tconv.im2col(x, 3, 3, padding="FULL")
    with pytest.raises(ValueError, match="does not fit"):
        tconv.im2col(x, 5, 5, padding="VALID")


@pytest.mark.parametrize("h,k,s", [(112, 3, 2), (9, 3, 2), (8, 3, 1)])
def test_max_pool_matches_jax(h, k, s):
    x = _x((2, h, h + 1, 5), seed=h)
    want = np.asarray(jconv._max_pool(jnp.asarray(x), k, s))
    got = tconv._max_pool(torch.from_numpy(x), k, s)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h", [8, 7, 3])
def test_avg_pool_matches_jax(h):
    """Padded lanes count in the divisor (7 -> 4 pads one zero row)."""
    x = _x((2, h, h, 6), seed=h)
    want = np.asarray(jconv._avg_pool(jnp.asarray(x), 2, 2))
    got = tconv._avg_pool(torch.from_numpy(x), 2, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pattern", [(1, 4), (2, 4)],
                         ids=lambda p: "%d:%d" % p)
def test_int8_conv_bit_exact_on_lattice(pattern):
    """As tests/test_conv.py's lattice case: the port's int8 conv equals
    the JAX package's Pallas int8 kernel and a dense conv bit for bit."""
    rng = np.random.default_rng(0)
    spec = jconv.ConvSpec("c", 8, 16, 3, 3, 1)
    sp = jconv.SparsityConfig(targets=("conv",), nm=japi.NMConfig(*pattern))
    jw = jconv.SparseConv2D(spec).init(jax.random.PRNGKey(0), sp=sp)
    q = rng.integers(-127, 128, size=jw.vals.shape).astype(np.int8)
    q = np.where(np.asarray(jw.vals) == 0, 0, q).astype(np.int8)
    scales = (2.0 ** rng.integers(-6, 1, size=(16,))).astype(np.float32)
    jq = JaxQNMWeight(vals=jnp.asarray(q), idx=jw.idx,
                      scales=jnp.asarray(scales), nm=jw.nm,
                      kernel_policy=japi.KernelPolicy("force"))
    tq = QNMWeight(torch.from_numpy(q), torch.from_numpy(np.array(jw.idx)),
                   torch.from_numpy(scales), NMConfig(*pattern), 0,
                   KernelPolicy("force"))
    x = _x((2, 9, 9, 8), seed=1, lattice=True)
    want = np.asarray(jconv.SparseConv2D(spec).apply(
        jq, jnp.asarray(x), compute_dtype=jnp.float32))
    registry.clear_history()
    got = tconv.conv2d(torch.from_numpy(x), tq, kh=3, kw=3)
    assert registry.last_dispatch("nm_matmul_q").impl == "nm_spmm_q"
    np.testing.assert_array_equal(got.numpy(), want)
    w_hwio = np.asarray(jq.to_dense()).reshape(3, 3, 8, 16)
    dense = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w_hwio), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(dense))


@pytest.mark.parametrize("cnn,rows", [("resnet50", 53), ("densenet121", 120)])
def test_gemm_tables_equal_jax(cnn, rows):
    for full, get_t, get_j in ((True, get_cnn_config, jax_cnn_config),
                               (False, get_cnn_reduced, jax_cnn_reduced)):
        t = tconv.cnn_layer_gemms(get_t(cnn))
        j = jconv.cnn_layer_gemms(get_j(cnn))
        assert t == j
        assert tconv.cnn_final_channels(get_t(cnn)) == \
            jconv.cnn_final_channels(get_j(cnn))
        if full:
            assert len(t) == rows
    layers = tconv.cnn_layer_specs(get_cnn_config(cnn))
    for layer in layers:  # the paper's mapping M=C_out, K, N=H_out*W_out
        name, m, k, n = layer.gemm
        s = layer.spec
        assert (m, k, n) == (s.c_out, s.k_gemm, layer.h_out * layer.w_out)
    assert layers[0].gemm == ("conv1", 64, 147, 112 * 112)


def test_published_gemm_entries():
    r = {name: (m, k, n) for name, m, k, n in
         tconv.cnn_layer_gemms(get_cnn_config("resnet50"))}
    assert r["s2b1_3x3"] == (64, 576, 3136)
    assert r["s4b1_3x3"] == (256, 2304, 196)
    assert r["s5b1_1x1b"] == (2048, 512, 49)
    d = {name: (m, k, n) for name, m, k, n in
         tconv.cnn_layer_gemms(get_cnn_config("densenet121"))}
    assert d["t1_1x1"] == (128, 64 + 6 * 32, 56 * 56)
    assert d["d4l16_3x3"] == (32, 128 * 9, 7 * 7)


def test_configs_match_jax():
    assert CNN_ARCHS == ("resnet50", "densenet121")
    assert DEFAULT_CNN_SPARSITY.targets == ("conv", "proj")
    for cnn in CNN_ARCHS:
        for get_t, get_j in ((get_cnn_config, jax_cnn_config),
                             (get_cnn_reduced, jax_cnn_reduced)):
            t, j = get_t(cnn), get_j(cnn)
            assert (t.name, t.kind, t.input_hw, t.stem_pool,
                    t.num_classes) == (j.name, j.kind, j.input_hw,
                                       j.stem_pool, j.num_classes)
            assert [dataclasses.astuple(s) for s in t.stages] == \
                [dataclasses.astuple(s) for s in j.stages]
            assert dataclasses.astuple(t.stem) == dataclasses.astuple(j.stem)
        assert get_cnn_config(cnn, sparse=False).sparsity is None
    with pytest.raises(KeyError, match="unknown CNN"):
        get_cnn_config("inceptionv3")


def test_sparsity_targets():
    """The stem (K=27, not 4-divisible) stays dense; conv/proj families
    are compressed; the head is dense f32; a dense config has no
    compressed weight; per-target overrides apply to convs."""
    model = tconv.SparseCNN.init(get_cnn_reduced("resnet50"), device="cpu")
    assert model.convs["conv1"].nm is None
    assert isinstance(model.convs["s2b1_1x1a"].weight, NMWeight)
    assert isinstance(model.convs["s3b1_proj"].weight, NMWeight)
    assert model.head.nm is None and model.head.w.dtype == torch.float32
    dense = tconv.SparseCNN.init(get_cnn_reduced("resnet50", sparse=False),
                                 device="cpu")
    assert all(c.nm is None for c in dense.convs.values())
    sp = SparsityConfig(targets=("conv", "proj"),
                        nm_overrides=(("proj", NMConfig(1, 4)),))
    cfg = dataclasses.replace(get_cnn_reduced("resnet50"), sparsity=sp)
    mixed = tconv.SparseCNN.init(cfg, device="cpu")
    assert mixed.convs["s2b1_1x1a"].nm == NMConfig(2, 4)
    assert mixed.convs["s3b1_proj"].nm == NMConfig(1, 4)
    q = tconv.SparseCNN.init(get_cnn_reduced("densenet121"), device="cpu",
                             quantize="int8")
    assert isinstance(q.convs["d1l1_3x3"].weight, QNMWeight)
    assert q.convs["conv1"].nm is None
    with pytest.raises(ValueError, match="quantize"):
        tconv.SparseCNN.init(get_cnn_reduced("resnet50"), device="cpu",
                             quantize="int4")


@pytest.fixture(scope="module", params=["resnet50", "densenet121"])
def cnn_pair(request):
    """A reduced CNN's JAX params and input, and the JAX logits in f32."""
    jcfg = jax_cnn_reduced(request.param)
    model = jconv.SparseCNN(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    x = _x((2, jcfg.input_hw, jcfg.input_hw, 3), seed=2)
    return request.param, model, params, x


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_reduced_cnn_logits_match_jax(cnn_pair, quantized):
    """Reduced ResNet-50 / DenseNet-121 on weights carried over by interop:
    the port's kernel route (plain versions on the CPU) against the JAX
    forward; every compressed conv went through the kernel family."""
    cnn, model, params, x = cnn_pair
    if quantized:
        params = japi.quantize_tree(params)
    want = np.asarray(model.apply(params, jnp.asarray(x),
                                  compute_dtype=jnp.float32))
    tm = cnn_from_jax(_numpy_tree(params, mode="auto"), get_cnn_reduced(cnn),
                      device="cpu")
    registry.clear_history()
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    n_sparse = sum(c.nm is not None for c in tm.convs.values())
    assert n_sparse == len(tm.convs) - 1  # all but the stem
    impl = "nm_spmm_q" if quantized else "nm_spmm"
    op = "nm_matmul_q" if quantized else "nm_matmul"
    assert registry.dispatch_counts() == {(op, impl, "cpu"): n_sparse}


def test_quantize_tree_on_a_cnn_matches_jax_quantize_tree(cnn_pair):
    """The port quantizing its f32 CNN in place gives the buffers the JAX
    package's quantize_tree gives, bit for bit."""
    cnn, _, params, _ = cnn_pair
    jq = japi.quantize_tree(params)
    tm = quantize_tree(cnn_from_jax(_numpy_tree(params), get_cnn_reduced(cnn),
                                    device="cpu"))
    for name, conv in tm.convs.items():
        node = jq["convs"][name]
        if conv.nm is None:
            continue
        np.testing.assert_array_equal(conv.vals.numpy(),
                                      np.asarray(node.vals))
        np.testing.assert_array_equal(conv.scales.numpy(),
                                      np.asarray(node.scales))
