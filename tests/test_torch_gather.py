"""The gather port (the paper's Algorithm 3, ``indexmac_gather``) of the
PyTorch port against the JAX package's, on the CPU.

The JAX side runs its Pallas gather kernel as its own tests do
(interpret mode on the CPU, at shapes its TPU tile divides) or its
reference; the port's wrappers run their plain versions because the
tensors lie on the CPU. Inputs are made once with numpy and fed to both.

Tolerance: f32 sums in another order differ by a few f32 ulps of the
largest partial sum, so f32 results agree at rtol 1e-5 / atol 1e-4 (the
JAX gather tests' own tolerance); bf16 results round those sums, so they
agree to one bf16 step (1e-2). On the integer lattice every partial sum
is an exact integer below 2^24 and the row scale multiplies once, so the
int8 family must be bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels import registry as jregistry
from repro.kernels.indexmac_gather.ops import (
    indexmac_gather_positional as jax_gather_positional,
)
from repro.kernels.indexmac_gather.ref import (
    indexmac_gather_q_ref as jax_gather_q_ref,
)
from repro.kernels.indexmac_gather.ref import (
    indexmac_gather_ref as jax_gather_ref,
)
from repro.quant import QNMWeight as JaxQNMWeight
from repro.quant.calibrate import quantize_nm as jax_quantize_nm
from repro_torch import api
from repro_torch.core.nmweight import KernelPolicy, NMWeight
from repro_torch.core.sparsity import NMConfig
from repro_torch.interop import weight_from_jax
from repro_torch.kernels import registry
from repro_torch.kernels.indexmac_gather import kernel
from repro_torch.kernels.indexmac_gather.ops import (
    explain_gather,
    indexmac_gather,
    indexmac_gather_positional,
)
from repro_torch.kernels.indexmac_gather.ref import (
    indexmac_gather_q_ref,
    indexmac_gather_ref,
)
from repro_torch.quant import QNMWeight, quantize_nm

F32 = dict(rtol=1e-5, atol=1e-4)
PATTERNS = [(1, 4), (2, 4)]


def _a(mr, k, nm, seed, lattice=False):
    """A row-compressed A in both packages (pruned and compressed along
    axis 1 by the JAX package, handed over as numpy)."""
    rng = np.random.default_rng(seed)
    if lattice:
        a = rng.integers(1, 5, (mr, k)) * rng.choice([-1, 1], (mr, k))
    else:
        a = rng.standard_normal((mr, k))
    jw = japi.sparsify(jnp.asarray(a, jnp.float32), japi.NMConfig(*nm),
                       axis=1, kernel_policy="force")
    tw = NMWeight(torch.from_numpy(np.array(jw.vals)),
                  torch.from_numpy(np.array(jw.idx)), NMConfig(*nm), 1,
                  KernelPolicy("auto"))
    return jw, tw


def _b(k, nc, seed, lattice=False):
    rng = np.random.default_rng(seed + 1000)
    if lattice:
        return rng.integers(-8, 9, (k, nc)).astype(np.float32)
    return rng.standard_normal((k, nc)).astype(np.float32)


def _lattice_q(mr, k, nm, seed):
    """int8 A on the lattice: random int8 values (zero in the padded
    slots), random f32 row scales, in both packages."""
    rng = np.random.default_rng(seed)
    jw, _ = _a(mr, k, nm, seed)
    q = rng.integers(-127, 128, jw.vals.shape).astype(np.int8)
    q = np.where(np.asarray(jw.vals) == 0, 0, q).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, mr).astype(np.float32)
    jq = JaxQNMWeight(vals=jnp.asarray(q), idx=jw.idx,
                      scales=jnp.asarray(scales), nm=jw.nm, axis=1,
                      kernel_policy=japi.KernelPolicy("force"))
    tq = QNMWeight(torch.from_numpy(q), torch.from_numpy(np.array(jw.idx)),
                   torch.from_numpy(scales), NMConfig(*nm), 1,
                   KernelPolicy("auto"))
    return jq, tq


@pytest.mark.parametrize("nm", PATTERNS, ids=lambda p: "%d:%d" % p)
@pytest.mark.parametrize("shape", [(16, 128, 128), (8, 256, 128)],
                         ids=lambda s: "Mr%dK%dN%d" % s)
def test_gather_matches_the_jax_pallas_kernel(shape, nm):
    mr, k, nc = shape
    jw, tw = _a(mr, k, nm, seed=0)
    b = _b(k, nc, seed=0)
    jregistry.clear_history()
    want = np.asarray(jax_gather_positional(jw.vals, jw.idx, jnp.asarray(b),
                                            jw.nm, block=(8, 128, 64)))
    assert jregistry.last_dispatch("indexmac_gather").impl == "pallas_gather"
    registry.clear_history()
    got = indexmac_gather(tw, torch.from_numpy(b))
    assert registry.last_dispatch("indexmac_gather").impl == "indexmac_gather"
    np.testing.assert_allclose(got.numpy(), want, **F32)
    got_pos = indexmac_gather_positional(tw.vals, tw.idx,
                                         torch.from_numpy(b), tw.nm)
    np.testing.assert_array_equal(got_pos.numpy(), got.numpy())


@pytest.mark.parametrize("nm", PATTERNS, ids=lambda p: "%d:%d" % p)
@pytest.mark.parametrize("shape", [(24, 148, 49), (64, 576, 196),
                                   (5, 12, 3)],
                         ids=lambda s: "Mr%dK%dN%d" % s)
def test_gather_matches_the_jax_reference_at_ragged_shapes(shape, nm):
    """Shapes the JAX TPU tile does not divide: it runs its reference;
    the port runs its kernel route (the plain version here)."""
    mr, k, nc = shape
    jw, tw = _a(mr, k, nm, seed=1)
    b = _b(k, nc, seed=1)
    want = np.asarray(jax_gather_ref(jw.vals, jw.idx, jnp.asarray(b), jw.nm))
    bt = torch.from_numpy(b)
    np.testing.assert_allclose(indexmac_gather(tw, bt).numpy(), want, **F32)
    np.testing.assert_allclose(
        indexmac_gather_ref(tw.vals, tw.idx, bt, tw.nm).numpy(), want, **F32)
    np.testing.assert_allclose(
        kernel.indexmac_gather_plain(tw.vals, tw.idx, bt, tw.nm).numpy(),
        want, **F32)


def test_gather_bf16_matches_the_jax_reference():
    """bf16 values and bf16 B: decompressed in bf16, f32 product, output
    in B's dtype, in both packages."""
    jw, tw = _a(24, 148, (2, 4), seed=2)
    b = _b(148, 49, seed=2)
    want = jax_gather_ref(jw.vals.astype(jnp.bfloat16), jw.idx,
                          jnp.asarray(b, jnp.bfloat16), jw.nm)
    got = indexmac_gather(tw.to(dtype=torch.bfloat16),
                          torch.from_numpy(b).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("nm", PATTERNS, ids=lambda p: "%d:%d" % p)
@pytest.mark.parametrize("shape", [(16, 128, 128), (24, 148, 49)],
                         ids=lambda s: "Mr%dK%dN%d" % s)
def test_int8_gather_bit_exact_on_the_lattice(shape, nm):
    """The port's int8 family against the JAX Pallas int8 kernel (at the
    tileable shape) and the JAX int8 reference, bit for bit."""
    mr, k, nc = shape
    jq, tq = _lattice_q(mr, k, nm, seed=3)
    b = _b(k, nc, seed=3, lattice=True)
    registry.clear_history()
    got = indexmac_gather(tq, torch.from_numpy(b))
    assert registry.last_dispatch("indexmac_gather_q").impl == \
        "indexmac_gather_q"
    want = np.asarray(jax_gather_q_ref(jq.vals, jq.idx, jq.scales,
                                       jnp.asarray(b), jq.nm))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        indexmac_gather_q_ref(tq.vals, tq.idx, tq.scales,
                              torch.from_numpy(b), tq.nm).numpy(), want)
    if mr % 8 == 0 and nc % 128 == 0 and k % 64 == 0:
        jregistry.clear_history()
        jk = np.asarray(japi.indexmac_gather(jq, jnp.asarray(b)))
        assert jregistry.last_dispatch("indexmac_gather_q").impl == \
            "pallas_gather_q"
        np.testing.assert_array_equal(got.numpy(), jk)


def test_int8_gather_bf16_b_on_the_lattice():
    """int8 A with bf16 B (small integers are exact in bf16): the output
    is bf16 and equal to the JAX reference's bit for bit."""
    jq, tq = _lattice_q(24, 148, (2, 4), seed=4)
    b = _b(148, 49, seed=4, lattice=True)
    want = jax_gather_q_ref(jq.vals, jq.idx, jq.scales,
                            jnp.asarray(b, jnp.bfloat16), jq.nm)
    got = indexmac_gather(tq, torch.from_numpy(b).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_typed_entry_routes_by_policy_and_orientation():
    """tests/test_kernels_indexmac_gather.py's routing cases: the weight's
    own policy picks the kernel or the reference; axis 0 is refused."""
    jw, tw = _a(16, 128, (2, 4), seed=5)
    b = torch.from_numpy(_b(128, 128, seed=5))
    dense = api.densify(tw)
    registry.clear_history()
    y = api.indexmac_gather(tw, b)
    rec = registry.last_dispatch("indexmac_gather")
    assert (rec.impl, rec.backend, rec.reason) == ("indexmac_gather", "cpu",
                                                   "")
    np.testing.assert_allclose(y.numpy(), (dense @ b).numpy(), **F32)

    registry.clear_history()
    off = NMWeight(tw.vals, tw.idx, tw.nm, 1, KernelPolicy("off"))
    api.indexmac_gather(off, b)
    assert registry.last_dispatch("indexmac_gather").impl == "reference"
    assert registry.dispatch_counts() == {
        ("indexmac_gather", "reference", "cpu"): 1}

    with pytest.raises(ValueError, match="axis"):
        api.indexmac_gather(api.sparsify(dense.T.contiguous(), tw.nm), b)
    with pytest.raises(TypeError, match="NMWeight"):
        api.indexmac_gather(dense, b)
    with pytest.raises(ValueError, match="inconsistent"):
        api.indexmac_gather(tw, b[:64])


def test_quantized_weight_routes_to_the_int8_family():
    _, tq = _lattice_q(16, 128, (2, 4), seed=6)
    b = torch.from_numpy(_b(128, 64, seed=6))
    registry.clear_history()
    api.indexmac_gather(tq, b)
    off = QNMWeight(tq.vals, tq.idx, tq.scales, tq.nm, 1,
                    KernelPolicy("off"))
    api.indexmac_gather(off, b)
    assert registry.dispatch_counts() == {
        ("indexmac_gather_q", "indexmac_gather_q", "cpu"): 1,
        ("indexmac_gather_q", "reference_q", "cpu"): 1}


def test_auto_and_force_without_a_kernel_build():
    """fp16 B has no kernel build: ``auto`` gives the call to the
    reference on the CPU backend (the record says why); ``force`` raises."""
    _, tw = _a(16, 128, (2, 4), seed=7)
    b = torch.from_numpy(_b(128, 64, seed=7)).half()
    registry.clear_history()
    y = indexmac_gather(tw.to(dtype=torch.float16), b)
    rec = registry.last_dispatch("indexmac_gather")
    assert rec.impl == "reference" and "float16" in rec.reason
    assert y.dtype == torch.float16
    forced = NMWeight(tw.vals, tw.idx, tw.nm, 1, KernelPolicy("force"))
    with pytest.raises(registry.KernelForceError, match="no gather kernel"):
        indexmac_gather(forced, b)
    with pytest.raises(registry.KernelForceError, match="cannot serve"):
        indexmac_gather(tw, b.float(), backend="cuda")


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_explain_dispatch_with_an_axis1_weight(quantized):
    """``explain_dispatch`` hands an axis-1 weight to ``explain_gather``;
    its record is the one the call writes."""
    if quantized:
        _, w = _lattice_q(24, 148, (2, 4), seed=8)
    else:
        _, w = _a(24, 148, (2, 4), seed=8)
    b = torch.from_numpy(_b(148, 49, seed=8))
    rec = api.explain_dispatch(tuple(b.shape), w, dtype=torch.float32)
    assert rec == explain_gather(tuple(b.shape), w, dtype=torch.float32)
    op = "indexmac_gather_q" if quantized else "indexmac_gather"
    assert (rec.op, rec.impl, rec.shape) == (op, op, (24, 148, 49))
    assert rec.block == (32, 64, 32) and rec.padded == (32, 160, 64)
    registry.clear_history()
    indexmac_gather(w, b)
    assert registry.last_dispatch(op) == rec
    # nm_matmul keeps refusing the gather orientation
    with pytest.raises(ValueError, match="axis"):
        api.nm_matmul(torch.zeros(2, 24), w)


def test_quantize_nm_axis1_row_scales_bit_equal_to_jax():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((24, 148)).astype(np.float32)
    jq = jax_quantize_nm(jnp.asarray(a), japi.NMConfig(2, 4), axis=1)
    tq = quantize_nm(torch.from_numpy(a), NMConfig(2, 4), axis=1)
    assert tuple(tq.scales.shape) == (24,) and tq.axis == 1
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(tq.vals.numpy(), np.asarray(jq.vals))
    np.testing.assert_array_equal(tq.idx.numpy(), np.asarray(jq.idx))
    b = _b(148, 49, seed=9)
    np.testing.assert_allclose(
        api.indexmac_gather(tq, torch.from_numpy(b)).numpy(),
        np.asarray(japi.indexmac_gather(jq, jnp.asarray(b))), **F32)


def test_interop_keeps_the_gather_orientation():
    jw, _ = _a(24, 148, (2, 4), seed=10)
    jq = jax_quantize_nm(jw)
    for node, cls in ((jw, NMWeight), (jq, QNMWeight)):
        leaf = {"vals": np.asarray(node.vals), "idx": np.asarray(node.idx),
                "n": 2, "m": 4, "axis": node.axis,
                "mode": node.kernel_policy.mode}
        if cls is QNMWeight:
            leaf["scales"] = np.asarray(node.scales)
        w = weight_from_jax(leaf, dtype=torch.float32, device="cpu")
        assert isinstance(w, cls) and w.axis == 1
        if cls is QNMWeight:
            assert tuple(w.scales.shape) == (24,)
        np.testing.assert_array_equal(api.densify(w).numpy(),
                                      np.asarray(japi.densify(node)))


def test_no_resnet50_or_densenet121_layer_tiles_the_tpu_gather_kernel():
    """The JAX package's gather port runs its TPU kernel only where its
    (8, 128, 64) block divides (Mr, Nc, K) and the reference elsewhere:
    none of the 53 + 120 layer GEMMs of the paper's CNNs (Nc = H*W is 12544,
    3136, 784, 196 or 49) qualifies. The port's route takes the kernel on
    every one of them."""
    from repro.kernels.indexmac_gather.ops import DEFAULT_BLOCK, _tileable
    from repro_torch.configs import get_cnn_config
    from repro_torch.models.conv import cnn_layer_gemms

    layers = [g for cnn in ("resnet50", "densenet121")
              for g in cnn_layer_gemms(get_cnn_config(cnn))]
    assert len(layers) == 173
    for nm in PATTERNS:
        jcfg, cfg = japi.NMConfig(*nm), NMConfig(*nm)
        tileable = [name for name, mr, k, nc in layers
                    if _tileable(mr, -(-k // 4) * 4, nc, jcfg, DEFAULT_BLOCK)]
        assert tileable == []
        for name, mr, k, nc in layers:
            k_run = -(-k // 4) * 4
            w = NMWeight(torch.zeros(mr, k_run * nm[0] // 4),
                         torch.zeros(mr, k_run * nm[0] // 4,
                                     dtype=torch.int8), cfg, 1,
                         KernelPolicy("auto"))
            assert explain_gather((k_run, nc), w).impl == "indexmac_gather"
