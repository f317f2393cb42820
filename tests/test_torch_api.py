"""The port's typed facade (``repro_torch.api``) against the JAX package's
``repro.api``: the typed parts of tests/test_api.py (sparsify, densify,
is_sparse, nm_matmul, the kernel policy, explain_dispatch) on the same
numpy inputs.

Tolerance: sparsify and densify move values and do no arithmetic, so
they are bit-equal; products are f32 sums in another order, held to
1e-5 (|y| is O(1)) against the JAX package and to the JAX tests' own
1e-4 / 1e-3 against the dense product.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api
from repro_torch.core.sparsity import check_nm_pattern
from repro_torch.kernels import registry
from repro_torch.kernels.padding import decode_rows

F32_TOL = 1e-5


def _nm_matrix(k, n, seed, nm=(2, 4)):
    """A random N:M-sparse (k, n) f32 matrix (pattern along axis 0)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    keep = np.argsort(-np.abs(w.reshape(k // nm[1], nm[1], n)), axis=1,
                      kind="stable")[:, :nm[0]]
    mask = np.zeros_like(w.reshape(k // nm[1], nm[1], n), dtype=bool)
    np.put_along_axis(mask, keep, True, axis=1)
    return np.where(mask.reshape(k, n), w, 0).astype(np.float32)


def _policy_weight(mode, k=256, n=128):
    w = _nm_matrix(k, n, seed=4)
    return w, api.sparsify(torch.from_numpy(w), api.NMConfig(2, 4),
                           kernel_policy=mode)


# ---------------------------------------------------------------------------
# sparsify / densify / nm_matmul / is_sparse
# ---------------------------------------------------------------------------


def test_sparsify_densify_roundtrip():
    nm = api.NMConfig(2, 4)
    w = _nm_matrix(32, 16, seed=0)
    sw = api.sparsify(torch.from_numpy(w), nm)
    assert isinstance(sw, api.NMWeight)
    assert sw.vals.shape == (16, 16) and sw.idx.dtype == torch.int8
    assert sw.nm == nm and sw.axis == 0
    assert sw.kernel_policy == api.KernelPolicy("auto")
    np.testing.assert_array_equal(api.densify(sw).numpy(), w)  # lossless
    jw = japi.sparsify(jnp.asarray(w), japi.NMConfig(2, 4))
    np.testing.assert_array_equal(sw.vals.numpy(), np.asarray(jw.vals))
    np.testing.assert_array_equal(sw.idx.numpy(), np.asarray(jw.idx))


@pytest.mark.parametrize("axis", [0, 1])
def test_sparsify_prunes_dense_input_like_jax(axis):
    nm = api.NMConfig(2, 4)
    w = np.random.default_rng(1).standard_normal((64, 8)).astype(np.float32)
    w = w if axis == 0 else np.ascontiguousarray(w.T)
    sw = api.sparsify(torch.from_numpy(w), nm, axis=axis)
    assert check_nm_pattern(api.densify(sw), nm, axis=axis)
    jw = japi.sparsify(jnp.asarray(w), japi.NMConfig(2, 4), axis=axis)
    np.testing.assert_array_equal(api.densify(sw).numpy(),
                                  np.asarray(japi.densify(jw)))


def test_sparsify_validates():
    with pytest.raises(ValueError, match="divisible"):
        api.sparsify(torch.ones(10, 4), api.NMConfig(2, 4))
    with pytest.raises(ValueError, match="2D"):
        api.sparsify(torch.ones(8), api.NMConfig(2, 4))
    with pytest.raises(TypeError, match="kernel_policy"):
        api.sparsify(torch.ones(8, 4), api.NMConfig(2, 4), kernel_policy=42)
    with pytest.raises(ValueError, match="mode"):
        api.KernelPolicy(mode="sometimes")


def test_is_sparse():
    nm = api.NMConfig(2, 4)
    sw = api.sparsify(torch.ones(8, 4), nm)
    assert api.is_sparse(sw)
    assert api.is_sparse(api.quantize(sw))
    assert not api.is_sparse({"w": torch.ones(8, 4)})
    assert not api.is_sparse(torch.ones(8, 4))


def test_densify_on_dense_nodes_and_int8():
    w = torch.ones(8, 4)
    assert torch.equal(api.densify({"w": w}), w)
    assert api.densify(w) is w
    sw = api.sparsify(torch.from_numpy(_nm_matrix(16, 8, seed=2)),
                      api.NMConfig(2, 4))
    qw = api.quantize(sw)
    jq = japi.quantize(japi.sparsify(jnp.asarray(api.densify(sw).numpy()),
                                     japi.NMConfig(2, 4)))
    np.testing.assert_array_equal(api.densify(qw).numpy(),
                                  np.asarray(japi.densify(jq)))


def test_nm_matmul_matches_dense_and_jax():
    nm = api.NMConfig(2, 4)
    w = _nm_matrix(256, 128, seed=2)
    x = np.random.default_rng(3).standard_normal((64, 256)).astype(np.float32)
    sw = api.sparsify(torch.from_numpy(w), nm)
    y = api.nm_matmul(torch.from_numpy(x), sw).numpy()
    np.testing.assert_allclose(y, x @ w, rtol=1e-4, atol=1e-3)
    jy = japi.nm_matmul(jnp.asarray(x), japi.sparsify(jnp.asarray(w),
                                                      japi.NMConfig(2, 4)))
    np.testing.assert_allclose(y, np.asarray(jy), rtol=F32_TOL, atol=F32_TOL)
    with pytest.raises(TypeError, match="NMWeight"):
        api.nm_matmul(torch.from_numpy(x), {"vals": sw.vals, "idx": sw.idx})


def test_nm_matmul_rejects_wrong_axis():
    nm = api.NMConfig(2, 4)
    sw = api.sparsify(torch.randn(16, 8), nm, axis=1)
    with pytest.raises(ValueError, match="axis"):
        api.nm_matmul(torch.ones(4, 16), sw)
    with pytest.raises(ValueError, match="axis"):
        api.explain_dispatch((4, 16), sw)


# ---------------------------------------------------------------------------
# kernel policy drives dispatch
# ---------------------------------------------------------------------------


def test_policy_off_pins_reference():
    _, sw = _policy_weight("off")
    registry.clear_history()
    api.nm_matmul(torch.ones(64, 256), sw)
    rec = registry.last_dispatch("nm_matmul")
    assert rec.impl == "reference" and "use_kernel=False" in rec.reason


def test_policy_auto_takes_kernel_when_shape_allows():
    w, sw = _policy_weight("auto")
    x = np.random.default_rng(5).standard_normal((64, 256)).astype(np.float32)
    registry.clear_history()
    y = api.nm_matmul(torch.from_numpy(x), sw)
    assert registry.last_dispatch("nm_matmul").impl == "nm_spmm"
    np.testing.assert_allclose(y.numpy(), x @ w, rtol=1e-4, atol=1e-3)


def test_policy_auto_and_force_take_the_kernel_at_any_waste():
    """The JAX package's waste limit (N=16 padded to a 128 lane) has no
    counterpart: the kernels mask their edges, so auto and force both
    take the kernel."""
    w = _nm_matrix(256, 16, seed=4)
    x = np.random.default_rng(6).standard_normal((64, 256)).astype(np.float32)
    for mode in ("auto", "force"):
        sw = api.sparsify(torch.from_numpy(w), api.NMConfig(2, 4),
                          kernel_policy=mode)
        registry.clear_history()
        y = api.nm_matmul(torch.from_numpy(x), sw)
        assert registry.last_dispatch("nm_matmul").impl == "nm_spmm"
        np.testing.assert_allclose(y.numpy(), x @ w, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("m", [1, 3, 8])
def test_skinny_m_routes_to_decode_family(m):
    w, sw = _policy_weight("auto")
    x = np.random.default_rng(6).standard_normal((m, 256)).astype(np.float32)
    registry.clear_history()
    y = api.nm_matmul(torch.from_numpy(x), sw)
    rec = registry.last_dispatch("nm_matmul_decode")
    assert rec.impl == "nm_spmm_decode" and rec.padded[0] == decode_rows(m)
    np.testing.assert_allclose(y.numpy(), x @ w, rtol=1e-4, atol=1e-3)


def test_force_on_a_shape_without_kernel_geometry_raises():
    _, sw = _policy_weight("force")
    empty = dataclasses.replace(sw, vals=sw.vals[:, :0], idx=sw.idx[:, :0])
    with pytest.raises(api.KernelForceError, match=r"2:4"):
        api.nm_matmul(torch.ones(1, 256), empty)
    with pytest.raises(api.KernelForceError):
        api.explain_dispatch((1, 256), empty)
    qempty = dataclasses.replace(api.quantize(sw), vals=sw.idx[:, :0],
                                 idx=sw.idx[:, :0], scales=torch.ones(0))
    with pytest.raises(api.KernelForceError, match="QNMWeight"):
        api.explain_dispatch((1, 256), qempty)


def test_epilogue_spec_validates():
    with pytest.raises(ValueError, match="activation"):
        api.Epilogue(activation="totally_fused")
    _, sw = _policy_weight("auto")
    with pytest.raises(TypeError, match="Epilogue"):
        api.nm_matmul(torch.ones(1, 256), sw, epilogue="relu")


# ---------------------------------------------------------------------------
# explain_dispatch: the dry-run routing surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_explain_dispatch_matches_execution(quantized):
    _, sw = _policy_weight("auto")
    w = api.quantize(sw) if quantized else sw
    for shape in ((1, 256), (4, 256), (64, 256), (2, 5, 256)):
        rec = api.explain_dispatch(shape, w)
        assert isinstance(rec, api.DispatchRecord)
        registry.clear_history()
        api.nm_matmul(torch.ones(shape), w)
        real = registry.last_dispatch(rec.op)
        assert (rec.impl, rec.shape, rec.padded, rec.block) == (
            real.impl, real.shape, real.padded, real.block)


def test_explain_dispatch_decode_vs_prefill_families_like_jax():
    w, sw = _policy_weight("auto")
    jw = japi.sparsify(jnp.asarray(w), japi.NMConfig(2, 4))
    for shape in ((8, 256), (9, 256), (2, 4, 256)):
        assert (api.explain_dispatch(shape, sw).op
                == japi.explain_dispatch(shape, jw).op)
    assert api.explain_dispatch((8, 256), sw).op == "nm_matmul_decode"
    assert api.explain_dispatch((9, 256), sw).op == "nm_matmul"


def test_explain_dispatch_quantized_like_jax():
    w, sw = _policy_weight("auto")
    qw = api.quantize(sw)
    jq = japi.quantize(japi.sparsify(jnp.asarray(w), japi.NMConfig(2, 4)))
    for shape in ((1, 256), (16, 256)):
        assert (api.explain_dispatch(shape, qw).op
                == japi.explain_dispatch(shape, jq).op)
    assert api.explain_dispatch((1, 256), qw).op == "nm_matmul_decode_q"
    assert api.explain_dispatch((16, 256), qw).impl == "nm_spmm_q"


def test_backend_is_resolved_and_recorded():
    _, sw = _policy_weight("auto")
    assert api.resolve_backend(None, torch.device("cpu")) == "cpu"
    assert api.explain_dispatch((4, 256), sw).backend == "cpu"
    assert api.explain_dispatch((4, 256), sw, device="cuda").backend == "cuda"
    with pytest.raises(api.KernelForceError):
        api.nm_matmul(torch.ones(4, 256), sw, backend="cuda")


def test_quantize_and_dequantize_round_trip():
    _, sw = _policy_weight("force")
    qw = api.quantize(sw)
    assert isinstance(qw, api.QNMWeight)
    assert qw.kernel_policy.mode == "force"
    back = api.dequantize(qw)
    assert isinstance(back, api.NMWeight) and back.vals.dtype == torch.float32
    assert api.dequantize(qw, torch.bfloat16).vals.dtype == torch.bfloat16
    bound = qw.scales[None, :] * 0.5 * (1 + 1e-5) + 1e-7
    assert bool(((back.vals - sw.vals).abs() <= bound).all())
    tree = api.quantize_tree({"a": sw, "b": [sw]})
    assert isinstance(tree["b"][0], api.QNMWeight)
    assert isinstance(api.dequantize_tree(tree)["a"], api.NMWeight)


def test_public_surface():
    assert set(api.__all__) == {
        "DispatchRecord", "Epilogue", "KernelForceError", "KernelPolicy",
        "NMConfig", "NMWeight", "QNMWeight", "densify", "dequantize",
        "dequantize_tree", "explain_dispatch", "is_sparse", "nm_matmul",
        "quantize", "quantize_tree", "resolve_backend", "sparsify"}
    assert all(hasattr(api, name) for name in api.__all__)
