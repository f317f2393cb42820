"""``nm_matmul`` of the PyTorch port against the JAX package's, both
families, on the CPU.

The JAX side runs its Pallas kernels as its own tests do
(``api.sparsify(..., kernel_policy="force")``: interpret mode on the
CPU); the port's wrappers run their plain versions because the tensors
lie on the CPU. Inputs are made once with numpy and fed to both.

Tolerance: f32 sums in another order differ by a few f32 ulps of the
largest partial sum, so f32 results are compared at 1e-5 (relative and
absolute; |y| is O(1) here). On the integer lattice every partial sum is
an exact integer below 2^24, so results must be bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch.core.nmweight import KernelPolicy, NMWeight
from repro_torch.core.sparsity import NMConfig
from repro_torch.kernels import registry
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.indexmac.ops import explain_dispatch, nm_matmul

F32_TOL = 1e-5
ACTS = [None, "relu", "gelu", "silu", "relu_sq"]


def _weights(k, n, nm, seed, lattice=False, mode="force"):
    """The same N:M weight in both packages (pruned and compressed by the
    JAX package, handed over as numpy)."""
    rng = np.random.default_rng(seed)
    if lattice:
        w = (rng.integers(1, 5, (k, n)) * rng.choice([-1, 1], (k, n)))
    else:
        w = rng.standard_normal((k, n)) * k ** -0.5
    jw = japi.sparsify(jnp.asarray(w, jnp.float32), japi.NMConfig(*nm),
                       kernel_policy="force")
    tw = NMWeight(torch.from_numpy(np.array(jw.vals)),
                  torch.from_numpy(np.array(jw.idx)), NMConfig(*nm), 0,
                  KernelPolicy(mode))
    return jw, tw


def _x(m, k, seed, lattice=False):
    rng = np.random.default_rng(seed + 1000)
    if lattice:
        return rng.integers(-4, 5, (m, k)).astype(np.float32)
    return rng.standard_normal((m, k)).astype(np.float32)


def _run_both(x, jw, tw, bias=None, act=None):
    jep = tep = None
    if bias is not None or act is not None:
        jep = japi.Epilogue(bias=None if bias is None else jnp.asarray(bias),
                            activation=act)
        tep = Epilogue(bias=None if bias is None else torch.from_numpy(bias),
                       activation=act)
    want = np.asarray(japi.nm_matmul(jnp.asarray(x), jw, epilogue=jep))
    got = nm_matmul(torch.from_numpy(x), tw, epilogue=tep).numpy()
    return got, want


@pytest.mark.parametrize("nm", [(2, 4), (1, 4)], ids=lambda c: "%d:%d" % c)
@pytest.mark.parametrize("mkn", [(7, 384, 200), (70, 384, 200),
                                 (13, 96, 130), (40, 384, 384)],
                         ids=lambda s: "M%dK%dN%d" % s)
def test_f32_matches_jax(mkn, nm):
    m, k, n = mkn
    jw, tw = _weights(k, n, nm, seed=m)
    got, want = _run_both(_x(m, k, seed=m), jw, tw)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    rec = registry.last_dispatch()
    assert rec.op == ("nm_matmul_decode" if m <= 8 else "nm_matmul")
    assert rec.impl in ("nm_spmm", "nm_spmm_decode") and rec.backend == "cpu"


@pytest.mark.parametrize("bias_on", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m", [1, 4, 7])
def test_decode_epilogues_match_jax(m, act, bias_on):
    k, n = 256, 136
    jw, tw = _weights(k, n, (2, 4), seed=3)
    bias = (np.random.default_rng(m).standard_normal(n).astype(np.float32)
            if bias_on else None)
    registry.clear_history()
    got, want = _run_both(_x(m, k, seed=m), jw, tw, bias, act)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    assert registry.dispatch_counts() == {
        ("nm_matmul_decode", "nm_spmm_decode", "cpu"): 1}


@pytest.mark.parametrize("act", ["relu", "silu"])
def test_prefill_family_applies_the_epilogue_after(act):
    jw, tw = _weights(128, 72, (2, 4), seed=5)
    bias = np.random.default_rng(5).standard_normal(72).astype(np.float32)
    got, want = _run_both(_x(24, 128, seed=5), jw, tw, bias, act)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    assert registry.last_dispatch().op == "nm_matmul"


@pytest.mark.parametrize("nm", [(2, 4), (1, 4)], ids=lambda c: "%d:%d" % c)
@pytest.mark.parametrize("mkn", [(7, 384, 200), (70, 384, 200),
                                 (4, 512, 256), (33, 96, 130)],
                         ids=lambda s: "M%dK%dN%d" % s)
def test_integer_lattice_bit_exact(mkn, nm):
    m, k, n = mkn
    jw, tw = _weights(k, n, nm, seed=m, lattice=True)
    x = _x(m, k, seed=m, lattice=True)
    bias = np.arange(n, dtype=np.float32) - n // 2
    for b, act in ((None, None), (bias, "relu"), (bias, "relu_sq")):
        got, want = _run_both(x, jw, tw, b, act)
        np.testing.assert_array_equal(got, want)


def test_bf16_matches_jax_within_a_bf16_step():
    jw, tw = _weights(256, 96, (2, 4), seed=9)
    x = _x(20, 256, seed=9)
    jwb = japi.NMWeight(jw.vals.astype(jnp.bfloat16), jw.idx, jw.nm, 0,
                        jw.kernel_policy)
    want = np.asarray(japi.nm_matmul(jnp.asarray(x, jnp.bfloat16), jwb)
                      .astype(jnp.float32))
    got = nm_matmul(torch.from_numpy(x).bfloat16(), tw.to(dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-2)


# ---------------------------------------------------------------------------
# routing, explain_dispatch, errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["off", "auto", "force"])
@pytest.mark.parametrize("xshape", [(1, 256), (2, 3, 256), (8, 256),
                                    (9, 256), (4, 32, 256)])
def test_explain_dispatch_agrees_with_the_call(xshape, mode):
    jw, tw = _weights(256, 40, (2, 4), seed=1, mode=mode)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        xshape).astype(np.float32))
    predicted = explain_dispatch(xshape, tw)
    registry.clear_history()
    y = nm_matmul(x, tw)
    assert y.shape == (*xshape[:-1], 40)
    assert registry.last_dispatch() == predicted
    # the family split by M is the JAX package's
    jpol = japi.KernelPolicy(mode)
    jwm = japi.NMWeight(jw.vals, jw.idx, jw.nm, 0, jpol)
    assert japi.explain_dispatch(xshape, jwm).op == predicted.op
    if mode == "off":
        assert predicted.impl.startswith("reference")
        assert predicted.reason.endswith("use_kernel=False")
    if mode == "force":
        assert predicted.impl.startswith("nm_spmm")
        assert predicted.padded is not None and predicted.block is not None


@pytest.mark.parametrize("xshape", [(9, 256), (15, 256), (3, 256)])
def test_auto_takes_the_kernel_at_any_waste(xshape):
    """No waste limit: a short prefill (M = 9 in a 64-row tile) and a
    narrow decode both take the kernel under ``auto``, on either
    backend (``explain_dispatch`` resolves the cuda backend without a
    card)."""
    _, tw = _weights(256, 40, (2, 4), seed=2, mode="auto")
    for device in ("cpu", "cuda"):
        rec = explain_dispatch(xshape, tw, device=device)
        assert rec.impl.startswith("nm_spmm") and rec.reason == ""
        assert rec.backend == device


@pytest.mark.parametrize("mode", ["auto", "force"])
def test_no_kernel_on_cuda_raises_under_auto_and_force(mode):
    """On the cuda backend ``auto`` is ``force``: a dtype or pattern with
    no kernel raises instead of running the reference there."""
    _, tw = _weights(128, 64, (2, 4), seed=6)
    half = NMWeight(tw.vals.half(), tw.idx, tw.nm, 0, KernelPolicy(mode))
    wide = NMWeight(torch.zeros(2, 8), torch.zeros(2, 8, dtype=torch.int8),
                    NMConfig(1, 64), 0, KernelPolicy(mode))
    with pytest.raises(registry.KernelForceError, match=repr(mode)):
        explain_dispatch((16, 128), half, device="cuda")
    with pytest.raises(registry.KernelForceError, match="1:64"):
        explain_dispatch((16, 128), wide, device="cuda")
    off = NMWeight(tw.vals, tw.idx, tw.nm, 0, KernelPolicy("off"))
    assert explain_dispatch((16, 128), off, device="cuda").impl == "reference"


def test_decode_m_max_moves_the_family_split(monkeypatch):
    _, tw = _weights(128, 64, (2, 4), seed=4)
    assert explain_dispatch((4, 128), tw).op == "nm_matmul_decode"
    monkeypatch.setenv("REPRO_DECODE_M_MAX", "2")
    assert explain_dispatch((4, 128), tw).op == "nm_matmul"
    assert explain_dispatch((2, 128), tw).op == "nm_matmul_decode"


def test_force_raises_kernel_force_error():
    _, tw = _weights(128, 64, (2, 4), seed=6)
    x = torch.zeros(16, 128, dtype=torch.float16)
    with pytest.raises(registry.KernelForceError, match="force"):
        nm_matmul(x, NMWeight(tw.vals.half(), tw.idx, tw.nm, 0,
                              KernelPolicy("force")))
    wide = NMWeight(torch.zeros(2, 8), torch.zeros(2, 8, dtype=torch.int8),
                    NMConfig(1, 64), 0, KernelPolicy("force"))
    with pytest.raises(registry.KernelForceError, match="1:64"):
        nm_matmul(torch.zeros(16, 128), wide)
    # auto declines the same call, with the reason on the record
    wide_auto = NMWeight(wide.vals, wide.idx, wide.nm, 0, KernelPolicy("auto"))
    nm_matmul(torch.zeros(16, 128), wide_auto)
    assert registry.last_dispatch().impl == "reference"


def test_backend_resolution(monkeypatch):
    _, tw = _weights(128, 64, (2, 4), seed=7)
    x = torch.zeros(16, 128)
    with pytest.raises(registry.KernelForceError, match="cuda"):
        nm_matmul(x, tw, backend="cuda")
    pinned = NMWeight(tw.vals, tw.idx, tw.nm, 0,
                      KernelPolicy("force", backend="cuda"))
    with pytest.raises(registry.KernelForceError, match="call/policy"):
        nm_matmul(x, pinned)
    assert nm_matmul(x, pinned, backend="cpu").shape == (16, 64)
    monkeypatch.setenv("REPRO_TORCH_BACKEND", "cuda")
    with pytest.raises(registry.KernelForceError, match="REPRO_TORCH_BACKEND"):
        nm_matmul(x, tw)
    monkeypatch.setenv("REPRO_TORCH_BACKEND", "tpu")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        nm_matmul(x, tw)
    # the JAX package's variable never steers the port
    monkeypatch.delenv("REPRO_TORCH_BACKEND")
    monkeypatch.setenv("REPRO_BACKEND", "gpu")
    nm_matmul(x, tw)
    assert registry.last_dispatch().backend == "cpu"


def test_policy_validation():
    with pytest.raises(ValueError, match="mode"):
        KernelPolicy("sometimes")
    with pytest.raises(ValueError, match="backend"):
        KernelPolicy("auto", backend="tpu")
    _, tw = _weights(128, 64, (2, 4), seed=8)
    assert explain_dispatch((32, 128), tw).block == (64, 64, 32)
    assert explain_dispatch((4, 128), tw).block == (8, 128, 1024)  # f32 x4


def test_dispatch_counts_and_clear_history():
    _, tw = _weights(128, 64, (2, 4), seed=10)
    registry.clear_history()
    for m in (1, 2, 16, 16):
        nm_matmul(torch.zeros(m, 128), tw)
    assert registry.dispatch_counts() == {
        ("nm_matmul_decode", "nm_spmm_decode", "cpu"): 2,
        ("nm_matmul", "nm_spmm", "cpu"): 2}
    assert registry.dispatch_counts("nm_matmul_decode") == {
        ("nm_matmul_decode", "nm_spmm_decode", "cpu"): 2}
    assert registry.dispatch_counts(backend="cuda") == {}
    assert len(registry.dispatch_history("nm_matmul")) == 2
    registry.clear_history()
    assert registry.dispatch_counts() == {} and registry.last_dispatch() is None


def test_typed_errors():
    _, tw = _weights(128, 64, (2, 4), seed=11)
    with pytest.raises(TypeError, match="NMWeight"):
        nm_matmul(torch.zeros(4, 128), {"w": torch.zeros(128, 64)})
    with pytest.raises(ValueError, match="inconsistent"):
        nm_matmul(torch.zeros(4, 120), tw)
    with pytest.raises(ValueError, match="axis"):
        nm_matmul(torch.zeros(4, 128),
                  NMWeight(tw.vals, tw.idx, tw.nm, 1, tw.kernel_policy))
    with pytest.raises(ValueError, match="activation"):
        Epilogue(activation="tanh")
