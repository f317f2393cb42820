"""The PyTorch/CUDA port on the card: each hand-written kernel (float
and int8) against its plain PyTorch version, and tiny serves through
the float and the int8 kernels.

Marked ``gpu``; every test skips without a CUDA device (decided in the
``cuda`` fixture, never at import). Run on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: the kernels and the plain versions both accumulate in f32
but in another order, so f32 results agree to 1e-4 relative; bf16
results are rounded from those f32 sums, so they agree to about one
bf16 step (2^-7 relative), checked at 1e-2. On the integer lattice
(integer x and weights, |sums| < 2^24) every order is exact, so the
results must be equal bit for bit; the int8 kernels then multiply by
the f32 scale once, a deterministic rounding, so they are bit-exact
there too, with x in f32 or bf16 (small integers are exact in bf16).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.nmweight import KernelPolicy, NMWeight
from repro_torch.core.sparsity import (
    NMConfig,
    apply_mask,
    compress_nm,
    prune_mask_nm,
)
from repro_torch.kernels import registry
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.indexmac import decode_kernel, kernel
from repro_torch.kernels.indexmac.ops import nm_matmul
from repro_torch.quant import QNMWeight, quantize_nm

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_gpu.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(m, k, n, cfg, dtype, device, seed=0, lattice=False):
    rng = np.random.default_rng(seed)
    if lattice:
        x = rng.integers(-4, 5, (m, k)).astype(np.float32)
        w = rng.integers(1, 5, (k, n)) * rng.choice([-1, 1], (k, n))
        w = w.astype(np.float32)
        bias = rng.integers(-8, 9, n).astype(np.float32)
    else:
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
        bias = rng.standard_normal(n).astype(np.float32)
    wt = torch.from_numpy(w)
    vals, idx = compress_nm(apply_mask(wt, prune_mask_nm(wt, cfg)), cfg)
    return (torch.from_numpy(x).to(device, dtype),
            vals.to(device, dtype).contiguous(), idx.to(device).contiguous(),
            torch.from_numpy(bias).to(device))


def _close(got, want, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", [NMConfig(2, 4), NMConfig(1, 4)],
                         ids=lambda c: c.tag)
@pytest.mark.parametrize("shape", [(70, 384, 200), (100, 96, 130),
                                   (512, 4096, 512), (9, 1024, 1000)],
                         ids=lambda s: "M%dK%dN%d" % s)
def test_nm_spmm_matches_plain(cuda, shape, cfg, dtype):
    m, k, n = shape
    x, vals, idx, _ = _operands(m, k, n, cfg, dtype, cuda)
    before = kernel.KERNEL.launches
    y = kernel.nm_spmm(x, vals, idx, cfg)
    torch.cuda.synchronize()
    assert kernel.KERNEL.launches == before + 1
    assert y.dtype == dtype and y.shape == (m, n)
    _close(y, kernel.nm_spmm_plain(x, vals, idx, cfg), dtype)


@pytest.mark.parametrize("shape", [(64, 256, 128), (77, 384, 200)],
                         ids=lambda s: "M%dK%dN%d" % s)
def test_nm_spmm_lattice_bit_exact(cuda, shape):
    m, k, n = shape
    cfg = NMConfig(2, 4)
    x, vals, idx, _ = _operands(m, k, n, cfg, torch.float32, cuda,
                                lattice=True)
    y = kernel.nm_spmm(x, vals, idx, cfg)
    assert torch.equal(y, kernel.nm_spmm_plain(x, vals, idx, cfg))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu", "relu_sq"])
@pytest.mark.parametrize("m", [1, 4, 7, 12])
@pytest.mark.parametrize("kn", [(384, 200), (4096, 512), (1024, 1001)],
                         ids=lambda s: "K%dN%d" % s)
def test_nm_spmm_decode_matches_plain(cuda, kn, m, act, dtype):
    k, n = kn
    cfg = NMConfig(2, 4)
    x, vals, idx, bias = _operands(m, k, n, cfg, dtype, cuda, seed=m)
    for b in (None, bias):
        y = decode_kernel.nm_spmm_decode(x, vals, idx, b, cfg, act)
        assert y.dtype == dtype and y.shape == (m, n)
        _close(y, decode_kernel.nm_spmm_decode_plain(x, vals, idx, b, cfg,
                                                     act), dtype)


@pytest.mark.parametrize("cfg", [NMConfig(2, 4), NMConfig(1, 4)],
                         ids=lambda c: c.tag)
@pytest.mark.parametrize("m", [1, 4, 8])
def test_nm_spmm_decode_lattice_bit_exact(cuda, m, cfg):
    x, vals, idx, bias = _operands(m, 2048, 384, cfg, torch.float32, cuda,
                                   lattice=True)
    for b, act in ((None, None), (bias, "relu"), (bias, "relu_sq")):
        y = decode_kernel.nm_spmm_decode(x, vals, idx, b, cfg, act)
        assert torch.equal(y, decode_kernel.nm_spmm_decode_plain(
            x, vals, idx, b, cfg, act))


def test_kernels_refuse_bad_operands(cuda):
    cfg = NMConfig(2, 4)
    x, vals, idx, _ = _operands(16, 64, 32, cfg, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.nm_spmm(x.t().contiguous().t(), vals, idx, cfg)
    with pytest.raises(ValueError, match="dtype"):
        decode_kernel.nm_spmm_decode(x[:2].half(), vals.half(), idx, None,
                                     cfg, None)
    with pytest.raises(ValueError, match="inconsistent"):
        kernel.nm_spmm(x, vals[:-2], idx[:-2], cfg)


def test_nm_matmul_routes_to_kernels_on_cuda(cuda):
    cfg = NMConfig(2, 4)
    x, vals, idx, bias = _operands(40, 256, 96, cfg, torch.float32, cuda)
    w = NMWeight(vals, idx, cfg, 0, KernelPolicy("auto"))
    registry.clear_history()
    nm_matmul(x, w)
    nm_matmul(x[:3], w, epilogue=Epilogue(bias=bias, activation="silu"))
    assert registry.dispatch_counts() == {
        ("nm_matmul", "nm_spmm", "cuda"): 1,
        ("nm_matmul_decode", "nm_spmm_decode", "cuda"): 1}
    with pytest.raises(registry.KernelForceError):
        nm_matmul(x, w, backend="cpu")


@pytest.mark.parametrize("m", [9, 15, 40])
def test_auto_runs_the_kernel_at_any_prefill_m(cuda, m):
    """On the card ``auto`` never gives a call to the reference: a short
    prefill (M = 9, most of a 64-row tile masked) launches the kernel."""
    cfg = NMConfig(2, 4)
    x, vals, idx, _ = _operands(m, 256, 96, cfg, torch.float32, cuda)
    w = NMWeight(vals, idx, cfg, 0, KernelPolicy("auto"))
    registry.clear_history()
    before = kernel.KERNEL.launches
    y = nm_matmul(x, w)
    assert kernel.KERNEL.launches == before + 1
    assert registry.dispatch_counts() == {("nm_matmul", "nm_spmm", "cuda"): 1}
    _close(y, kernel.nm_spmm_plain(x, vals, idx, cfg), torch.float32)


def test_auto_raises_on_the_card_without_a_kernel(cuda):
    cfg = NMConfig(2, 4)
    x, vals, idx, _ = _operands(16, 128, 64, cfg, torch.float32, cuda)
    w = NMWeight(vals.half(), idx, cfg, 0, KernelPolicy("auto"))
    with pytest.raises(registry.KernelForceError, match="'auto'"):
        nm_matmul(x.half(), w)
    off = NMWeight(vals, idx, cfg, 0, KernelPolicy("off"))
    registry.clear_history()
    nm_matmul(x, off)  # the caller's explicit choice
    assert registry.dispatch_counts() == {("nm_matmul", "reference", "cuda"): 1}


def test_tiny_serve_goes_through_both_kernels(cuda):
    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import build_model, serve
    from repro_torch.models.common import Linear

    _, lm = build_model("yi-9b", full=False, kernels=True,
                        dtype=torch.float32, device=cuda)
    assert {mod.kernel_policy.mode for mod in lm.modules()
            if isinstance(mod, Linear) and mod.nm is not None} == {"auto"}
    registry.clear_history()
    eng, done, _ = serve(lm, requests=3, slots=2, prefill_len=8, max_new=4,
                         max_seq=16)
    assert len(done) == 3 and all(len(r.out) == 4 for r in done)
    counts = registry.dispatch_counts()
    assert counts[("nm_matmul", "nm_spmm", "cuda")] > 0
    assert counts[("nm_matmul_decode", "nm_spmm_decode", "cuda")] > 0
    assert not [k for k in counts if k[1].startswith("reference")], counts
    assert get_reduced("yi-9b").vocab_size > max(max(r.out) for r in done)


# ---------------------------------------------------------------------------
# int8 kernels
# ---------------------------------------------------------------------------


def _q_operands(m, k, n, cfg, dtype, device, seed=0, lattice=False):
    """x in ``dtype``; int8 vals, idx and f32 scales (quantize_nm of
    random N:M weights, or random int8 values and scales on the lattice);
    an f32 bias."""
    x, vals, idx, bias = _operands(m, k, n, cfg, torch.float32, "cpu",
                                   seed=seed, lattice=lattice)
    if lattice:
        rng = np.random.default_rng(seed + 1)
        q = torch.from_numpy(rng.integers(-127, 128, vals.shape)
                             .astype(np.int8))
        q = torch.where(vals == 0, torch.zeros_like(q), q)
        scales = torch.from_numpy(rng.uniform(0.01, 0.1, n)
                                  .astype(np.float32))
    else:
        qw = quantize_nm(NMWeight(vals, idx, cfg))
        q, scales = qw.vals, qw.scales
    return (x.to(device, dtype), q.to(device), idx.to(device),
            scales.to(device), bias.to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", [NMConfig(2, 4), NMConfig(1, 4)],
                         ids=lambda c: c.tag)
@pytest.mark.parametrize("shape", [(70, 384, 200), (512, 4096, 512),
                                   (9, 1024, 1000)],
                         ids=lambda s: "M%dK%dN%d" % s)
def test_nm_spmm_q_matches_plain(cuda, shape, cfg, dtype):
    m, k, n = shape
    x, q, idx, scales, _ = _q_operands(m, k, n, cfg, dtype, cuda)
    before = kernel.KERNEL_Q.launches
    y = kernel.nm_spmm_q(x, q, idx, scales, cfg)
    torch.cuda.synchronize()
    assert kernel.KERNEL_Q.launches == before + 1
    assert y.dtype == dtype and y.shape == (m, n)
    _close(y, kernel.nm_spmm_q_plain(x, q, idx, scales, cfg), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu", "relu_sq"])
@pytest.mark.parametrize("m", [1, 4, 8, 12])
@pytest.mark.parametrize("kn", [(384, 200), (4096, 512), (1024, 1001)],
                         ids=lambda s: "K%dN%d" % s)
def test_nm_spmm_decode_q_matches_plain(cuda, kn, m, act, dtype):
    """8 int8 columns per thread, and N = 1001 (one column per thread,
    the unaligned fallback)."""
    k, n = kn
    cfg = NMConfig(2, 4)
    x, q, idx, scales, bias = _q_operands(m, k, n, cfg, dtype, cuda, seed=m)
    for b in (None, bias):
        before = decode_kernel.KERNEL_Q.launches
        y = decode_kernel.nm_spmm_decode_q(x, q, idx, scales, b, cfg, act)
        # one launch per group of at most 8 rows
        assert decode_kernel.KERNEL_Q.launches == before + -(-m // 8)
        assert y.dtype == dtype and y.shape == (m, n)
        _close(y, decode_kernel.nm_spmm_decode_q_plain(x, q, idx, scales, b,
                                                       cfg, act), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", [NMConfig(2, 4), NMConfig(1, 4)],
                         ids=lambda c: c.tag)
def test_int8_kernels_lattice_bit_exact(cuda, cfg, dtype):
    x, q, idx, scales, _ = _q_operands(77, 2048, 384, cfg, dtype, cuda,
                                       lattice=True)
    assert torch.equal(kernel.nm_spmm_q(x, q, idx, scales, cfg),
                       kernel.nm_spmm_q_plain(x, q, idx, scales, cfg))
    for m in (1, 4, 8):
        xm, q, idx, scales, bias = _q_operands(m, 2048, 384, cfg, dtype,
                                               cuda, seed=m, lattice=True)
        for b, act in ((None, None), (bias, "relu"), (bias, "relu_sq")):
            y = decode_kernel.nm_spmm_decode_q(xm, q, idx, scales, b, cfg,
                                               act)
            assert torch.equal(y, decode_kernel.nm_spmm_decode_q_plain(
                xm, q, idx, scales, b, cfg, act))


def test_int8_kernels_refuse_bad_operands(cuda):
    cfg = NMConfig(2, 4)
    x, q, idx, scales, _ = _q_operands(16, 64, 32, cfg, torch.float32, cuda)
    with pytest.raises(ValueError, match="int8 vals"):
        kernel.nm_spmm_q(x, q.float(), idx, scales, cfg)
    with pytest.raises(ValueError, match="scales"):
        kernel.nm_spmm_q(x, q, idx, scales.half(), cfg)
    with pytest.raises(ValueError, match="scales"):
        decode_kernel.nm_spmm_decode_q(x[:2], q, idx, scales[:-1], None, cfg)
    with pytest.raises(ValueError, match="devices"):
        kernel.nm_spmm_q(x, q, idx, scales.cpu(), cfg)
    with pytest.raises(ValueError, match="int8 vals"):
        decode_kernel.nm_spmm_decode_q(x[:2].half(), q, idx, scales, None,
                                       cfg)
    with pytest.raises(ValueError, match="inconsistent"):
        kernel.nm_spmm_q(x, q[:-2], idx[:-2], scales, cfg)


def test_int8_nm_matmul_routes_to_kernels_on_cuda(cuda):
    cfg = NMConfig(2, 4)
    x, q, idx, scales, bias = _q_operands(40, 256, 96, cfg, torch.bfloat16,
                                          cuda)
    w = QNMWeight(q, idx, scales, cfg, 0, KernelPolicy("auto"))
    registry.clear_history()
    nm_matmul(x, w)
    nm_matmul(x[:3], w, epilogue=Epilogue(bias=bias, activation="silu"))
    assert registry.dispatch_counts() == {
        ("nm_matmul_q", "nm_spmm_q", "cuda"): 1,
        ("nm_matmul_decode_q", "nm_spmm_decode_q", "cuda"): 1}
    with pytest.raises(registry.KernelForceError):
        nm_matmul(x.half(), w)  # no int8 kernel for fp16 x: no fallback


def test_tiny_int8_serve_goes_through_the_int8_kernels(cuda):
    from repro_torch.launch.serve import build_model, serve

    _, lm = build_model("yi-9b", full=False, kernels=True,
                        dtype=torch.bfloat16, device=cuda, quantize="int8")
    registry.clear_history()
    _, done, _ = serve(lm, requests=3, slots=2, prefill_len=8, max_new=4,
                       max_seq=16)
    assert len(done) == 3 and all(len(r.out) == 4 for r in done)
    assert set(registry.dispatch_counts()) == {
        ("nm_matmul_q", "nm_spmm_q", "cuda"),
        ("nm_matmul_decode_q", "nm_spmm_decode_q", "cuda")}
