"""The PyTorch/CUDA port on the card: each hand-written kernel (float
and int8, the N:M products and the gather port) against its plain
PyTorch version, tiny serves through the float and the int8 kernels,
and reduced CNN forwards through the prefill kernels.

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
    pad_compressed_kn,
    prune_mask_nm,
)
from repro_torch.kernels import registry
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.indexmac import decode_kernel, kernel
from repro_torch.kernels.indexmac.ops import nm_matmul
from repro_torch.kernels.indexmac_gather import kernel as gather_kernel
from repro_torch.kernels.padding import prefill_path
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


def _launched(kern, path, run):
    """Run ``run()``; assert it launched ``kern`` once, on ``path``."""
    before = kern.launches, dict(kern.path_launches)
    out = run()
    torch.cuda.synchronize()
    after = dict(before[1], **{path: before[1][path] + 1})
    assert kern.launches == before[0] + 1
    assert kern.path_launches == after, (path, kern.path_launches)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", [NMConfig(2, 4), NMConfig(1, 4),
                                 NMConfig(4, 8)], ids=lambda c: c.tag)
@pytest.mark.parametrize("shape", [(70, 384, 200), (100, 96, 130),
                                   (512, 4096, 512), (9, 1024, 1000),
                                   (640, 2048, 4096), (33, 392, 1001)],
                         ids=lambda s: "M%dK%dN%d" % s)
def test_nm_spmm_matches_plain(cuda, shape, cfg, dtype):
    """Both paths (bf16 at 2:4 and 1:4 is sparse; f32 and 4:8 dense), both
    tiles (M640 N4096 takes the large one) and unaligned N (130, 1001:
    vals and idx rows staged 4 bytes or one element at a time)."""
    m, k, n = shape
    x, vals, idx, _ = _operands(m, k, n, cfg, dtype, cuda)
    path = prefill_path(cfg, dtype, dtype)
    assert path == ("sparse" if dtype == torch.bfloat16 and cfg.m == 4
                    else "dense")
    y = _launched(kernel.KERNEL, path,
                  lambda: kernel.nm_spmm(x, vals, idx, cfg))
    assert y.dtype == dtype and y.shape == (m, n)
    _close(y, kernel.nm_spmm_plain(x, vals, idx, cfg), dtype)


def _x_at_offset(x, offset):
    """A contiguous copy of x whose data starts ``offset`` elements past a
    16-byte aligned address."""
    base = torch.zeros(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = base[offset:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", [NMConfig(2, 4), NMConfig(4, 8)],
                         ids=lambda c: c.tag)
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_prefill_kernels_stage_unaligned_x(cuda, offset, cfg, dtype):
    """x rows the 16-byte copies cannot take: at 2:4, K = 388 (bf16 rows
    of 776 bytes, so 8-byte copies); x starting 1 or 2 elements past an
    aligned address (bf16: one element at a time, or 4-byte copies; f32:
    4- or 8-byte copies). Both kernels against their plain versions."""
    m, k, n = 150, 388 if cfg.m == 4 else 392, 1001
    x, vals, idx, _ = _operands(m, k, n, cfg, dtype, cuda)
    x = _x_at_offset(x, offset)
    assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == (offset == 0)
    y = _launched(kernel.KERNEL, prefill_path(cfg, dtype, dtype),
                  lambda: kernel.nm_spmm(x, vals, idx, cfg))
    _close(y, kernel.nm_spmm_plain(x, vals, idx, cfg), dtype)
    _, q, idx, scales, _ = _q_operands(m, k, n, cfg, dtype, cuda)
    y = _launched(kernel.KERNEL_Q, prefill_path(cfg, dtype, torch.int8),
                  lambda: kernel.nm_spmm_q(x, q, idx, scales, cfg))
    _close(y, kernel.nm_spmm_q_plain(x, q, idx, scales, cfg), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", [NMConfig(7, 8), NMConfig(15, 16),
                                 NMConfig(31, 32)], ids=lambda c: c.tag)
def test_prefill_kernels_at_dense_patterns_on_a_full_grid(cuda, cfg, dtype):
    """Dense patterns at M 2048, N 4096, where the grid fills the card: in
    f32 the large tile's ring would not fit the shared memory at these
    patterns, so the host takes the small tile; both kernels run and
    match their plain versions."""
    m, k, n = 2048, 1024, 4096
    x, vals, idx, _ = _operands(m, k, n, cfg, dtype, cuda)
    y = _launched(kernel.KERNEL, "dense",
                  lambda: kernel.nm_spmm(x, vals, idx, cfg))
    _close(y, kernel.nm_spmm_plain(x, vals, idx, cfg), dtype)
    _, q, idx, scales, _ = _q_operands(m, k, n, cfg, dtype, cuda)
    y = _launched(kernel.KERNEL_Q, "dense",
                  lambda: kernel.nm_spmm_q(x, q, idx, scales, cfg))
    _close(y, kernel.nm_spmm_q_plain(x, q, idx, scales, cfg), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_prefill_kernels_take_every_pattern(cuda, dtype):
    """Every 1 <= n < m <= 32 launches (on the tile and path the host
    picks for a grid that fills the card) and matches the plain version,
    in both kernels."""
    mm, nn = 1024, 1152  # 8 x 9 large tiles
    for pm in range(2, 33):
        for pn in range(1, pm):
            cfg = NMConfig(pn, pm)
            k = 20 * pm  # a ragged last stage where m does not divide 20
            x, vals, idx, _ = _operands(mm, k, nn, cfg, dtype, cuda,
                                        seed=pm * 32 + pn)
            y = _launched(kernel.KERNEL, prefill_path(cfg, dtype, dtype),
                          lambda: kernel.nm_spmm(x, vals, idx, cfg))
            _close(y, kernel.nm_spmm_plain(x, vals, idx, cfg), dtype)
            q = (vals * 64).round().clamp(-127, 127).to(torch.int8)
            scales = torch.full((nn,), 1 / 64, device=cuda)
            y = _launched(kernel.KERNEL_Q,
                          prefill_path(cfg, dtype, torch.int8),
                          lambda: kernel.nm_spmm_q(x, q, idx, scales, cfg))
            _close(y, kernel.nm_spmm_q_plain(x, q, idx, scales, cfg), dtype)


def test_nm_spmm_f32_cnn_gemm(cuda):
    """ResNet-50 s2b1_3x3 at batch 8 (M 25088, K 576, N 64) in f32: the
    dense 3xTF32 path within the f32 tolerance."""
    cfg = NMConfig(2, 4)
    x, vals, idx, _ = _operands(25088, 576, 64, cfg, torch.float32, cuda)
    y = _launched(kernel.KERNEL, "dense",
                  lambda: kernel.nm_spmm(x, vals, idx, cfg))
    _close(y, kernel.nm_spmm_plain(x, vals, idx, cfg), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", [NMConfig(2, 4), NMConfig(4, 8)],
                         ids=lambda c: c.tag)
@pytest.mark.parametrize("shape", [(64, 256, 128), (77, 384, 200),
                                   (200, 2048, 256)],
                         ids=lambda s: "M%dK%dN%d" % s)
def test_nm_spmm_lattice_bit_exact(cuda, shape, cfg, dtype):
    m, k, n = shape
    x, vals, idx, _ = _operands(m, k, n, cfg, dtype, cuda, lattice=True)
    y = _launched(kernel.KERNEL, prefill_path(cfg, dtype, dtype),
                  lambda: kernel.nm_spmm(x, vals, idx, cfg))
    assert torch.equal(y, kernel.nm_spmm_plain(x, vals, idx, cfg))


def _irregular(k, n, cfg, seed):
    """Lattice weights in the forms the sparse path must canonicalize:
    short blocks from compress_nm (most weights exactly zero, so a kept
    value may sit after a padding index: [0, 0, 3, 0] gives idx [2, 0]),
    all-zero blocks, index pairs repeated with non-zero values (they add
    up), and zero-valued blocks appended by pad_compressed_kn (index 0
    repeated)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 5, (k, n)) * rng.choice([-1, 1], (k, n))
    w = np.where(rng.random((k, n)) < 0.7, 0, w).astype(np.float32)
    wt = torch.from_numpy(w)
    vals, idx = compress_nm(apply_mask(wt, prune_mask_nm(wt, cfg)), cfg)
    rep = torch.from_numpy(rng.random(vals.shape) < 0.1)
    grp = torch.arange(vals.shape[0])[:, None] % cfg.n == 1
    idx = torch.where(rep & grp, torch.roll(idx, 1, 0), idx)  # repeats
    kc_pad = vals.shape[0] + 8 * cfg.n  # 8 zero m-blocks: index 0 repeated
    return pad_compressed_kn(vals, idx, kc_pad=kc_pad, n_pad=n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", [NMConfig(2, 4), NMConfig(1, 4),
                                 NMConfig(4, 8)], ids=lambda c: c.tag)
def test_prefill_kernels_on_irregular_weights(cuda, cfg, dtype):
    """Short blocks, repeated indices and padded blocks, float and int8,
    bit-exact on the lattice on both paths."""
    vals, idx = _irregular(1024, 200, cfg, seed=3)
    k = vals.shape[0] * cfg.m // cfg.n
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-4, 5, (150, k)).astype(np.float32))
    x, vals, idx = x.to(cuda, dtype), vals.to(cuda, dtype), idx.to(cuda)
    path = prefill_path(cfg, dtype, dtype)
    y = _launched(kernel.KERNEL, path,
                  lambda: kernel.nm_spmm(x, vals, idx, cfg))
    assert torch.equal(y, kernel.nm_spmm_plain(x, vals, idx, cfg))
    q = vals.to(torch.int8)  # small integers: the same weights in int8
    scales = torch.from_numpy(rng.uniform(0.01, 0.1, 200).astype(
        np.float32)).to(cuda)
    y = _launched(kernel.KERNEL_Q, prefill_path(cfg, dtype, torch.int8),
                  lambda: kernel.nm_spmm_q(x, q, idx, scales, cfg))
    assert torch.equal(y, kernel.nm_spmm_q_plain(x, q, idx, scales, cfg))


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
@pytest.mark.parametrize("cfg", [NMConfig(2, 4), NMConfig(1, 4),
                                 NMConfig(4, 8)], ids=lambda c: c.tag)
@pytest.mark.parametrize("shape", [(70, 384, 200), (512, 4096, 512),
                                   (9, 1024, 1000), (640, 2048, 4096),
                                   (33, 392, 1001)],
                         ids=lambda s: "M%dK%dN%d" % s)
def test_nm_spmm_q_matches_plain(cuda, shape, cfg, dtype):
    m, k, n = shape
    x, q, idx, scales, _ = _q_operands(m, k, n, cfg, dtype, cuda)
    path = prefill_path(cfg, dtype, torch.int8)
    y = _launched(kernel.KERNEL_Q, path,
                  lambda: kernel.nm_spmm_q(x, q, idx, scales, cfg))
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
    """The prefill kernel on both paths (bf16 x: int8 values through
    mma.sp; f32 x: the dense 3xTF32 path), then the decode kernel."""
    x, q, idx, scales, _ = _q_operands(77, 2048, 384, cfg, dtype, cuda,
                                       lattice=True)
    y = _launched(kernel.KERNEL_Q, prefill_path(cfg, dtype, torch.int8),
                  lambda: kernel.nm_spmm_q(x, q, idx, scales, cfg))
    assert torch.equal(y, kernel.nm_spmm_q_plain(x, q, idx, scales, cfg))
    for m in (1, 4, 8):
        xm, q, idx, scales, bias = _q_operands(m, 2048, 384, cfg, dtype,
                                               cuda, seed=m, lattice=True)
        for b, act in ((None, None), (bias, "relu"), (bias, "relu_sq")):
            y = decode_kernel.nm_spmm_decode_q(xm, q, idx, scales, b, cfg,
                                               act)
            assert torch.equal(y, decode_kernel.nm_spmm_decode_q_plain(
                xm, q, idx, scales, b, cfg, act))


# decode shapes whose plan splits K: yi-9b's wk / wv, a ragged N (200),
# and N = 1001, whose rows are 1-byte aligned (the element-wise copies)
DECODE_SPLIT_SHAPES = [(4096, 512), (2048, 200), (1024, 1001)]


def _decode_cases(x, vals, idx, bias, cfg, act, seed=0):
    """(kernel, itemsize of vals, run, plain) of the float and the int8
    decode kernels on the same weights (the int8 ones quantize_nm's)."""
    qw = quantize_nm(NMWeight(vals.float(), idx, cfg))
    q, scales = qw.vals, qw.scales
    return (
        (decode_kernel.KERNEL, vals.element_size(),
         lambda: decode_kernel.nm_spmm_decode(x, vals, idx, bias, cfg, act),
         lambda: decode_kernel.nm_spmm_decode_plain(x, vals, idx, bias, cfg,
                                                    act)),
        (decode_kernel.KERNEL_Q, 1,
         lambda: decode_kernel.nm_spmm_decode_q(x, q, idx, scales, bias, cfg,
                                                act),
         lambda: decode_kernel.nm_spmm_decode_q_plain(x, q, idx, scales,
                                                      bias, cfg, act)))


def _counters_zeroed() -> bool:
    torch.cuda.synchronize()
    return all(int(c.abs().sum()) == 0
               for c in decode_kernel._COUNTERS.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("kn", DECODE_SPLIT_SHAPES,
                         ids=lambda s: "K%dN%d" % s)
def test_decode_kernels_split_k_is_one_launch_and_bit_identical(cuda, kn, m,
                                                                dtype):
    """Split-K adds the partials in a fixed order inside the launch: each
    call is one launch, two calls give the same y bit for bit, and the
    tiles' counters are left zeroed (float and int8 kernels)."""
    from repro_torch.kernels.padding import decode_plan, sm_count

    k, n = kn
    cfg = NMConfig(2, 4)
    x, vals, idx, bias = _operands(m, k, n, cfg, dtype, cuda, seed=m)
    for kern, itemsize, run, plain in _decode_cases(x, vals, idx, bias, cfg,
                                                    "silu"):
        assert decode_plan(m, k, n, cfg, itemsize,
                           sm_count(cuda.index or 0)).splits > 1
        before = kern.launches
        first = run()
        assert kern.launches == before + 1
        assert torch.equal(first, run())
        _close(first, plain(), dtype)
        assert _counters_zeroed()


def test_decode_kernels_on_two_streams(cuda):
    """Calls alternating on two streams each use their stream's counters
    and workspace: every result equals the first, and the counters of
    both streams are left zeroed."""
    cfg = NMConfig(2, 4)
    x, vals, idx, bias = _operands(4, 4096, 512, cfg, torch.bfloat16, cuda)
    want = decode_kernel.nm_spmm_decode(x, vals, idx, bias, cfg, "silu")
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    outs = []
    for _ in range(8):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(decode_kernel.nm_spmm_decode(x, vals, idx, bias,
                                                         cfg, "silu"))
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)
    keys = {(cuda.index or 0, st.cuda_stream) for st in streams}
    assert keys <= {(d or 0, s) for d, s in decode_kernel._COUNTERS}
    assert _counters_zeroed()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_kernels_take_unaligned_weight_views(cuda, dtype):
    """vals and idx as views that start off a 16-byte boundary: the ring
    copies them in narrower pieces (or element by element) and the kernel
    serves the call, equal bit for bit to the aligned call's result."""
    cfg = NMConfig(2, 4)
    x, vals, idx, bias = _operands(4, 2048, 512, cfg, dtype, cuda, seed=2)

    def shifted(t, off):
        buf = torch.zeros(t.numel() + off, dtype=t.dtype, device=cuda)
        view = buf[off:].view(t.shape)
        view.copy_(t)
        return view

    for kern, _, run, plain in _decode_cases(x, vals, idx, bias, cfg, None):
        aligned = run()
        if kern is decode_kernel.KERNEL:
            uv, ui = shifted(vals, 1), shifted(idx, 1)
            assert uv.data_ptr() % 16 and ui.data_ptr() % 16
            unaligned = lambda: decode_kernel.nm_spmm_decode(  # noqa: E731
                x, uv, ui, bias, cfg, None)
        else:
            qw = quantize_nm(NMWeight(vals.float(), idx, cfg))
            uq, ui = shifted(qw.vals, 3), shifted(idx, 5)
            unaligned = lambda: decode_kernel.nm_spmm_decode_q(  # noqa: E731
                x, uq, ui, qw.scales, bias, cfg, None)
        before = kern.launches
        got = unaligned()
        assert kern.launches == before + 1
        assert torch.equal(got, aligned)
        _close(got, plain(), dtype)


@pytest.mark.parametrize("cfg", [NMConfig(2, 4), NMConfig(1, 4)],
                         ids=lambda c: c.tag)
def test_decode_kernels_add_repeated_indices(cuda, cfg):
    """Padded weights (``pad_compressed_kn``'s: value 0 at index 0, n times
    a block) and blocks whose kept values repeat an index with non-zero
    values: the kernels add every kept value, as ``decompress_nm`` does."""
    k, n, extra = 2048, 384, 40  # 40 m-blocks of padding along K
    x, vals, idx, bias = _operands(4, k, n, cfg, torch.float32, cuda, seed=5)
    if cfg.n > 1:  # every other block's second kept value takes its first
        idx = idx.clone()  # value's index: both add into one row of W
        idx[1::2 * cfg.n] = idx[0:-1:2 * cfg.n]
    pv, pi = pad_compressed_kn(vals, idx, kc_pad=vals.shape[0] + extra * cfg.n,
                               n_pad=n)
    px = torch.cat([x, torch.randn(4, extra * cfg.m, device=cuda)], 1)
    rng = np.random.default_rng(6)
    # |q| < 64: a repeated index sums two values, and the plain version
    # decompresses in int8
    q = torch.from_numpy(rng.integers(-63, 64, tuple(pv.shape))
                         .astype(np.int8)).to(cuda)
    q = torch.where(pv == 0, torch.zeros_like(q), q)
    scales = torch.from_numpy(rng.uniform(0.01, 0.1, n)
                              .astype(np.float32)).to(cuda)
    _close(decode_kernel.nm_spmm_decode(px, pv, pi, bias, cfg, "relu"),
           decode_kernel.nm_spmm_decode_plain(px, pv, pi, bias, cfg, "relu"),
           torch.float32)
    _close(decode_kernel.nm_spmm_decode_q(px, q, pi, scales, bias, cfg,
                                          "relu"),
           decode_kernel.nm_spmm_decode_q_plain(px, q, pi, scales, bias, cfg,
                                                "relu"), torch.float32)


@pytest.mark.parametrize("m", list(range(1, 9)) + [12, 17])
def test_decode_kernels_every_row_count(cuda, m):
    """M = 1..8 in one launch (1, 2, 4 or 8 rows computed, the rest
    zeros), more rows in launches of 8."""
    cfg = NMConfig(2, 4)
    x, vals, idx, bias = _operands(m, 2048, 264, cfg, torch.bfloat16, cuda,
                                   seed=m)
    for kern, _, run, plain in _decode_cases(x, vals, idx, bias, cfg,
                                             "gelu"):
        before = kern.launches
        y = run()
        assert kern.launches == before + -(-m // 8)
        assert y.shape == (m, 264)
        _close(y, plain(), torch.bfloat16)


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


# ---------------------------------------------------------------------------
# gather kernels (the paper's Algorithm 3) and the CNN forward
# ---------------------------------------------------------------------------


def _a_operands(mr, k, nc, cfg, device, seed=0, lattice=False):
    """A compressed along its rows (f32 vals, int8 idx) and f32 B."""
    rng = np.random.default_rng(seed)
    if lattice:
        a = (rng.integers(1, 5, (mr, k))
             * rng.choice([-1, 1], (mr, k))).astype(np.float32)
        b = rng.integers(-8, 9, (k, nc)).astype(np.float32)
    else:
        a = rng.standard_normal((mr, k)).astype(np.float32)
        b = rng.standard_normal((k, nc)).astype(np.float32)
    at = torch.from_numpy(a)
    vals, idx = compress_nm(apply_mask(at, prune_mask_nm(at, cfg, axis=1)),
                            cfg, axis=1)
    return vals.to(device), idx.to(device), torch.from_numpy(b).to(device)


@pytest.mark.parametrize("b_dtype", [torch.float32, torch.bfloat16],
                         ids=["bf32", "bbf16"])
@pytest.mark.parametrize("v_dtype", [torch.float32, torch.bfloat16],
                         ids=["vf32", "vbf16"])
@pytest.mark.parametrize("cfg", [NMConfig(2, 4), NMConfig(1, 4)],
                         ids=lambda c: c.tag)
@pytest.mark.parametrize("shape", [(64, 576, 3136), (256, 2304, 196),
                                   (2048, 512, 49), (512, 4608, 49),
                                   (77, 1540, 53), (24, 148, 49),
                                   (33, 8, 65)],
                         ids=lambda s: "Mr%dK%dN%d" % s)
def test_indexmac_gather_matches_plain(cuda, shape, cfg, v_dtype, b_dtype):
    mr, k, nc = shape
    vals, idx, b = _a_operands(mr, k, nc, cfg, cuda)
    vals, b = vals.to(v_dtype), b.to(b_dtype)
    before = gather_kernel.KERNEL.launches
    y = gather_kernel.indexmac_gather(vals, idx, b, cfg)
    torch.cuda.synchronize()
    assert gather_kernel.KERNEL.launches == before + 1
    assert y.dtype == b_dtype and y.shape == (mr, nc)
    _close(y, gather_kernel.indexmac_gather_plain(vals, idx, b, cfg), b_dtype)


@pytest.mark.parametrize("b_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", [NMConfig(2, 4), NMConfig(1, 4)],
                         ids=lambda c: c.tag)
@pytest.mark.parametrize("shape", [(256, 2304, 196), (24, 148, 49)],
                         ids=lambda s: "Mr%dK%dN%d" % s)
def test_gather_kernels_bit_exact_on_the_lattice(cuda, shape, cfg, b_dtype):
    mr, k, nc = shape
    vals, idx, b = _a_operands(mr, k, nc, cfg, cuda, lattice=True)
    b = b.to(b_dtype)
    if b_dtype == torch.float32:
        assert torch.equal(gather_kernel.indexmac_gather(vals, idx, b, cfg),
                           gather_kernel.indexmac_gather_plain(vals, idx, b,
                                                               cfg))
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.integers(-127, 128, tuple(vals.shape))
                         .astype(np.int8)).to(cuda)
    q = torch.where(vals == 0, torch.zeros_like(q), q)
    scales = torch.from_numpy(rng.uniform(0.01, 0.1, mr)
                              .astype(np.float32)).to(cuda)
    before = gather_kernel.KERNEL_Q.launches
    y = gather_kernel.indexmac_gather_q(q, idx, scales, b, cfg)
    assert gather_kernel.KERNEL_Q.launches == before + 1
    assert torch.equal(y, gather_kernel.indexmac_gather_q_plain(
        q, idx, scales, b, cfg))


# the deepest split of the ResNet-50 layers, and ragged Mr, Nc and K tail
# (1540 = 48 steps of 32 rows + 4) over several splits
SPLIT_SHAPES = [(512, 4608, 49), (77, 1540, 53)]


@pytest.mark.parametrize("cfg", [NMConfig(2, 4), NMConfig(1, 4)],
                         ids=lambda c: c.tag)
@pytest.mark.parametrize("shape", SPLIT_SHAPES,
                         ids=lambda s: "Mr%dK%dN%d" % s)
def test_gather_kernels_split_k_is_one_launch_and_bit_identical(cuda, shape,
                                                                cfg):
    """Split-K reduces in a fixed order inside the launch: each call is
    one launch, and two calls on the same inputs give the same C bit for
    bit (float and int8 kernels, B in f32 and bf16)."""
    from repro_torch.kernels.padding import gather_plan, sm_count

    mr, k, nc = shape
    assert gather_plan(mr, k, nc, cfg, torch.float32, torch.float32,
                       sm_count(cuda.index or 0)).splits > 1
    vals, idx, b = _a_operands(mr, k, nc, cfg, cuda, seed=3)
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.integers(-127, 128, tuple(vals.shape))
                         .astype(np.int8)).to(cuda)
    scales = torch.from_numpy(rng.uniform(0.01, 0.1, mr)
                              .astype(np.float32)).to(cuda)
    for bb in (b, b.to(torch.bfloat16)):
        for kern, run in (
                (gather_kernel.KERNEL, lambda: gather_kernel.indexmac_gather(
                    vals.to(bb.dtype), idx, bb, cfg)),
                (gather_kernel.KERNEL_Q,
                 lambda: gather_kernel.indexmac_gather_q(q, idx, scales, bb,
                                                         cfg))):
            before = kern.launches
            first = run()
            assert kern.launches == before + 1
            assert torch.equal(first, run())


@pytest.mark.parametrize("cfg", [NMConfig(2, 4), NMConfig(1, 4)],
                         ids=lambda c: c.tag)
def test_gather_kernels_add_repeated_indices(cuda, cfg):
    """Padded weights (``pad_compressed_kn``'s: value 0 at index 0, n times
    a block) and blocks whose kept values repeat an index with non-zero
    values: the kernels add every kept value, as ``decompress_nm`` does."""
    mr, k, nc = 77, 1540, 53
    vals, idx, b = _a_operands(mr, k, nc, cfg, cuda, seed=5)
    if cfg.n > 1:  # every other block's second kept value takes its first
        idx = idx.clone()  # value's index: both add into one row of A
        idx[:, 1::2 * cfg.n] = idx[:, 0:-1:2 * cfg.n]
    extra = 40  # m-blocks of padding: a K tail on another split
    pv, pi = pad_compressed_kn(vals.t().contiguous(), idx.t().contiguous(),
                               kc_pad=vals.shape[1] + extra * cfg.n,
                               n_pad=mr)
    pv, pi = pv.t().contiguous(), pi.t().contiguous()
    pb = torch.cat([b, torch.randn(extra * cfg.m, nc, device=cuda)])
    rng = np.random.default_rng(6)
    # |q| < 64: a repeated index sums two values, and the plain version
    # decompresses in int8
    q = torch.from_numpy(rng.integers(-63, 64, tuple(pv.shape))
                         .astype(np.int8)).to(cuda)
    q = torch.where(pv == 0, torch.zeros_like(q), q)
    scales = torch.from_numpy(rng.uniform(0.01, 0.1, mr)
                              .astype(np.float32)).to(cuda)
    _close(gather_kernel.indexmac_gather(pv, pi, pb, cfg),
           gather_kernel.indexmac_gather_plain(pv, pi, pb, cfg),
           torch.float32)
    _close(gather_kernel.indexmac_gather_q(q, pi, scales, pb, cfg),
           gather_kernel.indexmac_gather_q_plain(q, pi, scales, pb, cfg),
           torch.float32)


def test_gather_kernels_refuse_bad_operands(cuda):
    cfg = NMConfig(2, 4)
    vals, idx, b = _a_operands(16, 64, 32, cfg, cuda)
    scales = torch.ones(16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gather_kernel.indexmac_gather(vals, idx, b.t().contiguous().t(), cfg)
    with pytest.raises(ValueError, match="f32 or bf16 b"):
        gather_kernel.indexmac_gather(vals, idx, b.half(), cfg)
    with pytest.raises(ValueError, match="inconsistent"):
        gather_kernel.indexmac_gather(vals[:, :-2], idx[:, :-2], b, cfg)
    with pytest.raises(ValueError, match="int8 vals"):
        gather_kernel.indexmac_gather_q(vals, idx, scales, b, cfg)
    with pytest.raises(ValueError, match="scales"):
        gather_kernel.indexmac_gather_q(vals.to(torch.int8), idx, scales[:-1],
                                        b, cfg)


def test_indexmac_gather_routes_to_the_kernels_on_cuda(cuda):
    from repro_torch.api import indexmac_gather, quantize

    cfg = NMConfig(2, 4)
    vals, idx, b = _a_operands(40, 256, 96, cfg, cuda)
    w = NMWeight(vals, idx, cfg, 1, KernelPolicy("auto"))
    registry.clear_history()
    indexmac_gather(w, b)
    indexmac_gather(quantize(w), b)
    assert registry.dispatch_counts() == {
        ("indexmac_gather", "indexmac_gather", "cuda"): 1,
        ("indexmac_gather_q", "indexmac_gather_q", "cuda"): 1}
    with pytest.raises(registry.KernelForceError, match="'auto'"):
        indexmac_gather(w, b.half())  # no kernel for fp16 b: no fallback


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("cnn", ["resnet50", "densenet121"])
def test_reduced_cnn_through_the_kernels(cuda, cnn, quantize):
    """Reduced CNN logits through the prefill kernels equal those through
    the plain path on the same weights (policy off) within 1e-4."""
    import dataclasses

    from repro_torch.configs import get_cnn_reduced
    from repro_torch.models.conv import SparseCNN

    cfg = get_cnn_reduced(cnn)
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, use_kernel=True))
    model = SparseCNN.init(cfg, device=cuda, quantize=quantize)
    x = torch.randn(2, 32, 32, 3, device=cuda)
    registry.clear_history()
    with torch.inference_mode():
        got = model(x)
        counts = registry.dispatch_counts()
        for conv in model.convs.values():
            if conv.nm is not None:
                conv.kernel_policy = KernelPolicy("off")
        want = model(x)
    fam = ("nm_matmul_q", "nm_spmm_q") if quantize else ("nm_matmul",
                                                         "nm_spmm")
    assert counts == {(*fam, "cuda"): len(model.convs) - 1}
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# block-sparse attention: the pair-list kernel against the dense reference
# ---------------------------------------------------------------------------

_BW_PAIRS = tuple((i, j) for i in range(16) for j in (0, i))


def _attn_specs():
    from repro_torch.kernels.blocksparse_attn.mask import MaskSpec

    return [MaskSpec("causal", block=16),
            MaskSpec("local", block=16, window=24),
            MaskSpec("local", block=16, window=24, causal=False),
            MaskSpec("strided", block=16, stride=2),
            MaskSpec("blockwise", block=16, blocks=_BW_PAIRS),
            MaskSpec("local", block=128, window=40)]  # > 64 rows and keys


def _qkv(device, dtype, b=2, sq=67, hq=4, hkv=2, dk=16, dv=None, seed=0):
    rng = np.random.default_rng(seed)
    dv = dk if dv is None else dv
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(device, dtype)
                 for s in ((b, sq, hq, dk), (b, sq, hkv, dk), (b, sq, hkv, dv)))


def _attn_close(got, q, k, v, plan, spec, dtype, scale=None):
    """The kernel's output against masked_reference and against the plain
    twin of the bf16 kernel's arithmetic, within TOL."""
    from repro_torch.kernels.blocksparse_attn.ref import (
        blocksparse_mma,
        masked_reference,
    )

    assert got.dtype == dtype
    _close(got, masked_reference(q, k, v, spec=spec, scale=scale), dtype)
    _close(got, blocksparse_mma(q, k, v, plan=plan, scale=scale), dtype)


# (Hq, Hkv): GQA ratios 1, 2 and 8. On a 132-SM card the bf16 kernel takes
# G' = 2 heads a CTA at ratios 2 and 8 with Sq = 200 and block 16, and
# G' = 1 at the other lengths (tests/test_torch_blocksparse_attn.py
# test_heads_per_cta_rule pins those grids).
@pytest.mark.parametrize("heads", [(8, 8), (16, 8), (16, 2)],
                         ids=["gqa1", "gqa2", "gqa8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("sq", [64, 67, 200])
@pytest.mark.parametrize("spec_i", range(6))
def test_bs_attention_kernel_matches_reference(cuda, spec_i, sq, dtype,
                                               heads):
    from repro_torch.kernels.blocksparse_attn import kernel as bk
    from repro_torch.kernels.blocksparse_attn.mask import compile_mask

    spec = _attn_specs()[spec_i]
    q, k, v = _qkv(cuda, dtype, sq=sq, hq=heads[0], hkv=heads[1])
    plan = compile_mask(spec, sq, sq)
    if plan is None:  # the non-causal local mask at this length tiles
        pytest.fail(f"{spec.tag} at {sq} does not tile")
    before = bk.KERNEL.launches
    got = bk.bs_attention(q, k, v, plan)
    assert bk.KERNEL.launches == before + 1
    assert got.shape == q.shape
    _attn_close(got, q, k, v, plan, spec, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dims", [(8, 8), (24, 40), (40, 24), (72, 72),
                                  (128, 128), (1, 3)],
                         ids=lambda d: "dk%d-dv%d" % d)
def test_bs_attention_kernel_head_dims(cuda, dims, dtype):
    """Head dims that are not multiples of 16, zero-filled up to the
    MMA's in shared memory; dk = 1 copies element by element."""
    from repro_torch.kernels.blocksparse_attn import kernel as bk
    from repro_torch.kernels.blocksparse_attn.mask import MaskSpec, compile_mask

    spec = MaskSpec("local", block=16, window=40)
    dk, dv = dims
    q, k, v = _qkv(cuda, dtype, sq=200, hq=16, hkv=2, dk=dk, dv=dv, seed=5)
    plan = compile_mask(spec, 200, 200)
    got = bk.bs_attention(q, k, v, plan)
    assert got.shape == (2, 200, 16, dv)
    _attn_close(got, q, k, v, plan, spec, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("tile", [(64, 128), (128, 64), (16, 48), (40, 24)],
                         ids=lambda t: "%dx%d" % t)
def test_bs_attention_kernel_uneven_tiles(cuda, tile, dtype):
    """bq != bk: 64-slot steps that take parts of pairs, or several
    pairs, and k-blocks of 24 (8-byte mask copies)."""
    from repro_torch.kernels.blocksparse_attn import kernel as bk
    from repro_torch.kernels.blocksparse_attn.mask import MaskSpec, compile_mask

    spec = MaskSpec("local", block=64, window=192)
    q, k, v = _qkv(cuda, dtype, sq=300, hq=8, hkv=2, dk=64, seed=6)
    plan = compile_mask(spec, 300, 300, tile)
    assert (plan.bq, plan.bk) == tile
    _attn_close(bk.bs_attention(q, k, v, plan), q, k, v, plan, spec, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bs_attention_kernel_value_dim_scale_and_strides(cuda, dtype):
    """MLA-shaped call (Hq == Hkv, dv != dk, explicit scale) on strided
    views, and GQA 8:1 at the head dims of full-width yi-9b."""
    from repro_torch.kernels.blocksparse_attn import kernel as bk
    from repro_torch.kernels.blocksparse_attn.mask import MaskSpec, compile_mask

    spec = MaskSpec("strided", block=16, stride=2)
    q, k, v = _qkv(cuda, dtype, sq=48, hq=4, hkv=4, dk=24, dv=40, seed=1)
    wide = torch.zeros(2, 48, 4, 64, device=cuda, dtype=dtype)
    wide[..., 8:32] = k
    ks = wide[..., 8:32]  # last dim contiguous, other strides not k's own
    plan = compile_mask(spec, 48, 48)
    got = bk.bs_attention(q, ks, v, plan, 0.17)
    _attn_close(got, q, k, v, plan, spec, dtype, scale=0.17)
    spec = MaskSpec("local", block=64, window=192)
    q, k, v = _qkv(cuda, dtype, b=1, sq=300, hq=8, hkv=1, dk=128, seed=2)
    plan = compile_mask(spec, 300, 300)
    _attn_close(bk.bs_attention(q, k, v, plan), q, k, v, plan, spec, dtype)
    spec = MaskSpec("causal", block=16)  # more keys than queries
    q, _, _ = _qkv(cuda, dtype, sq=40, seed=3)
    _, k, v = _qkv(cuda, dtype, sq=72, seed=4)
    plan = compile_mask(spec, 40, 72)
    _attn_close(bk.bs_attention(q, k, v, plan), q, k, v, plan, spec, dtype)


def test_bs_attention_routes_to_the_kernel_on_cuda(cuda):
    from repro_torch.api import MaskForceError, attention
    from repro_torch.kernels.blocksparse_attn.mask import MaskSpec
    from repro_torch.models.cache import CacheView

    q, k, v = _qkv(cuda, torch.float32, sq=32)
    registry.clear_history()
    attention(q, k, v, mask=MaskSpec("causal", block=32))  # density 1.0
    attention(q, k, v, mask=MaskSpec("local", block=16, window=24),
              policy="off")
    attention(q[:, -1:], k, v, mask=MaskSpec("local", block=16, window=24),
              cache=CacheView.decode(torch.tensor(31)))
    assert registry.dispatch_counts() == {
        ("bs_attention", "cuda_bs_attention", "cuda"): 1,
        ("bs_attention", "masked_reference", "cuda"): 1,
        ("bs_attention_decode", "masked_decode", "cuda"): 1}
    with pytest.raises(MaskForceError):  # misaligned tile: no plan
        attention(q, k, v, mask=MaskSpec("causal", block=16), tile=(12, 12))
    with pytest.raises(MaskForceError, match="no kernel build"):
        attention(q.half(), k.half(), v.half(),
                  mask=MaskSpec("causal", block=16))


def test_masked_reduced_model_matches_the_dense_window(cuda):
    """Reduced yi-9b in f32 with MaskSpec("local", block=8, window=12):
    prefill and decode logits through the kernel equal those of the same
    weights with mask=None, window=12, and greedy streams are equal."""
    import dataclasses

    from repro_torch.kernels.blocksparse_attn.mask import MaskSpec
    from repro_torch.launch.serve import build_model, serve
    from repro_torch.models.cache import CacheView

    spec = MaskSpec("local", block=8, window=12)
    _, lm = build_model("yi-9b", full=False, kernels=True,
                        dtype=torch.float32, seed=1, device=cuda, mask=spec)
    gqa = [layer.mixer for layer in lm.layers]
    masked = [g.cfg for g in gqa]
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, lm.cfg.vocab_size, (2, 16))).to(cuda)

    def run(cfgs):
        for g, c in zip(gqa, cfgs):
            g.cfg = c
        cache = lm.init_cache(2, 32)
        lp, cache = lm(toks, view=CacheView.prefill(), caches=cache)
        ld, _ = lm(lp[:, -1].argmax(-1, keepdim=True),
                   view=CacheView.decode(torch.tensor([16, 16])),
                   caches=cache)
        _, done, _ = serve(lm, requests=3, slots=2, prefill_len=16,
                           max_new=6, max_seq=24)
        return lp, ld, {r.rid: r.out for r in done}

    with torch.inference_mode():
        registry.clear_history()
        mp, md, mstream = run(masked)
        counts = registry.dispatch_counts("bs_attention")
        dp, dd, dstream = run([dataclasses.replace(c, mask=None, window=12)
                               for c in masked])
    assert counts[("bs_attention", "cuda_bs_attention", "cuda")] > 0
    assert ("bs_attention", "masked_reference", "cuda") not in counts
    torch.testing.assert_close(mp, dp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(md, dd, rtol=1e-4, atol=1e-4)
    assert mstream == dstream


# ---------------------------------------------------------------------------
# serving steps captured as CUDA graphs
# ---------------------------------------------------------------------------

GRAPH_LAYOUTS = {  # engine keywords of each step layout
    "slot": {},
    "chunked": dict(prefill_chunk=8),
    "paged": dict(prefill_chunk=8, paged=True, page_size=8),
}


def _graph_model(cuda, quantize, masked):
    from repro_torch.kernels.blocksparse_attn.mask import MaskSpec
    from repro_torch.launch.serve import build_model

    spec = MaskSpec("local", block=8, window=12) if masked else None
    return build_model("yi-9b", full=False, kernels=True,
                       dtype=torch.bfloat16, seed=2, device=cuda,
                       quantize=quantize, mask=spec)[1]


def _step_inputs(layout):
    """A step sequence for two slots that alternates prefill and decode
    (slot 1 admitted a step after slot 0): (kind, inputs) pairs."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 512, (2, 16)).astype(np.int32)
    table = (np.arange(12, dtype=np.int32).reshape(2, 6) + 1
             if layout == "paged" else None)
    t, f = True, False
    steps = []

    def pf(c0, c1, mask):  # chunk starts of each slot
        toks = np.stack([prompt[0, c0:c0 + 8], prompt[1, c1:c1 + 8]])
        steps.append(("prefill", dict(tokens=toks, mask=np.array(mask),
                                      cache_len=np.array([c0, c1], np.int32),
                                      table=table)))

    def dc(l0, l1, mask):
        steps.append(("decode", dict(
            tokens=rng.integers(0, 512, (2, 1)).astype(np.int32),
            cache_len=np.array([l0, l1], np.int32), mask=np.array(mask),
            table=table)))

    if layout == "slot":
        for i, mask in enumerate(([t, f], [f, t])):
            steps.append(("prefill", dict(tokens=prompt,
                                          mask=np.array(mask))))
            dc(16 + i, 0 if i == 0 else 16, [t, f] if i == 0 else [t, t])
        for i in range(3):
            dc(18 + i, 17 + i, [t, t])
        return steps
    pf(0, 0, [t, f])
    pf(8, 0, [t, t])
    dc(16, 0, [t, f])
    pf(0, 8, [f, t])
    for i in range(3):
        dc(17 + i, 16 + i, [t, t])
    return steps


def _run_steps(steps, pair, caches):
    prefill, decode = pair
    outs = []
    with torch.inference_mode():
        for kind, kw in steps:
            out = (prefill if kind == "prefill" else decode)(caches, **kw)
            outs.append(out.clone())
    return outs


def _step_caches(lm, layout):
    return lm.init_cache(13, 8) if layout == "paged" else lm.init_cache(2,
                                                                        48)


@pytest.mark.parametrize("layout", list(GRAPH_LAYOUTS))
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("quantize", [None, "int8"], ids=["bf16", "int8"])
def test_graphed_steps_equal_eager_steps(cuda, quantize, masked, layout):
    """Reduced yi-9b in bf16 (bf16 or int8 weights, with and without a
    local mask; slot, chunked and paged steps): the captured steps' last
    logits and the caches they leave are bit-equal to the same steps run
    eagerly, in a sequence that alternates prefill and decode; one graph
    a step kind; replays add no dispatch and no launch; no reference
    dispatch was captured."""
    from repro_torch.kernels import build
    from repro_torch.serving.engine import make_serve_steps

    lm = _graph_model(cuda, quantize, masked)
    steps = _step_inputs(layout)
    ref = _step_caches(lm, layout)
    eager = _run_steps(steps, make_serve_steps(lm, graphs=False), ref)
    graphed = make_serve_steps(lm)
    caches = _step_caches(lm, layout)
    registry.clear_history()
    got = _run_steps(steps[:2], graphed, caches)
    got += _run_steps(steps[2:3], graphed, caches)
    counts, launches = registry.dispatch_counts(), build.launch_counts()
    got += _run_steps(steps[3:], graphed, caches)
    assert registry.dispatch_counts() == counts  # replays only
    assert build.launch_counts() == launches
    for a, b in zip(got, eager):
        assert torch.equal(a, b)
    for lg, le in zip(caches, ref):
        for name in ("k", "v"):
            assert torch.equal(lg[name], le[name])
    assert [len(s.built) for s in graphed] == [1, 1]
    for step in graphed:
        rec, = step.captured
        assert rec.replays >= 1 and sum(rec.launches.values()) > 0
        assert not [k for k in rec.dispatches
                    if "reference" in k[1]], rec.dispatches
    assert not [k for k in counts if "reference" in k[1]], counts


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("quantize", [None, "int8"], ids=["bf16", "int8"])
def test_graphed_engines_equal_eager_engines(cuda, quantize, masked):
    """Three graphed engines (slot, chunked, paged) built one after the
    other and run in turns give the greedy streams of the same engines
    run eagerly; each keeps one graph a step kind."""
    from repro_torch.serving.engine import Request, ServeEngine

    lm = _graph_model(cuda, quantize, masked)
    rng = np.random.default_rng(8)
    prompts = rng.integers(0, 512, (5, 16)).astype(np.int32)
    prompts[2:, :8] = prompts[0, :8]

    def make(graphs):
        return {name: ServeEngine(lm, slots=2, max_seq=48, prefill_len=16,
                                  graphs=graphs, **kw)
                for name, kw in GRAPH_LAYOUTS.items()}

    def run(engines, rounds=2):
        out = {name: {} for name in engines}
        with torch.inference_mode():
            for r in range(rounds):
                for name, eng in engines.items():
                    for i, p in enumerate(prompts):
                        eng.submit(Request(rid=10 * r + i, prompt=p,
                                           max_new=3 + i))
                    out[name].update({q.rid: q.out for q in eng.run()})
        return out

    graphed = make(True)
    got, want = run(graphed), run(make(False))
    assert got == want
    # the same chunk-mode steps over equal cache views, prefix hits or not
    assert got["chunked"] == got["paged"]
    for eng in graphed.values():
        assert eng.compiled_cache_sizes() == {"prefill": 1, "decode": 1}
        assert all(rec.replays > 0 for recs in eng.captured().values()
                   for rec in recs)


def test_capture_failure_raises(cuda):
    """A step that syncs with the host cannot be captured: the step
    raises, and does not fall back to eager."""
    from repro_torch.serving.engine import StepGraph

    step = StepGraph(lambda caches, x: x * float(x.sum()), device=cuda)
    with torch.inference_mode():
        x = np.ones(4, np.float32)
        with pytest.raises(RuntimeError):
            step(None, x=x)
    assert step.captured == []


# ---------------------------------------------------------------------------
# the CNN forward as a graph; tuned launches; the fp8 cache; obs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("cnn", ["resnet50", "densenet121"])
def test_graphed_cnn_equals_eager(cuda, cnn, quantize):
    """``SparseCNN.graphed``: replayed logits bit-equal to the eager
    forward's (the same kernels at the same launches), for new inputs of
    the same signature too; the graph holds one compressed-GEMM dispatch
    per compressed conv and no reference; a new batch size captures a
    second graph."""
    import dataclasses

    from repro_torch.configs import get_cnn_reduced
    from repro_torch.models.conv import SparseCNN

    cfg = get_cnn_reduced(cnn)
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, use_kernel=True))
    model = SparseCNN.init(cfg, device=cuda, quantize=quantize)
    gen = torch.Generator(device=cuda).manual_seed(1)
    xs = [torch.randn(2, 32, 32, 3, device=cuda, generator=gen)
          for _ in range(3)]
    with torch.inference_mode():
        eager = [model(x) for x in xs]
        got = [model.graphed(x).clone() for x in xs]
        other = model.graphed(torch.randn(3, 32, 32, 3, device=cuda))
    for a, b in zip(got, eager):
        assert torch.equal(a, b)
    assert other.shape == (3, cfg.num_classes)
    fam = ("nm_matmul_q", "nm_spmm_q") if quantize else ("nm_matmul",
                                                         "nm_spmm")
    sparse = sum(c.nm is not None for c in model.convs.values())
    recs = model.graphs_captured()
    assert len(recs) == 2 and recs[0].replays == 2
    for rec in recs:
        assert rec.dispatches == {(*fam, "cuda"): sparse}
        assert rec.launches == {fam[1]: sparse}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_tuned_launches_equal_the_rules_output(cuda, dtype, tmp_path,
                                               monkeypatch):
    """A prefill and a decode sweep on the card: every candidate's output
    equals the rule's on the lattice (the sweep raises otherwise), the
    winner is stored, and nm_matmul then launches it."""
    from repro_torch.kernels import autotune

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "at.json"))
    autotune.clear_memory_cache()
    cfg = NMConfig(2, 4)
    k, n = 1024, 512
    try:
        for m, family in ((512, "prefill"), (4, "decode")):
            s = autotune.sweep(m, n, k, cfg, dtype, repeats=3, family=family,
                               x_dtype=torch.bfloat16, device=cuda)
            assert s.rule in s.times and len(s.times) >= 2
            assert autotune.store(s) == s.best
            x, vals, idx, _ = _operands(m, k, n, cfg, torch.bfloat16, cuda)
            w = NMWeight(vals, idx, cfg, kernel_policy=KernelPolicy("auto"))
            if dtype == torch.int8:
                w = quantize_nm(w)
            registry.clear_history()
            nm_matmul(x, w)
            rec = registry.last_dispatch()
            assert rec.block == s.best and "reference" not in rec.impl
    finally:
        autotune.clear_memory_cache()


def test_fp8_paged_write_and_gather_on_the_card(cuda):
    """The fp8 pool on the card: a paged write through the block table
    and the gather give each slot's rows cast to e4m3, bit for bit, as
    the CPU does; the slot cache's masked write keeps the other slot."""
    from repro_torch.models.attention import _write_cache, paged_gather, \
        paged_write

    fp8 = torch.float8_e4m3fn
    gen = torch.Generator(device=cuda).manual_seed(0)
    pool = torch.zeros(9, 4, 2, 8, dtype=fp8, device=cuda)
    new = torch.randn(2, 3, 2, 8, device=cuda, generator=gen)
    table = torch.tensor([[3, 5, 0], [7, 2, 0]], dtype=torch.int32,
                         device=cuda)
    cache_len = torch.tensor([2, 4], device=cuda)
    paged_write(pool, new, cache_len, table,
                torch.tensor([True, True], device=cuda))
    view = paged_gather(pool, table)
    cpu_pool = pool.cpu()
    assert view.dtype == fp8
    for b in range(2):
        c0 = int(cache_len[b])
        assert torch.equal(view[b, c0:c0 + 3].view(torch.uint8),
                           new[b].to(fp8).view(torch.uint8))
    assert torch.equal(paged_gather(cpu_pool, table.cpu()).view(torch.uint8),
                       view.cpu().view(torch.uint8))
    slot = torch.zeros(2, 8, 2, 8, dtype=fp8, device=cuda)
    rows = torch.arange(2, device=cuda)
    cols = torch.arange(3, device=cuda).expand(2, 3)
    _write_cache(slot, new, (rows, cols,
                             torch.tensor([True, False], device=cuda)))
    assert torch.equal(slot[0, :3].view(torch.uint8),
                       new[0].to(fp8).view(torch.uint8))
    assert int(slot[1].view(torch.uint8).abs().sum()) == 0


def test_obs_on_serve_parity_on_the_card(cuda):
    """A graphed, paged serve with observability on gives the streams of
    the same serve with it off and one graph a step kind; its
    ``kernel_dispatch_total`` equals what ran (``ran_counts``)."""
    import repro_torch.obs as obs
    from repro_torch.serving.engine import Request, ServeEngine, ran_counts

    lm = _graph_model(cuda, None, False)
    rng = np.random.default_rng(8)
    prompts = rng.integers(0, 512, (4, 16)).astype(np.int32)

    def serve():
        eng = ServeEngine(lm, slots=2, max_seq=48, prefill_len=16,
                          prefill_chunk=8, paged=True, page_size=8)
        with torch.inference_mode():
            for i, p in enumerate(prompts):
                eng.submit(Request(rid=i, prompt=p, max_new=5))
            return eng, {r.rid: r.out for r in eng.run()}

    obs.reset_for_tests()
    try:
        _, off = serve()
        bundle = obs.enable(obs.Obs.create())
        registry.clear_history()
        eng, on = serve()
        counts, _ = ran_counts(eng, registry.dispatch_counts(), {})
    finally:
        obs.reset_for_tests()
    assert on == off
    assert eng.compiled_cache_sizes() == {"prefill": 1, "decode": 1}
    metric = {k: bundle.metrics.counter_value(
        "kernel_dispatch_total", op=k[0], impl=k[1], backend=k[2])
        for k in counts}
    assert metric == {k: float(v) for k, v in counts.items()}


# ---------------------------------------------------------------------------
# MLA and MoE: bs_attention at dk 192 / dv 128, reduced deepseek
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads", [(16, 16), (16, 8)], ids=["mla", "gqa2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("spec_i", [0, 1, 5])
def test_bs_attention_kernel_mla_head_dims(cuda, spec_i, dtype, heads):
    """dk 192 / dv 128 (the bf16 kernel's <192, 128> instantiation, G' = 1
    at Hq = Hkv and 2 at a GQA ratio of 2; the f32 kernel's larger shared
    memory) against masked_reference and the bf16 twin, scale 192^-0.5;
    also dk 136 (zero-filled to 192) with dv 72."""
    from repro_torch.kernels.blocksparse_attn import kernel as bk
    from repro_torch.kernels.blocksparse_attn.mask import compile_mask

    spec = _attn_specs()[spec_i]
    for dk, dv in ((192, 128), (136, 72)):
        q, k, v = _qkv(cuda, dtype, sq=200, hq=heads[0], hkv=heads[1],
                       dk=dk, dv=dv, seed=9)
        plan = compile_mask(spec, 200, 200)
        before = bk.KERNEL.launches
        got = bk.bs_attention(q, k, v, plan)
        assert bk.KERNEL.launches == before + 1
        assert got.shape == (2, 200, heads[0], dv)
        _attn_close(got, q, k, v, plan, spec, dtype)


def test_bs_attention_mla_occupancy_and_limits(cuda):
    """The <192, 128> kernel's shared memory is the host's layout (q tiles
    at 200-element rows, two stages of K, V and the mask tile), the f32
    kernel fits dk 192 in 227 KB; dk 193 or dv 129 is refused."""
    from repro_torch.kernels.blocksparse_attn import kernel as bk
    from repro_torch.kernels.blocksparse_attn.mask import MaskSpec, compile_mask

    for g in (1, 2):
        o = bk.occupancy(torch.bfloat16, g, 192, 128)
        assert o["smem_bytes"] == 2 * g * 64 * 200 + 2 * (
            2 * 64 * (200 + 136) + 64 * 80)
        assert o["threads"] == 128 * g and o["ctas_per_sm"] >= 1
    o = bk.occupancy(torch.float32, 1, 192, 128)
    assert o["smem_bytes"] == 152576 and o["ctas_per_sm"] >= 1
    spec = MaskSpec("causal", block=16)
    plan = compile_mask(spec, 32, 32)
    for dk, dv in ((193, 128), (192, 129)):
        q, k, v = _qkv(cuda, torch.bfloat16, sq=32, dk=dk, dv=dv)
        with pytest.raises(ValueError, match="dk up to 192"):
            bk.bs_attention(q, k, v, plan)


def _deepseek(cuda, dtype=torch.float32, quantize=None, seed=3):
    from repro_torch.launch.serve import build_model

    return build_model("deepseek-v2-lite-16b", full=False, kernels=True,
                       dtype=dtype, seed=seed, device=cuda,
                       quantize=quantize)[1]


def _set_policy(module, mode):
    from repro_torch.core.nmweight import KernelPolicy
    from repro_torch.models.common import Linear

    for mod in module.modules():
        if isinstance(mod, Linear) and mod.nm is not None:
            mod.kernel_policy = KernelPolicy(mode)


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["f32", "int8"])
def test_moe_layer_through_the_kernels(cuda, quantize):
    """One MoE layer of reduced deepseek in f32 at prefill (capacity 16:
    the prefill kernel) and decode (capacity 8: the decode kernel) shapes:
    the kernels against the reference on the same weights (1e-4), equal
    aux loss, every expert's three GEMMs launched once a call."""
    from repro_torch.kernels import build
    from repro_torch.models.moe import MoE

    lm = _deepseek(cuda, quantize=quantize)
    moe = lm.layers[1].mlp
    assert isinstance(moe, MoE)
    rng = np.random.default_rng(4)
    for t in (32, 2):
        x = torch.from_numpy(rng.standard_normal((1, t, 128)).astype(
            np.float32)).to(cuda)
        _set_policy(moe, "auto")
        before = sum(build.launch_counts().values())
        with torch.inference_mode():
            y, aux = moe(x)
        torch.cuda.synchronize()
        launched = sum(build.launch_counts().values()) - before
        assert launched == 3 * (moe.cfg.n_experts + 1)
        _set_policy(moe, "off")
        with torch.inference_mode():
            y_ref, aux_ref = moe(x)
        _close(y, y_ref, torch.float32)
        assert float(aux) == float(aux_ref)


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["f32", "int8"])
def test_reduced_deepseek_through_the_kernels(cuda, quantize):
    """Reduced deepseek (MLA + MoE) in f32: prefill and decode logits
    through the kernels against the reference (1e-4), no reference
    dispatch while the kernels serve."""
    from repro_torch.models.cache import CacheView

    lm = _deepseek(cuda, quantize=quantize)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, 512, (2, 16))).to(cuda)

    def two_steps():
        with torch.inference_mode():
            caches = lm.init_cache(2, 32)
            lp, caches = lm(toks, view=CacheView.prefill(), caches=caches)
            ld, _ = lm(lp[:, -1:].argmax(-1), caches=caches,
                       view=CacheView.decode(torch.tensor([16, 16])))
        return lp, ld

    registry.clear_history()
    got = two_steps()
    counts = registry.dispatch_counts()
    assert not [k for k in counts if "reference" in k[1]], counts
    _set_policy(lm, "off")
    want = two_steps()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        _close(a, b, torch.float32)


def test_graphed_deepseek_decode_equals_eager(cuda):
    """Reduced deepseek in bf16: a captured prefill and decode (the MoE
    dispatch inside the graph), replayed, give the eager steps' logits and
    caches bit for bit; the decode graph holds one decode-kernel launch a
    compressed Linear."""
    from repro_torch.models.common import Linear
    from repro_torch.serving.engine import make_serve_steps

    lm = _deepseek(cuda, dtype=torch.bfloat16)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 512, (2, 16)).astype(np.int32)
    mask = np.array([True, True])

    def run(pair, caches):
        prefill, decode = pair
        outs = []
        with torch.inference_mode():
            outs.append(prefill(caches, tokens=prompt, mask=mask).clone())
            for i in range(3):
                tok = rng.integers(0, 512, (2, 1)).astype(np.int32)
                outs.append(decode(caches, tokens=tok, mask=mask,
                                   cache_len=np.full(2, 16 + i,
                                                     np.int32)).clone())
        return outs

    seed = rng.bit_generator.state
    eager_caches = lm.init_cache(2, 32)
    eager = run(make_serve_steps(lm, graphs=False), eager_caches)
    rng.bit_generator.state = seed
    graphed = make_serve_steps(lm)
    caches = lm.init_cache(2, 32)
    got = run(graphed, caches)
    for a, b in zip(got, eager):
        assert torch.equal(a, b)
    for lg, le in zip(caches, eager_caches):
        for name in ("ckv", "kr"):
            assert torch.equal(lg[name], le[name])
    linears = sum(1 for m in lm.modules()
                  if isinstance(m, Linear) and m.nm is not None)
    rec, = graphed[1].captured
    assert rec.replays == 2
    assert rec.launches == {"nm_spmm_decode": linears}


# ---------------------------------------------------------------------------
# training: autograd through the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", [None, "silu"], ids=["none", "bias-silu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("m", [64, 4], ids=["prefill", "decode"])
def test_autograd_through_the_kernels_matches_the_plain_version(
        cuda, m, dtype, act):
    """nm_spmm (M = 64) and nm_spmm_decode (M = 4) under autograd: y
    within TOL of the plain version's and, since the backward is the
    same f32 composition from the same x and weights, dx, dvals and
    dbias equal to it (1e-6: cuBLAS may pick another algorithm)."""
    cfg = NMConfig(2, 4)
    x, vals, idx, bias = _operands(m, 256, 192, cfg, dtype, cuda)
    r = torch.randn(m, 192, device=cuda)
    out = {}
    for mode in ("auto", "off"):
        xr = x.clone().requires_grad_(True)
        vr = vals.float().clone().requires_grad_(True)  # f32 storage
        br = bias.clone().requires_grad_(True) if act else None
        w = NMWeight(vr, idx, cfg, 0, KernelPolicy(mode))
        registry.clear_history()
        y = nm_matmul(xr, w, epilogue=Epilogue(bias=br, activation=act)
                      if act else None)
        (y.float() * r).sum().backward()
        fam = "nm_matmul" if m > 8 else "nm_matmul_decode"
        impl = (("nm_spmm" if m > 8 else "nm_spmm_decode") if mode == "auto"
                else ("reference" if m > 8 else "reference_decode"))
        assert registry.dispatch_counts(fam) == {(fam, impl, "cuda"): 1}
        out[mode] = (y, xr.grad, vr.grad) + ((br.grad,) if act else ())
    _close(out["auto"][0], out["off"][0], dtype)
    assert out["auto"][1].dtype == dtype and out["auto"][2].dtype == \
        torch.float32
    for got, want in zip(out["auto"][1:], out["off"][1:]):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_a_train_step_on_the_card(cuda):
    """Reduced yi-9b, f32 weights and bf16 compute: three steps through
    the kernels, finite losses, one nm_spmm dispatch a compressed Linear
    a forward and no reference; int8 weights refuse to train."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.models.transformer import LM
    from repro_torch.training.train_loop import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    import dataclasses

    cfg = get_reduced("yi-9b")
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, use_kernel=True))
    lm = LM.init(cfg, dtype=torch.float32, device=cuda).set_compute_dtype(
        torch.bfloat16)
    tc = TrainConfig(remat="none")
    lm, opt = init_train_state(lm, tc)
    step = make_train_step(lm, tc)
    pipe = DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                       global_batch=4))
    registry.clear_history()
    for _ in range(3):
        lm, opt, metrics = step(lm, opt, pipe.next())
        assert np.isfinite(float(metrics["loss"]))
    assert registry.dispatch_counts() == {
        ("nm_matmul", "nm_spmm", "cuda"): 3 * 14}
    q = quantize_nm(lm.layers[0].mlp.w_up.weight)
    with pytest.raises(RuntimeError, match="inference only"):
        nm_matmul(torch.randn(16, 128, device=cuda, requires_grad=True), q)


# ---------------------------------------------------------------------------
# the recurrent models: their GEMM shapes, a graphed rwkv serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("m", [512, 4], ids=["prefill", "decode"])
@pytest.mark.parametrize("kn", [(8192, 288), (8960, 2560)],
                         ids=["jamba-w_x", "rwkv-w_cm_v"])
def test_recurrent_shapes_match_plain(cuda, kn, m, quantized):
    """Rows 1-4 at jamba's w_x (N = 288, ragged against every tile) and
    rwkv6-3b's channel-mix w_cm_v (K = 8960): bf16 x, bf16 or int8
    values, decode with and without bias + SiLU; prefill on the sparse
    path."""
    k, n = kn
    cfg = NMConfig(2, 4)
    dt = torch.bfloat16
    if quantized:
        x, vals, idx, scales, bias = _q_operands(m, k, n, cfg, dt, cuda)
        w = (vals, idx, scales)
    else:
        x, vals, idx, bias = _operands(m, k, n, cfg, dt, cuda)
        w = (vals, idx)
    sfx = "_q" if quantized else ""
    if m > 8:
        run = getattr(kernel, "nm_spmm" + sfx)
        plain = getattr(kernel, "nm_spmm" + sfx + "_plain")
        kern = kernel.KERNEL_Q if quantized else kernel.KERNEL
        y = _launched(kern, "sparse", lambda: run(x, *w, cfg))
        assert y.shape == (m, n)
        _close(y, plain(x, *w, cfg), dt)
        return
    run = getattr(decode_kernel, "nm_spmm_decode" + sfx)
    plain = getattr(decode_kernel, "nm_spmm_decode" + sfx + "_plain")
    for b, act in ((None, None), (bias, "silu")):
        y = run(x, *w, b, cfg, act)
        assert y.shape == (m, n)
        _close(y, plain(x, *w, b, cfg, act), dt)
        assert torch.equal(y, run(x, *w, b, cfg, act))


def test_graphed_rwkv_serve_equals_eager_and_alone(cuda):
    """Reduced rwkv6-3b in bf16 through the kernels: the graphed engine's
    greedy streams equal the eager engine's, one graph a step kind, no
    reference dispatch; with slots reused, each stream equals the
    request's served alone (the prefill zeroes the slot's state inside
    the captured step)."""
    from repro_torch.launch.serve import build_model, serve

    _, lm = build_model("rwkv6-3b", full=False, kernels=True,
                        dtype=torch.bfloat16, device=cuda)
    kw = dict(slots=2, prefill_len=8, max_new=6, max_seq=16)
    registry.clear_history()
    eng, done, _ = serve(lm, requests=5, **kw)
    assert not [k for k in registry.dispatch_counts()
                if k[1].startswith("reference")]
    assert eng.compiled_cache_sizes() == {"prefill": 1, "decode": 1}
    got = {r.rid: r.out for r in done}
    _, eager, _ = serve(lm, requests=5, graphs=False, **kw)
    assert {r.rid: r.out for r in eager} == got
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, lm.cfg.vocab_size, size=(5, 8)).astype(
        np.int32)
    from repro_torch.serving.engine import Request, ServeEngine

    for i, p in enumerate(prompts):
        alone = ServeEngine(lm, slots=2, max_seq=16, prefill_len=8)
        alone.submit(Request(rid=i, prompt=p, max_new=6))
        assert alone.run()[0].out == got[i], i


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("m", [1, 4])
def test_geglu_gelu_epilogue_at_gemma3_shape(cuda, m, quantized):
    """GeGLU's gate: the decode kernels' fused tanh-form gelu (activation
    code 2) at gemma3-27b's w_gate (5376 x 21504), bf16 x, bf16 or int8
    values, with and without bias, against the plain version (1e-2);
    two calls bit-identical."""
    k, n = 5376, 21504
    cfg, dt = NMConfig(2, 4), torch.bfloat16
    if quantized:
        x, vals, idx, scales, bias = _q_operands(m, k, n, cfg, dt, cuda)
        w = (vals, idx, scales)
    else:
        x, vals, idx, bias = _operands(m, k, n, cfg, dt, cuda)
        w = (vals, idx)
    sfx = "_q" if quantized else ""
    run = getattr(decode_kernel, "nm_spmm_decode" + sfx)
    plain = getattr(decode_kernel, "nm_spmm_decode" + sfx + "_plain")
    for b in (None, bias):
        y = run(x, *w, b, cfg, "gelu")
        assert y.shape == (m, n) and y.dtype == dt
        _close(y, plain(x, *w, b, cfg, "gelu"), dt)
        assert torch.equal(y, run(x, *w, b, cfg, "gelu"))


def test_graphed_whisper_prefill_replays_new_frames(cuda):
    """Reduced whisper-medium in bf16 through the kernels: the prefill of
    ``make_serve_steps`` captured with one set of frames and replayed
    with another gives the eager step's logits on those frames (1e-2;
    the same kernels in the same order, so equal in practice), one graph,
    no reference dispatch captured; a decode step after it reads the
    cross K/V the replay wrote."""
    from repro_torch.launch.serve import build_model, encdec_inputs
    from repro_torch.serving.engine import make_serve_steps

    _, lm = build_model("whisper-medium", full=False, kernels=True,
                        dtype=torch.bfloat16, device=cuda)
    (toks, enc), (toks2, enc2) = (encdec_inputs(lm, slots=2, prefill_len=8,
                                                seed=s) for s in (1, 2))
    graphed, eager = make_serve_steps(lm), make_serve_steps(lm, graphs=False)
    caches = lm.init_cache(2, 12)
    ref_caches = lm.init_cache(2, 12)
    with torch.inference_mode():
        graphed[0](caches, tokens=toks, enc_input=enc)  # captures
        got = graphed[0](caches, tokens=toks2, enc_input=enc2).clone()
        want = eager[0](ref_caches, tokens=toks2, enc_input=enc2)
        _close(got, want, torch.bfloat16)
        nxt = want.argmax(-1, keepdim=True)
        lens = np.full(2, 8)
        _close(graphed[1](caches, tokens=nxt, cache_len=lens),
               eager[1](ref_caches, tokens=nxt, cache_len=lens),
               torch.bfloat16)
    assert len(graphed[0].built) == 1
    rec, = graphed[0].captured
    assert rec.replays == 1
    assert not [k for k in rec.dispatches if "reference" in k[1]]
    assert rec.launches == {"nm_spmm": 2 * 6 + 2 * 10}


def test_sharded_serve_on_two_gloo_ranks_sharing_the_card(cuda):
    """Reduced yi-9b through the kernels (f32) on a 1x2 mesh of gloo
    ranks sharing the card: the streams of every rank equal the
    single-card engine's, every compressed GEMM launched its kernel at
    the shard's shapes (no reference dispatch)."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.sharded import serve_rank
    from repro_torch.models.transformer import LM
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = get_reduced("yi-9b")
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, use_kernel=True))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
               for _ in range(5)]
    max_new = [4 + i for i in range(5)]
    kw = dict(slots=2, max_seq=64, prefill_len=8)
    lm = LM.init(cfg, seed=0, dtype=torch.float32, device=cuda)
    eng = ServeEngine(lm, graphs=False, **kw)
    for i, (p, n) in enumerate(zip(prompts, max_new)):
        eng.submit(Request(rid=i, prompt=p, max_new=n))
    single = {r.rid: list(map(int, r.out)) for r in eng.run()}
    del eng, lm
    torch.cuda.empty_cache()
    case = dict(cfg=cfg, seed=0, dtype=torch.float32, shard_init=True,
                engine=kw, prompts=prompts, max_new=max_new)
    res = mesh_mod.spawn(serve_rank, 1, 2, backend="gloo", device="cuda",
                         timeout_s=300, args=([case],))
    for r in res:
        got = r[0]
        assert got["streams"] == single
        ref = {k: v for k, v in got["counts"]["dispatches"].items()
               if "reference" in k[1]}
        assert not ref, ref
        launched = sum(got["counts"]["launches"][k] for k in
                       ("nm_spmm", "nm_spmm_decode"))
        calls = sum(got["step_calls"].values())
        assert launched == got["linears"] * calls


def test_sharded_train_step_on_two_gloo_ranks_sharing_the_card(cuda):
    """Reduced yi-9b through the kernels, f32 weights and compute, three
    steps on a 2x1 mesh of gloo ranks sharing the card (fsdp: each rank
    stores half of each split tensor) against the single process on the
    same weights and batches: loss and grad_norm within 1e-5, every
    parameter, assembled from the ranks' slices, within 2e-5; one
    nm_spmm launch a compressed Linear a forward on each rank."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.sharded import train_rank
    from repro_torch.models.transformer import LM
    from repro_torch.optim.optimizer import AdamWConfig
    from repro_torch.training.train_loop import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    cfg = get_reduced("yi-9b")
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, use_kernel=True))
    tc = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=10), remat="none")
    pipe_kw = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    lm = LM.init(cfg, seed=0, dtype=torch.float32, device=cuda)
    lm, opt = init_train_state(lm, tc)
    step = make_train_step(lm, tc)
    pipe = DataPipeline(PipelineConfig(**pipe_kw))
    want = []
    for _ in range(3):
        lm, opt, m = step(lm, opt, pipe.next())
        want.append({k: float(v) for k, v in m.items()})
    params = {n: p.detach().cpu().numpy() for n, p in lm.named_parameters()}
    del lm, opt
    torch.cuda.empty_cache()
    case = dict(cfg=cfg, seed=0, compute="f32", mode="fsdp", tcfg=tc,
                pipeline=pipe_kw, steps=3, state=(3,))
    res = [r[0] for r in mesh_mod.spawn(
        train_rank, 2, 1, backend="gloo", device="cuda", timeout_s=300,
        args=([case],))]
    whole = {n: np.zeros_like(a) for n, a in params.items()}
    for r in res:
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose([m[key] for m in r["metrics"]],
                                       [m[key] for m in want], rtol=1e-5)
        for n, (arr, region) in r["states"][3]["params"].items():
            whole[n][region.index] = arr
        assert not {k: v for k, v in r["dispatches"].items()
                    if "reference" in k[1]}
        assert r["launches"]["nm_spmm"] == r["linears"] * 3
    for n, a in params.items():
        np.testing.assert_allclose(whole[n], a, rtol=0, atol=2e-5,
                                   err_msg=n)


def test_sharded_moe_on_the_card_outside_a_mesh_raises(cuda):
    from repro_torch.configs.base import MoEConfig, SparsityConfig
    from repro_torch.models.moe import MoE

    gen = torch.Generator(device=cuda).manual_seed(0)
    cfg = MoEConfig(n_experts=8, top_k=2, d_expert=64, n_shared=1)
    moe = MoE.init(gen, 64, cfg, sp=SparsityConfig(use_kernel=True),
                   dtype=torch.bfloat16, experts=(0, 2))
    x = torch.randn(2, 8, 64, device=cuda, dtype=torch.bfloat16)
    with torch.inference_mode(), pytest.raises(RuntimeError,
                                               match="never as a partial"):
        moe(x)
