"""The design of the Hopper prefill kernels (``nm_spmm``, ``nm_spmm_q``),
checked where the CPU can reach it.

* The sparse path's canonical form of every group of four
  (``ref.canonical_groups``) keeps the weight: held against the JAX
  package's ``decompress_nm`` on ``compress_nm`` / ``pad_compressed_kn``
  outputs (short blocks, all-zero blocks, repeated indices, 1:4, int8),
  bit-equal in f32, and every group it emits holds two distinct ascending
  indices, the only form ``mma.sp`` takes.
* The dense path's f32 product on TF32 tensor cores
  (``ref.matmul_3xtf32``): with the three-product split it stays within
  1e-4 of an f64 product at K = 576 and K = 11008 (the CNN and yi-9b
  depths), the tolerance ``chip_smoke.py`` holds the f32 kernels to; one
  TF32 pass does not, which is why the kernel takes three.
* ``padding.prefill_path`` / ``prefill_tile`` / ``prefill_block`` over
  the yi-9b, ResNet-50 and DenseNet-121 GEMMs, and the dispatch record;
  every accepted pattern gets a tile whose shared memory fits the card.
"""
import numpy as np
import pytest
import torch

from repro.core import sparsity as jsp
from repro_torch.configs import get_cnn_config, get_config
from repro_torch.core.nmweight import KernelPolicy, NMWeight
from repro_torch.core.sparsity import NMConfig, decompress_nm
from repro_torch.kernels import padding
from repro_torch.kernels.indexmac.ops import explain_dispatch
from repro_torch.kernels.indexmac.ref import (
    canonical_groups,
    matmul_3xtf32,
    tf32_round,
)
from repro_torch.models.conv import cnn_layer_gemms
from repro_torch.quant import quantize_nm

PATTERNS = [(2, 4), (1, 4)]


def _jax_pairs(k, n, nm, seed, *, zeros=0.7, repeat=0.1, pad=8):
    """Compressed pairs of a mostly-zero weight from the JAX package:
    short blocks padded at their first zero positions ([0, 0, 3, 0] gives
    idx [2, 0]), all-zero blocks, index pairs repeated with non-zero
    values, and ``pad`` zero m-blocks appended by pad_compressed_kn (index
    0 repeated) plus 3 zero columns."""
    cfg = jsp.NMConfig(*nm)
    rng = np.random.default_rng(seed)
    w = (rng.integers(1, 9, (k, n)) * rng.choice([-1, 1], (k, n)))
    w = np.where(rng.random((k, n)) < zeros, 0, w).astype(np.float32)
    w[:, :2] = 0  # whole columns of all-zero blocks
    w = np.asarray(jsp.apply_mask(w, jsp.prune_mask_nm(w, cfg)))
    vals, idx = (np.asarray(a) for a in jsp.compress_nm(w, cfg))
    if cfg.n > 1:  # the second entry of some blocks repeats the first's
        rep = rng.random(vals.shape) < repeat
        second = (np.arange(vals.shape[0]) % cfg.n == 1)[:, None]
        idx = np.where(rep & second, np.roll(idx, 1, 0), idx)
    vals, idx = jsp.pad_compressed_kn(vals, idx, kc_pad=vals.shape[0]
                                      + pad * cfg.n, n_pad=n + 3)
    return np.array(vals), np.array(idx), cfg


def _check_canonical(cv, ci):
    lo, hi = ci.reshape(-1, 2, ci.shape[1]).long().unbind(1)
    assert bool(((lo >= 0) & (lo < hi) & (hi < 4)).all())
    assert cv.shape == ci.shape


@pytest.mark.parametrize("nm", PATTERNS, ids=lambda p: "%d:%d" % p)
@pytest.mark.parametrize("seed", [0, 1])
def test_canonical_groups_keep_the_weight_f32(nm, seed):
    vals, idx, jcfg = _jax_pairs(96, 40, nm, seed)
    want = np.asarray(jsp.decompress_nm(vals, idx, jcfg))
    cfg = NMConfig(*nm)
    cv, ci = canonical_groups(torch.tensor(vals), torch.tensor(idx), cfg)
    _check_canonical(cv, ci)
    assert cv.dtype == torch.float32
    got = decompress_nm(cv, ci, NMConfig(2, 4))
    np.testing.assert_array_equal(got.numpy(), want)
    # the forms that need canonicalizing are all present in the input
    i = torch.from_numpy(idx).long().reshape(-1, cfg.n, idx.shape[1])
    if cfg.n == 2:
        assert bool((i[:, 0] > i[:, 1]).any())   # e.g. [0, 0, 3, 0] -> [2, 0]
        assert bool((i[:, 0] == i[:, 1]).any())  # repeats and padding
        v = torch.from_numpy(vals).reshape(i.shape)
        assert bool(((i[:, 0] == i[:, 1]) & (v != 0).all(1)).any())


@pytest.mark.parametrize("nm", PATTERNS, ids=lambda p: "%d:%d" % p)
def test_canonical_groups_keep_the_weight_int8(nm):
    vals, idx, jcfg = _jax_pairs(128, 24, nm, seed=2)
    q = vals.astype(np.int8)  # small integers: exact in int8 and in bf16
    want = np.asarray(jsp.decompress_nm(q, idx, jcfg)).astype(np.float32)
    cv, ci = canonical_groups(torch.from_numpy(q), torch.from_numpy(idx),
                              NMConfig(*nm))
    _check_canonical(cv, ci)
    assert cv.dtype == torch.bfloat16
    got = decompress_nm(cv.float(), ci, NMConfig(2, 4))
    np.testing.assert_array_equal(got.numpy(), want)


def test_canonical_groups_round_a_bf16_sum_once():
    """Two non-zero bf16 values at one index add in f32 and round once,
    as the port's decompress_nm does (and as the kernel does)."""
    vals = torch.tensor([[1.0], [2.0 ** -8]], dtype=torch.bfloat16)
    idx = torch.tensor([[3], [3]], dtype=torch.int8)
    cv, ci = canonical_groups(vals, idx, NMConfig(2, 4))
    assert ci.flatten().tolist() == [0, 3]
    want = decompress_nm(vals, idx, NMConfig(2, 4))
    assert torch.equal(decompress_nm(cv, ci, NMConfig(2, 4)), want)
    # a random bf16 weight with repeats, against the port's decompress
    vals, idx, _ = _jax_pairs(64, 16, (2, 4), seed=3)
    rng = np.random.default_rng(3)
    vb = torch.from_numpy(vals * rng.standard_normal(vals.shape)
                          .astype(np.float32)).to(torch.bfloat16)
    cv, ci = canonical_groups(vb, torch.from_numpy(idx), NMConfig(2, 4))
    assert torch.equal(decompress_nm(cv, ci, NMConfig(2, 4)),
                       decompress_nm(vb, torch.from_numpy(idx),
                                     NMConfig(2, 4)))


def test_canonical_groups_refuse_other_patterns():
    with pytest.raises(ValueError, match="4:8"):
        canonical_groups(torch.zeros(4, 2),
                         torch.zeros(4, 2, dtype=torch.int8), NMConfig(4, 8))


def test_tf32_round_is_rna():
    one = 1.0
    half_ulp = 2.0 ** -11  # TF32 keeps 10 mantissa bits
    x = torch.tensor([one + half_ulp, -(one + half_ulp), one + half_ulp / 2,
                      one + 3 * half_ulp, 0.0, -0.0])
    want = torch.tensor([one + 2 * half_ulp, -(one + 2 * half_ulp), one,
                         one + 4 * half_ulp, 0.0, -0.0])
    assert torch.equal(tf32_round(x), want)


@pytest.mark.parametrize("k", [576, 11008])
def test_3xtf32_split_meets_the_f32_tolerance(k):
    """Inputs as chip_smoke.py draws them: x ~ N(0, 1), a 2:4 weight from
    N(0, 1/K). Tolerance 1e-4 absolute, the one chip_smoke.py and the GPU
    tests hold an f32 kernel to against its plain f32 version (outputs are
    of order 1); the f64 product stands for the exact one. The split's
    error is near 2^-22 relative, one pass's near 2^-11."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((16, k)).astype(np.float32))
    w = rng.standard_normal((k, 48)).astype(np.float32) * k ** -0.5
    w = torch.tensor(np.asarray(
        jsp.apply_mask(w, jsp.prune_mask_nm(w, jsp.NMConfig()))))
    exact = x.double() @ w.double()
    three = float((matmul_3xtf32(x, w) - exact).abs().max())
    one = float((matmul_3xtf32(x, w, passes=1) - exact).abs().max())
    assert three < 1e-4 / 50
    assert one > 1e-4


@pytest.mark.parametrize("x_dtype,vals_dtype,nm,want", [
    (torch.bfloat16, torch.bfloat16, (2, 4), "sparse"),
    (torch.bfloat16, torch.bfloat16, (1, 4), "sparse"),
    (torch.bfloat16, torch.int8, (2, 4), "sparse"),
    (torch.bfloat16, torch.int8, (1, 4), "sparse"),
    (torch.bfloat16, torch.bfloat16, (4, 8), "dense"),
    (torch.bfloat16, torch.bfloat16, (3, 4), "dense"),
    (torch.float32, torch.float32, (2, 4), "dense"),
    (torch.float32, torch.int8, (2, 4), "dense"),
    (torch.float32, torch.float32, (16, 32), "dense"),
])
def test_prefill_path(x_dtype, vals_dtype, nm, want):
    assert padding.prefill_path(NMConfig(*nm), x_dtype, vals_dtype) == want


def _yi9b_gemms():
    """(K, N) of full-width yi-9b's projections: GQA 32 / 4 heads of 128,
    d_ff 11008 (configs/yi_9b.py)."""
    d = get_config("yi-9b").d_model
    return {"wq/wo": (d, d), "wk/wv": (d, 4 * 128), "w_up/w_gate": (d, 11008),
            "w_down": (11008, d)}


@pytest.mark.parametrize("m", [512, 2048])
def test_prefill_tiles_of_yi9b(m):
    """M = 512 (the serve's 4 x 128 prefill) and 2048 (the masked cell)."""
    bf16, f32 = torch.bfloat16, torch.float32
    tiles = {p: padding.prefill_tile(m, n, NMConfig(), bf16, bf16)
             for p, (_, n) in _yi9b_gemms().items()}
    big, small = padding.PREFILL_TILES
    assert tiles["w_up/w_gate"] == big and tiles["wk/wv"] == small
    assert tiles["wq/wo"] == tiles["w_down"] == big
    for p, (k, n) in _yi9b_gemms().items():
        for vals in (bf16, torch.int8):  # the sparse path
            assert padding.prefill_block(NMConfig(), m, n, bf16, vals) == (
                *tiles[p], 64)
        assert padding.prefill_block(NMConfig(), m, n, f32, f32) == (
            *padding.prefill_tile(m, n, NMConfig(), f32, f32), 32)


@pytest.mark.parametrize("arch", ["resnet50", "densenet121"])
def test_prefill_tiles_of_the_cnns(arch):
    """Batch 8: every conv GEMM (M = 8 H W rows, N = C_out) gets a
    compiled tile; a 128-column tile only where N holds it and its grid
    fills half the SMs; DenseNet-121's C_out = 32 convs and ResNet-50's
    7x7 stage (M = 392) take the small one."""
    big, small = padding.PREFILL_TILES
    seen = set()
    for name, cout, k, hw in cnn_layer_gemms(get_cnn_config(arch)):
        m = 8 * hw
        tile = padding.prefill_tile(m, cout, NMConfig(), torch.float32,
                                    torch.float32)
        assert tile in padding.PREFILL_TILES
        grid = -(-m // big[0]) * -(-cout // big[1])
        assert (tile == big) == (cout >= 128 and grid >= padding.NUM_SMS // 2)
        if cout == 32 or m == 8 * 49:
            assert tile == small, name
        seen.add(tile)
    assert seen == {big, small}


def test_prefill_code_and_unknown_path():
    codes = {padding.prefill_code(p, t) for p in padding.PREFILL_PATHS
             for t in padding.PREFILL_TILES}
    assert codes == {0, 1, 2, 3}
    with pytest.raises(ValueError, match="path"):
        padding.prefill_code("tf32", padding.PREFILL_TILES[0])


def test_prefill_smem_follows_the_kernel_layout():
    """The bytes of ``PfLayout::smem`` (nm_spmm.cuh) for the f32 dense
    path's large tile: five stages of the x tile (128 rows of 32 + 4
    floats) and vrows rows of f32 vals (128 + 4) and idx (128 + 16),
    three dense W^T tiles of 128 rows of 36 floats; 7:8 goes over the
    227 KB a block may take, 2:4 does not."""
    big = padding.PREFILL_TILES[0]
    f32 = torch.float32
    for cfg, vrows in ((NMConfig(7, 8), 28), (NMConfig(2, 4), 16)):
        smem = padding.prefill_smem(big, "dense", cfg, f32, f32)
        assert smem == 147456 + 3360 * vrows
        assert (smem > padding.PREFILL_SMEM_MAX) == (cfg.n == 7)


@pytest.mark.parametrize("x_dtype,vals_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.int8),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8)],
    ids=["f32", "f32-int8", "bf16", "bf16-int8"])
def test_every_pattern_gets_a_tile_that_fits(x_dtype, vals_dtype):
    """1 <= n < m <= 32 at a grid that fills the card: the tile chosen
    fits the shared memory, and it is the large one wherever that fits
    (f32 x and f32 vals past 25 kept rows a stage take the small one)."""
    big, small = padding.PREFILL_TILES
    taken = {}
    for m in range(2, 33):
        for n in range(1, m):
            cfg = NMConfig(n, m)
            path = padding.prefill_path(cfg, x_dtype, vals_dtype)
            tile = padding.prefill_tile(2048, 4096, cfg, x_dtype, vals_dtype)
            fits = {t: padding.prefill_smem(t, path, cfg, x_dtype, vals_dtype)
                    <= padding.PREFILL_SMEM_MAX for t in (big, small)}
            assert fits[small] and fits[tile]
            assert (tile == big) == fits[big]
            taken[cfg.tag] = tile
    both_f32 = (x_dtype, vals_dtype) == (torch.float32, torch.float32)
    assert (taken["7:8"] == small) == both_f32
    assert (taken["15:16"] == small) == both_f32
    assert taken["2:4"] == taken["4:8"] == big


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_dispatch_record_reports_the_launched_geometry(dtype):
    rng = np.random.default_rng(5)
    vals = torch.from_numpy(rng.standard_normal((32, 11008))
                            .astype(np.float32)).to(dtype)
    idx = torch.from_numpy(np.tile(np.array([[0], [2]], np.int8),
                                   (16, 11008)))
    w = NMWeight(vals, idx, NMConfig(2, 4), 0, KernelPolicy("auto"))
    assert padding.prefill_path(NMConfig(), dtype, dtype) == (
        "sparse" if dtype == torch.bfloat16 else "dense")
    for m in (512, 16):  # 4 x 86 and 1 x 86 large tiles
        rec = explain_dispatch((m, 64), w, dtype=dtype, device="cuda")
        assert rec.impl == "nm_spmm"
        assert rec.block == padding.prefill_block(NMConfig(), m, 11008,
                                                  dtype, dtype)
        assert rec.block[:2] == padding.PREFILL_TILES[0]
        assert rec.padded == (-(-m // 128) * 128, 64, 11008)  # 86 x 128
    q = quantize_nm(NMWeight(vals.float(), idx, NMConfig(2, 4), 0,
                             KernelPolicy("auto")))
    rec = explain_dispatch((512, 64), q, dtype=dtype, device="cuda")
    assert rec.impl == "nm_spmm_q" and rec.block[2] == (
        64 if dtype == torch.bfloat16 else 32)
