"""N:M primitives of the PyTorch port against the JAX package: the same
numpy inputs through both, results bit-equal (prune, compress and
decompress move values, they do no arithmetic but the one-hot sum)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsity as jsp
from repro_torch.core import sparsity as tsp

CFGS = [(2, 4), (1, 4), (2, 8), (1, 2)]


def _both(n, m):
    return jsp.NMConfig(n, m), tsp.NMConfig(n, m)


def _cases(m, seed):
    """Random values plus the corner cases: ties, blocks with fewer than
    n non-zeros, all-zero blocks."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((8 * m, 24)).astype(np.float32)
    w[:m, 0] = 1.0  # a block of equal magnitudes: ties by position
    w[m:2 * m, 1] = np.array([1.0, -1.0] * (m // 2) or [1.0])[:m]
    w[:m, 2] = 0.0  # an all-zero block
    w[2 * m:3 * m, 3] = 0.0
    w[2 * m + m - 1, 3] = 3.0  # a block with one non-zero, last position
    w[3 * m:4 * m, 4] = np.round(w[3 * m:4 * m, 4])  # exact zeros and ties
    return w


@pytest.mark.parametrize("nm", CFGS, ids=lambda c: "%d:%d" % c)
@pytest.mark.parametrize("axis", [0, 1])
def test_prune_mask_bit_equal(nm, axis):
    jc, tc = _both(*nm)
    w = _cases(nm[1], seed=nm[0] * 10 + nm[1])
    if axis == 1:
        w = np.ascontiguousarray(w.T)
    want = np.asarray(jsp.prune_mask_nm(jnp.asarray(w), jc, axis=axis))
    got = tsp.prune_mask_nm(torch.from_numpy(w), tc, axis=axis).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nm", CFGS, ids=lambda c: "%d:%d" % c)
@pytest.mark.parametrize("axis", [0, 1])
def test_compress_and_decompress_bit_equal(nm, axis):
    jc, tc = _both(*nm)
    w = _cases(nm[1], seed=nm[1])
    if axis == 1:
        w = np.ascontiguousarray(w.T)
    # prune with the JAX mask, then compress the result in both packages
    pruned = np.array(jsp.apply_mask(
        jnp.asarray(w), jsp.prune_mask_nm(jnp.asarray(w), jc, axis=axis)))
    pruned[:nm[1], :2] = 0.0  # short and all-zero blocks after pruning
    jv, ji = jsp.compress_nm(jnp.asarray(pruned), jc, axis=axis)
    tv, ti = tsp.compress_nm(torch.from_numpy(pruned), tc, axis=axis)
    assert ti.dtype == torch.int8
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    dense = tsp.decompress_nm(tv, ti, tc, axis=axis).numpy()
    np.testing.assert_array_equal(
        dense, np.asarray(jsp.decompress_nm(jv, ji, jc, axis=axis)))
    np.testing.assert_array_equal(dense, pruned)
    assert tsp.check_nm_pattern(torch.from_numpy(dense), tc, axis=axis)


def test_padding_rule_is_a_zero_position():
    """A short block pads at its first zero positions, not at the last
    kept entry; both packages agree."""
    jc, tc = _both(2, 4)
    for col, want in (([0, 0, 3, 0], [2, 0]), ([0, 0, 0, 0], [0, 1]),
                      ([0, 5, 0, 0], [1, 0]), ([0, 0, 0, 7], [3, 0])):
        w = np.asarray(col, np.float32)[:, None]
        _, ti = tsp.compress_nm(torch.from_numpy(w), tc)
        _, ji = jsp.compress_nm(jnp.asarray(w), jc)
        assert ti[:, 0].tolist() == want == np.asarray(ji)[:, 0].tolist()


def test_repeated_indices_add_up():
    """decompress is a one-hot sum: a pair that names one position twice
    adds both values there, in both packages."""
    jc, tc = _both(2, 4)
    vals = np.array([[1.5], [2.0]], np.float32)
    idx = np.array([[3], [3]], np.int8)
    got = tsp.decompress_nm(torch.from_numpy(vals), torch.from_numpy(idx), tc)
    want = jsp.decompress_nm(jnp.asarray(vals), jnp.asarray(idx), jc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:, 0].tolist() == [0.0, 0.0, 0.0, 3.5]


@pytest.mark.parametrize("target", [(8, 24), (12, 24), (8, 40), (16, 33)])
def test_pad_compressed_kn_bit_equal(target):
    jc, tc = _both(2, 4)
    rng = np.random.default_rng(3)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    jv, ji = jsp.compress_nm(jsp.apply_mask(
        jnp.asarray(w), jsp.prune_mask_nm(jnp.asarray(w), jc)), jc)
    tv, ti = torch.from_numpy(np.array(jv)), torch.from_numpy(np.array(ji))
    kc, nn = target
    pv, pi = tsp.pad_compressed_kn(tv, ti, kc_pad=kc, n_pad=nn)
    qv, qi = jsp.pad_compressed_kn(jv, ji, kc_pad=kc, n_pad=nn)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(qv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(qi))
    np.testing.assert_array_equal(
        tsp.decompress_nm(pv, pi, tc).numpy(),
        np.asarray(jsp.decompress_nm(qv, qi, jc)))


def test_pad_compressed_kn_refuses_shrinking():
    tc = tsp.NMConfig(2, 4)
    v = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="smaller"):
        tsp.pad_compressed_kn(v, v.to(torch.int8), kc_pad=6, n_pad=4)
    with pytest.raises(ValueError, match="divisible"):
        tsp.compress_nm(torch.zeros(6, 4), tc)
    with pytest.raises(ValueError):
        tsp.NMConfig(4, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decompress_keeps_the_values_dtype(dtype):
    tc = tsp.NMConfig(2, 4)
    w = torch.randn(16, 8, generator=torch.Generator().manual_seed(0))
    v, i = tsp.compress_nm(tsp.apply_mask(w, tsp.prune_mask_nm(w, tc)), tc)
    dense = tsp.decompress_nm(v.to(dtype), i, tc)
    assert dense.dtype == dtype
    assert torch.equal(dense, tsp.apply_mask(w, tsp.prune_mask_nm(w, tc))
                       .to(dtype))
