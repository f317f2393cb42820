"""The Hopper decode kernels' design on the CPU: the host's split-K plan
(``padding.decode_plan``) and the plain twin of the kernels' summation
order (``ref.nm_decode_split_ref``), held to the JAX package's TPU
kernels ``nm_spmm_pallas_decode`` / ``nm_spmm_pallas_decode_q`` run in
interpret mode and to its decode reference.

The twin sums an f32 partial per split over the dense rows the plan
gives that split, adds the partials in split order, then applies the
int8 column scale, the bias and the activation, as the kernels do.
Tolerance: f32 sums in another order differ by a few f32 ulps of the
largest partial sum, so f32 results agree at rtol 1e-5 / atol 1e-4 (the
JAX gather tests' own tolerance; the activations are the same functions
in both packages). On the integer lattice every partial sum is an exact
integer below 2^24, so the twin is bit-equal to the JAX kernels there,
float and int8; the int8 scales are powers of two there, because XLA may
fuse the JAX side's scale multiply and bias add into one FMA.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels.indexmac.decode_kernel import (
    nm_spmm_pallas_decode,
    nm_spmm_pallas_decode_q,
)
from repro_torch.core.nmweight import KernelPolicy, NMWeight
from repro_torch.core.sparsity import NMConfig, pad_compressed_kn
from repro_torch.kernels.indexmac.ops import explain_dispatch
from repro_torch.kernels.indexmac.ref import (
    nm_decode_split_ref,
    nm_matmul_decode_q_ref,
    nm_matmul_decode_ref,
)
from repro_torch.kernels.padding import (
    DECODE_CTAS_MAX,
    DECODE_K_ROWS,
    DECODE_LANES,
    DECODE_ROWS,
    NUM_SMS,
    PREFILL_SMEM_MAX,
    decode_block,
    decode_ctas_per_sm,
    decode_plan,
    decode_rows,
    decode_smem,
    decode_vec,
)

F32 = dict(rtol=1e-5, atol=1e-4)
ACTS = [None, "relu", "gelu", "silu", "relu_sq"]
PATTERNS = [(2, 4), (1, 4)]
# (K, N): N ragged against every tile width (200, 264) or not (384); K
# deep enough that the plan splits it
SHAPES = [(2048, 200), (1024, 384), (3072, 264)]


def _weights(k, n, nm, seed, lattice=False):
    """W pruned and compressed along K by the JAX package, as numpy."""
    rng = np.random.default_rng(seed)
    if lattice:
        w = rng.integers(1, 5, (k, n)) * rng.choice([-1, 1], (k, n))
    else:
        w = rng.standard_normal((k, n)) * k ** -0.5
    jw = japi.sparsify(jnp.asarray(w, jnp.float32), japi.NMConfig(*nm))
    return np.array(jw.vals), np.array(jw.idx), jw.nm


def _x(m, k, seed, lattice=False):
    rng = np.random.default_rng(seed + 100)
    if lattice:
        return rng.integers(-8, 9, (m, k)).astype(np.float32)
    return rng.standard_normal((m, k)).astype(np.float32)


def _int8(vals, n, seed, lattice=False):
    """int8 values and f32 column scales: the float values quantized per
    column (absmax / 127), or on the lattice random int8 values where W
    kept a value and power-of-two scales."""
    if not lattice:
        scales = np.maximum(np.abs(vals).max(0), 1e-8) / 127
        q = np.round(vals / scales).astype(np.int8)
        return q, scales.astype(np.float32)
    rng = np.random.default_rng(seed + 200)
    q = rng.integers(-127, 128, vals.shape).astype(np.int8)
    q = np.where(vals == 0, 0, q).astype(np.int8)
    return q, (2.0 ** -rng.integers(2, 8, n)).astype(np.float32)


def _jax_decode(x, vals, idx, jnm, bias, act, scales=None):
    """The JAX TPU decode kernel in interpret mode: rows padded to 8 (its
    sublane), one column block (N need not divide 256)."""
    m, k = x.shape
    n = vals.shape[1]
    xp = np.zeros((-(-m // 8) * 8, k), np.float32)
    xp[:m] = x
    kw = dict(cfg=jnm, block_n=n, activation=act, interpret=True)
    b = None if bias is None else jnp.asarray(bias)
    if scales is None:
        y = nm_spmm_pallas_decode(jnp.asarray(xp), jnp.asarray(vals),
                                  jnp.asarray(idx), b, **kw)
    else:
        y = nm_spmm_pallas_decode_q(jnp.asarray(xp), jnp.asarray(vals),
                                    jnp.asarray(idx), jnp.asarray(scales), b,
                                    **kw)
    return np.asarray(y)[:m]


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("act", ACTS, ids=lambda a: a or "none")
@pytest.mark.parametrize("bias_on", [False, True], ids=["nobias", "bias"])
def test_split_twin_matches_the_jax_kernel_every_epilogue(act, bias_on):
    """Float and int8 vals at 2:4, M = 4, K split by the plan."""
    k, n, m = 2048, 200, 4
    vals, idx, jnm = _weights(k, n, (2, 4), seed=0)
    x = _x(m, k, seed=0)
    bias = (np.random.default_rng(1).standard_normal(n).astype(np.float32)
            if bias_on else None)
    cfg = NMConfig(2, 4)
    assert decode_plan(m, k, n, cfg, 4).splits > 1
    got = nm_decode_split_ref(_t(x), _t(vals), _t(idx), None, _t(bias), cfg,
                              act)
    want = _jax_decode(x, vals, idx, jnm, bias, act)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    q, scales = _int8(vals, n, seed=0)
    got = nm_decode_split_ref(_t(x), _t(q), _t(idx), _t(scales), _t(bias),
                              cfg, act)
    want = _jax_decode(x, q, idx, jnm, bias, act, scales)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("nm", PATTERNS, ids=lambda p: "%d:%d" % p)
@pytest.mark.parametrize("m", DECODE_ROWS)
@pytest.mark.parametrize("kn", SHAPES, ids=lambda s: "K%dN%d" % s)
def test_split_twin_matches_the_jax_kernel_at_every_row_count(kn, m, nm):
    """M = 1, 2, 4, 8 at ragged and even N, 1:4 and 2:4, bias + SiLU:
    float values against the JAX kernel, int8 against its reference."""
    k, n = kn
    vals, idx, jnm = _weights(k, n, nm, seed=m)
    x = _x(m, k, seed=m)
    bias = np.random.default_rng(m).standard_normal(n).astype(np.float32)
    cfg = NMConfig(*nm)
    assert decode_plan(m, k, n, cfg, 4).splits > 1
    got = nm_decode_split_ref(_t(x), _t(vals), _t(idx), None, _t(bias), cfg,
                              "silu")
    np.testing.assert_allclose(
        got.numpy(), _jax_decode(x, vals, idx, jnm, bias, "silu"), **F32)
    q, scales = _int8(vals, n, seed=m)
    got = nm_decode_split_ref(_t(x), _t(q), _t(idx), _t(scales), _t(bias),
                              cfg, "silu")
    want = nm_matmul_decode_q_ref(_t(x), _t(q), _t(idx), _t(scales),
                                  _t(bias), cfg, "silu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


@pytest.mark.parametrize("nm", PATTERNS, ids=lambda p: "%d:%d" % p)
@pytest.mark.parametrize("m", [1, 4, 8])
def test_split_twin_bit_exact_with_the_jax_kernels_on_the_lattice(m, nm):
    """Integer x, weights and bias, power-of-two int8 scales: the twin's
    split order changes no bit against the JAX kernels, float and int8."""
    k, n = 3072, 264
    vals, idx, jnm = _weights(k, n, nm, seed=10 + m, lattice=True)
    x = _x(m, k, seed=10 + m, lattice=True)
    bias = np.random.default_rng(m).integers(-8, 9, n).astype(np.float32)
    cfg = NMConfig(*nm)
    assert decode_plan(m, k, n, cfg, 1).splits > 1
    for b, act in ((None, None), (bias, "relu"), (bias, "relu_sq")):
        got = nm_decode_split_ref(_t(x), _t(vals), _t(idx), None, _t(b), cfg,
                                  act)
        np.testing.assert_array_equal(
            got.numpy(), _jax_decode(x, vals, idx, jnm, b, act))
        q, scales = _int8(vals, n, seed=m, lattice=True)
        got = nm_decode_split_ref(_t(x), _t(q), _t(idx), _t(scales), _t(b),
                                  cfg, act)
        np.testing.assert_array_equal(
            got.numpy(), _jax_decode(x, q, idx, jnm, b, act, scales))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_split_twin_with_one_split_is_the_plain_version(dtype):
    """A plan of one split: the twin is the plain version's single f32
    product and epilogue, bit for bit."""
    k, n, m = 1024, 384, 4
    vals, idx, _ = _weights(k, n, (2, 4), seed=3)
    cfg = NMConfig(2, 4)
    x = _t(_x(m, k, seed=3)).to(dtype)
    v = _t(vals).to(dtype)
    bias = torch.randn(n, generator=torch.Generator().manual_seed(3))
    one = decode_plan(m, k, n, cfg, v.element_size(), per=k // cfg.m)
    assert one.splits == 1 and one.k_ranges(k) == [(0, k)]
    for act in ACTS:
        assert torch.equal(
            nm_decode_split_ref(x, v, _t(idx), None, bias, cfg, act, one),
            nm_matmul_decode_ref(x, v, _t(idx), bias, cfg, act))
    q, scales = _int8(vals, n, seed=3)
    assert torch.equal(
        nm_decode_split_ref(x, _t(q), _t(idx), _t(scales), bias, cfg, "gelu",
                            one),
        nm_matmul_decode_q_ref(x, _t(q), _t(idx), _t(scales), bias, cfg,
                               "gelu"))


@pytest.mark.parametrize("nm", PATTERNS, ids=lambda p: "%d:%d" % p)
def test_split_twin_adds_repeated_indices(nm):
    """Padded weights (``pad_compressed_kn``'s: value 0 at index 0, n times
    a block, across further splits) and blocks whose kept values repeat
    an index: every kept value adds, as the JAX kernel's masked dots and
    ``decompress_nm`` do."""
    k, n, m, extra = 2048, 200, 4, 256
    vals, idx, jnm = _weights(k, n, nm, seed=4)
    if nm[0] > 1:  # every other block's second value takes the first's index
        idx[1::2 * nm[0]] = idx[0:-1:2 * nm[0]]
    pv, pi = pad_compressed_kn(_t(vals), _t(idx),
                               kc_pad=vals.shape[0] + extra * nm[0], n_pad=n)
    kp = k + extra * nm[1]
    x = _x(m, kp, seed=4)
    cfg = NMConfig(*nm)
    assert len(decode_plan(m, kp, n, cfg, 4).k_ranges(kp)) > 1
    got = nm_decode_split_ref(_t(x), pv, pi, None, None, cfg, "relu")
    want = _jax_decode(x, pv.numpy(), pi.numpy(), jnm, None, "relu")
    np.testing.assert_allclose(got.numpy(), want, **F32)
    np.testing.assert_allclose(
        got.numpy(), nm_matmul_decode_ref(_t(x), pv, pi, None, cfg,
                                          "relu").numpy(), **F32)


# (K, N) of full-width yi-9b's projections (configs/yi_9b.py: d_model
# 4096, 4 KV heads of 128, d_ff 11008)
YI9B = {"wq/wo": (4096, 4096), "wk/wv": (4096, 512),
        "w_gate/w_up": (4096, 11008), "w_down": (11008, 4096)}


@pytest.mark.parametrize("itemsize", [2, 1], ids=["bf16", "int8"])
def test_plan_fills_the_card_once_at_every_yi9b_projection(itemsize):
    """The served weights (bf16 or int8 values) at M = 1, 2, 4, 8: the grid
    fits the card's CTA slots at once and loads the SMs evenly (at least
    95 % of a full SM's CTAs on every SM); the splits cover K once, in
    order, in whole m-blocks of at most DECODE_K_ROWS dense rows (x is
    staged once a CTA); the tile is a compiled width."""
    cfg = NMConfig(2, 4)
    for name, (k, n) in YI9B.items():
        for m in DECODE_ROWS:
            plan = decode_plan(m, k, n, cfg, itemsize, NUM_SMS)
            slots = NUM_SMS * decode_ctas_per_sm(itemsize)
            busiest = -(-plan.ctas // NUM_SMS)
            assert plan.ctas <= slots, (name, m, plan)
            assert plan.ctas >= 0.95 * busiest * NUM_SMS, (name, m, plan)
            assert plan.rows == decode_rows(m)
            assert plan.cols in {lanes * decode_vec(itemsize)
                                 for lanes in DECODE_LANES}
            assert plan.tiles == -(-n // plan.cols)
            ranges = plan.k_ranges(k)
            assert len(ranges) == plan.splits
            assert ranges[0][0] == 0 and ranges[-1][1] == k
            for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
                assert a1 == b0 and a1 - a0 == plan.span
            assert plan.span % cfg.m == 0 and plan.span <= DECODE_K_ROWS


def test_plan_keeps_one_split_where_n_alone_fills_the_card():
    """An N whose tiles alone fill the card's slots takes one split; yi-9b's
    narrow wk / wv (N = 512) takes the narrowest tile and splits K."""
    cfg = NMConfig(2, 4)
    wide = decode_plan(4, 1024, 32768, cfg, 2)
    assert wide.splits == 1 and wide.ctas >= 0.95 * NUM_SMS
    kv = decode_plan(4, 4096, 512, cfg, 2)
    assert kv.cols == DECODE_LANES[-1] * decode_vec(2) and kv.splits > 1
    # a smaller card takes fewer splits for the same shape
    assert decode_plan(4, 4096, 512, cfg, 2, sms=16).splits < kv.splits


def test_plan_replaced_by_the_caller():
    """``cols`` and ``per`` give the launches the rule did not choose."""
    cfg = NMConfig(2, 4)
    p = decode_plan(4, 4096, 11008, cfg, 2, cols=128, per=128)
    assert (p.cols, p.per, p.span, p.splits, p.tiles) == (128, 128, 512, 8,
                                                          86)


def test_ctas_per_sm_and_shared_memory_fit_every_pattern():
    """The launch bounds' CTAs an SM at every value size, which is also
    all that a CTA's shared memory lets an SM hold (so no instantiation
    with fewer registers holds more), and that shared memory within 227
    KB at every pattern the wrapper takes (m <= DECODE_K_ROWS): a split
    never spans more dense rows than the staged x holds."""
    for itemsize in (4, 2, 1):
        assert decode_ctas_per_sm(itemsize) == DECODE_CTAS_MAX
        per_cta = decode_smem(itemsize) + 16 + 1024  # static word, reserve
        assert 3 * per_cta > 228 * 1024
        assert decode_smem(itemsize) <= PREFILL_SMEM_MAX
    for m in range(2, DECODE_K_ROWS + 1):
        for n in sorted({1, m // 2, m - 1}):
            cfg = NMConfig(n, m)
            for rows in (1, 8):
                plan = decode_plan(rows, 4 * m, 264, cfg, 2)
                assert plan.span % m == 0 and plan.span <= DECODE_K_ROWS
                assert plan.splits == -(-4 // plan.per)


def test_dispatch_record_reports_the_plan():
    """``explain_dispatch`` reports the first launch's (rows, columns a
    CTA, dense rows a split)."""
    k, n = 4096, 11008
    vals = torch.zeros(k // 2, n)
    idx = torch.zeros(k // 2, n, dtype=torch.int8)
    w = NMWeight(vals, idx, NMConfig(2, 4), 0, KernelPolicy("auto"))
    for m in (1, 3, 8):
        rec = explain_dispatch((m, k), w, dtype=torch.bfloat16)
        plan = decode_plan(m, k, n, NMConfig(2, 4), 2)  # vals cast to x's
        assert rec.block == decode_block(NMConfig(2, 4), m, k, n, 2) == (
            plan.rows, plan.cols, plan.span)
        assert rec.padded == (decode_rows(m), k, -(-n // plan.cols)
                              * plan.cols)
