"""The Hopper gather kernels' design on the CPU: the host's split-K rule
(``padding.gather_plan``) and the plain twin of the kernels' summation
order (``ref.indexmac_gather_split_ref``), held to the JAX package's TPU
kernels ``indexmac_gather_pallas`` / ``indexmac_gather_pallas_q`` run in
interpret mode.

The twin sums an f32 partial per split over the dense rows the rule
gives that split, adds the partials in split order and applies the int8
row scale once, as the kernels do. Tolerance: f32 sums in another order
differ by a few f32 ulps of the largest partial sum, so f32 results
agree at rtol 1e-5 / atol 1e-4 (the JAX gather tests' own tolerance). On
the integer lattice every partial sum is an exact integer below 2^24, so
the twin is bit-equal to the JAX kernels there, float and int8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels.indexmac_gather.kernel import (
    indexmac_gather_pallas,
    indexmac_gather_pallas_q,
)
from repro.kernels.indexmac_gather.ref import (
    indexmac_gather_ref as jax_gather_ref,
)
from repro_torch.configs import get_cnn_config
from repro_torch.core.sparsity import NMConfig
from repro_torch.kernels.indexmac_gather.ref import (
    indexmac_gather_q_ref,
    indexmac_gather_ref,
    indexmac_gather_split_ref,
)
from repro_torch.kernels.padding import (
    GATHER_CTAS_MAX,
    GATHER_MAX_SPLITS,
    GATHER_MIN_STEPS,
    GATHER_SMEM_MAX,
    GATHER_TILES,
    NUM_SMS,
    gather_block,
    gather_ctas_per_sm,
    gather_k_rows,
    gather_plan,
    gather_smem,
)
from repro_torch.models.conv import cnn_layer_gemms

F32 = dict(rtol=1e-5, atol=1e-4)
F32D = (torch.float32, torch.float32)  # B and vals
PATTERNS = [(1, 4), (2, 4)]
# tileable by the TPU kernel's (8, 128, 64) block, and deep enough in K
# that the rule splits it: (16, 512, 128) into 4 splits, (8, 1024, 128)
# into 8
TILEABLE = [(16, 512, 128), (8, 1024, 128)]
# ragged Mr, Nc and K tail (1540 = 48 steps of 32 rows + 4), many splits
RAGGED = [(77, 1540, 53), (24, 2308, 49)]
# the split rule's patterns: the paper's, and m = 8, 16 and 64
RULE_PATTERNS = [(1, 4), (2, 4), (2, 8), (4, 16), (16, 64)]


def _operands(mr, k, nc, nm, seed, lattice=False):
    """A pruned and compressed along its rows by the JAX package, and B,
    as numpy; for the lattice, integer A and B."""
    rng = np.random.default_rng(seed)
    if lattice:
        a = rng.integers(1, 5, (mr, k)) * rng.choice([-1, 1], (mr, k))
        b = rng.integers(-8, 9, (k, nc))
    else:
        a = rng.standard_normal((mr, k))
        b = rng.standard_normal((k, nc))
    jw = japi.sparsify(jnp.asarray(a, jnp.float32), japi.NMConfig(*nm),
                       axis=1)
    return (np.array(jw.vals), np.array(jw.idx), b.astype(np.float32),
            jw.nm)


def _int8(vals, mr, seed):
    """Random int8 values where A kept a value, and f32 row scales."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, vals.shape).astype(np.int8)
    q = np.where(vals == 0, 0, q).astype(np.int8)
    return q, rng.uniform(0.01, 0.1, mr).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("nm", PATTERNS, ids=lambda p: "%d:%d" % p)
@pytest.mark.parametrize("shape", TILEABLE, ids=lambda s: "Mr%dK%dN%d" % s)
def test_split_twin_matches_the_jax_pallas_kernel(shape, nm):
    mr, k, nc = shape
    vals, idx, b, jnm = _operands(mr, k, nc, nm, seed=0)
    cfg = NMConfig(*nm)
    assert gather_plan(mr, k, nc, cfg, *F32D).splits > 1
    want = np.asarray(indexmac_gather_pallas(
        jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(b), cfg=jnm,
        interpret=True))
    got = indexmac_gather_split_ref(_t(vals), _t(idx), _t(b), cfg)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("nm", PATTERNS, ids=lambda p: "%d:%d" % p)
@pytest.mark.parametrize("shape", TILEABLE, ids=lambda s: "Mr%dK%dN%d" % s)
def test_split_twin_bit_exact_with_the_jax_kernels_on_the_lattice(shape, nm):
    """Float and int8 values, f32 B, on the integer lattice: the twin's
    split order changes no bit."""
    mr, k, nc = shape
    vals, idx, b, jnm = _operands(mr, k, nc, nm, seed=1, lattice=True)
    cfg = NMConfig(*nm)
    want = np.asarray(indexmac_gather_pallas(
        jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(b), cfg=jnm,
        interpret=True))
    got = indexmac_gather_split_ref(_t(vals), _t(idx), _t(b), cfg)
    np.testing.assert_array_equal(got.numpy(), want)
    q, scales = _int8(vals, mr, seed=2)
    want_q = np.asarray(indexmac_gather_pallas_q(
        jnp.asarray(q), jnp.asarray(idx), jnp.asarray(scales),
        jnp.asarray(b), cfg=jnm, interpret=True))
    got_q = indexmac_gather_split_ref(_t(q), _t(idx), _t(b), cfg,
                                      scales=_t(scales))
    np.testing.assert_array_equal(got_q.numpy(), want_q)


@pytest.mark.parametrize("nm", PATTERNS, ids=lambda p: "%d:%d" % p)
@pytest.mark.parametrize("shape", RAGGED, ids=lambda s: "Mr%dK%dN%d" % s)
def test_split_twin_at_ragged_shapes(shape, nm):
    """Shapes the TPU tile does not divide, over several splits: the twin
    against the JAX reference and the port's plain version (f32), and bit
    for bit on the lattice, int8 included."""
    mr, k, nc = shape
    cfg = NMConfig(*nm)
    assert gather_plan(mr, k, nc, cfg, *F32D).splits > 1
    vals, idx, b, jnm = _operands(mr, k, nc, nm, seed=3)
    got = indexmac_gather_split_ref(_t(vals), _t(idx), _t(b), cfg)
    want = np.asarray(jax_gather_ref(jnp.asarray(vals), jnp.asarray(idx),
                                     jnp.asarray(b), jnm))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    np.testing.assert_allclose(
        got.numpy(), indexmac_gather_ref(_t(vals), _t(idx), _t(b),
                                         cfg).numpy(), **F32)
    vals, idx, b, jnm = _operands(mr, k, nc, nm, seed=4, lattice=True)
    np.testing.assert_array_equal(
        indexmac_gather_split_ref(_t(vals), _t(idx), _t(b), cfg).numpy(),
        indexmac_gather_ref(_t(vals), _t(idx), _t(b), cfg).numpy())
    q, scales = _int8(vals, mr, seed=5)
    for bb in (_t(b), _t(b).to(torch.bfloat16)):
        np.testing.assert_array_equal(
            indexmac_gather_split_ref(_t(q), _t(idx), bb, cfg,
                                      scales=_t(scales)).float().numpy(),
            indexmac_gather_q_ref(_t(q), _t(idx), _t(scales), bb,
                                  cfg).float().numpy())


def test_split_twin_with_one_split_is_the_plain_version():
    """Where the rule keeps one split the twin is the plain version's
    single f32 product, bit for bit."""
    vals, idx, b, _ = _operands(64, 64, 3136, (2, 4), seed=6)
    cfg = NMConfig(2, 4)
    assert gather_plan(64, 64, 3136, cfg, *F32D).splits == 1
    np.testing.assert_array_equal(
        indexmac_gather_split_ref(_t(vals), _t(idx), _t(b), cfg).numpy(),
        indexmac_gather_ref(_t(vals), _t(idx), _t(b), cfg).numpy())


@pytest.mark.parametrize("nm", RULE_PATTERNS, ids=lambda p: "%d:%d" % p)
def test_split_rule_on_the_resnet50_layer_gemms(nm):
    """The 53 ResNet-50 layer GEMMs (K rounded up to a multiple of m):
    each split holds whole K steps and the splits cover K once; the grid
    fits the card at once (the CTAs per SM that the tile's shared memory
    allows: two at 16:64 in f32) and reaches two CTAs per SM wherever K
    and the cap (GATHER_MAX_SPLITS) allow; the splits are as many as
    those rules allow; one split where the tiles alone fill the card."""
    cfg = NMConfig(*nm)
    layers = cnn_layer_gemms(get_cnn_config("resnet50"))
    assert len(layers) == 53
    for name, mr, k, nc in layers:
        k = -(-k // cfg.m) * cfg.m
        plan = gather_plan(mr, k, nc, cfg, *F32D)
        slots = gather_ctas_per_sm(plan.tile, cfg, *F32D) * NUM_SMS
        assert plan.k_rows == gather_k_rows(cfg) and plan.k_rows % cfg.m == 0
        assert plan.steps == -(-k // plan.k_rows)
        assert plan.tiles == (-(-mr // plan.tile[0])
                              * -(-nc // plan.tile[1]))
        # whole steps a split, the splits cover [0, K) once, in order
        ranges = plan.k_ranges(k)
        assert len(ranges) == plan.splits
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
            assert a1 == b0 and a1 - a0 == plan.per * plan.k_rows
        assert all((a1 - a0) % cfg.m == 0 and a1 > a0 for a0, a1 in ranges)
        for dts in ((torch.float32, torch.float32),
                    (torch.bfloat16, torch.bfloat16),
                    (torch.float32, torch.int8)):
            assert gather_smem(plan.tile, cfg, *dts) <= GATHER_SMEM_MAX
        most = min(GATHER_MAX_SPLITS, plan.steps // GATHER_MIN_STEPS,
                   slots // plan.tiles)
        if plan.tiles >= NUM_SMS or most < 2:
            assert plan.splits == 1, name
            continue
        assert 2 <= plan.splits <= most and plan.blocks <= slots, name
        assert plan.per >= GATHER_MIN_STEPS, name
        # as many splits as the rules allow: a step less breaks one
        assert (plan.per - 1 < GATHER_MIN_STEPS
                or -(-plan.steps // (plan.per - 1)) > most), name
        # two CTAs per SM wherever the splits that allow it fit the card
        # at once (not at 16:64 in f32, which holds two CTAs an SM)
        if most >= -(-2 * NUM_SMS // plan.tiles):
            assert plan.blocks >= 2 * NUM_SMS, name


def test_split_rule_keeps_one_split_where_the_grid_fills_the_card():
    layers = {name: (mr, k, nc) for name, mr, k, nc in
              cnn_layer_gemms(get_cnn_config("resnet50"))}
    for nm in PATTERNS:
        cfg = NMConfig(*nm)
        for name in ("conv1", "s2b1_1x1b", "s2b1_proj", "s3b1_1x1b"):
            mr, k, nc = layers[name]
            plan = gather_plan(mr, -(-k // 4) * 4, nc, cfg, *F32D)
            assert plan.tiles >= NUM_SMS and plan.splits == 1, name
        # the deepest, s5b1_3x3 (16 tiles): 24 splits of 6 steps, 384 CTAs
        # of the card's 396
        plan = gather_plan(512, 4608, 49, cfg, *F32D)
        assert (plan.tiles, plan.per, plan.splits) == (16, 6, 24)
    # a smaller card takes fewer splits for the same target
    small = gather_plan(256, 2304, 196, NMConfig(2, 4), *F32D, sms=16)
    assert small.splits < gather_plan(256, 2304, 196, NMConfig(2, 4),
                                      *F32D).splits


def test_gather_tile_follows_nc():
    """The tile whose lanes resolve the fewest strip chunks a K step, then
    the one that leaves the fewest outputs padded, then the one with more
    rows: at 2:4 (16 kept values a row a step) the 32 x 64 tile, even at
    Nc = 196 where it pads more; at 1:4 (8) the 64 x 32 tile at Nc = 49,
    196 and 3136 (a tie at 49 and 3136), the 32 x 64 one where Mr is
    small."""
    two, one = NMConfig(2, 4), NMConfig(1, 4)
    # s4b1_3x3 (256 x 2304 x 196) takes each tile, one per pattern: the
    # GPU tests' cases there launch both
    assert {gather_block(c, 256, 196)[:2] for c in (two, one)} == set(
        GATHER_TILES)
    for mr, nc in ((512, 49), (256, 196), (24, 49), (64, 3136)):
        assert gather_block(two, mr, nc) == (32, 64, 32)
    for mr, nc in ((512, 49), (256, 196), (64, 3136)):
        assert gather_block(one, mr, nc) == (64, 32, 32)
    assert gather_block(one, 24, 49) == (32, 64, 32)
    assert gather_block(NMConfig(1, 3), 64, 64) == (32, 64, 30)
    assert gather_block(NMConfig(1, 8), 64, 64) == (64, 32, 32)
    assert gather_block(NMConfig(33, 48), 64, 64) == (32, 64, 48)
    assert gather_k_rows(NMConfig(1, 65)) == 0  # no kernel past m = 64


def test_ctas_per_sm_follow_the_shared_memory():
    """The launch bounds' three CTAs an SM at the paper's patterns, every
    dtype; fewer where a CTA's shared memory does not fit three, and the
    split rule then plans a grid that still fits the card at once."""
    for nm in PATTERNS:
        for tile in GATHER_TILES:
            for dts in (F32D, (torch.bfloat16, torch.bfloat16),
                        (torch.float32, torch.int8)):
                assert gather_ctas_per_sm(tile, NMConfig(*nm),
                                          *dts) == GATHER_CTAS_MAX
    wide = NMConfig(63, 64)  # 123,648 / 148,736 bytes a CTA in f32
    assert gather_ctas_per_sm((32, 64), wide, *F32D) == 1
    assert gather_ctas_per_sm((64, 32), wide, *F32D) == 1
    assert gather_ctas_per_sm((64, 32), NMConfig(33, 48), *F32D) == 2
    f32 = gather_plan(512, 4608, 49, wide, *F32D)
    assert f32.splits > 1 and f32.blocks <= NUM_SMS
    bf16 = gather_plan(512, 4608, 49, wide, torch.bfloat16, torch.bfloat16)
    assert bf16.tile == f32.tile and bf16.splits > f32.splits
    assert bf16.blocks <= GATHER_CTAS_MAX * NUM_SMS


def test_every_pattern_fits_the_shared_memory():
    """Every 1 <= n < m <= 64 fits one CTA's shared memory, at every tile
    and dtype, so the kernels take every pattern."""
    worst = 0
    for m in range(2, 65):
        for n in range(1, m):
            cfg = NMConfig(n, m)
            for tile in GATHER_TILES:
                for dts in ((torch.float32, torch.float32),
                            (torch.bfloat16, torch.bfloat16),
                            (torch.float32, torch.bfloat16),
                            (torch.bfloat16, torch.int8),
                            (torch.float32, torch.int8)):
                    worst = max(worst, gather_smem(tile, cfg, *dts))
    assert worst <= GATHER_SMEM_MAX
