"""The port's block-sparse attention against the JAX package on the CPU:
mask plans equal array for array, the plain lowerings against JAX's
dense oracle and its TPU pair-list kernel (interpret mode), the decode
path, the routing (CPU budgets; the cuda backend's auto = force, checked
through the dry-run, which launches nothing), and reduced yi-9b with a
local mask on the same weights as JAX's masked model.

Inputs come from numpy with a seed. Tolerances: f32 attention agrees to
1e-5 (the same f32 products summed in another order); bf16 outputs are
rounded from f32 sums and agree to one bf16 step (1e-2); model logits to
1e-4 (two layers of f32 products, |logits| of order 1), as in
``tests/test_torch_model.py``. Greedy token streams must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_reduced as jax_reduced
from repro.core.nmweight import NMWeight as JaxNMWeight
from repro.kernels.blocksparse_attn import mask as jmask
from repro.kernels.blocksparse_attn import ref as jref
from repro.kernels.blocksparse_attn.kernel import run_bs_attention_tpu
from repro.models import common as jcommon
from repro.models.cache import CacheView as JaxCacheView
from repro.models.transformer import LM as JaxLM
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch import api
from repro_torch.configs import get_reduced
from repro_torch.interop import lm_from_jax, mask_from_jax
from repro_torch.kernels import registry
from repro_torch.kernels.blocksparse_attn import kernel as bkernel
from repro_torch.kernels.blocksparse_attn import mask as tmask
from repro_torch.kernels.blocksparse_attn.ops import (
    MaskForceError,
    bs_attention,
    bs_attention_decode,
    explain_dispatch_attention,
)
from repro_torch.kernels.blocksparse_attn.ref import (
    blocksparse_mma,
    blocksparse_torch,
    masked_decode,
    masked_reference,
)
from repro_torch.models.cache import CacheView
from repro_torch.serving.engine import Request, ServeEngine

TOL = 1e-5
LOGIT_TOL = 1e-4

# diagonal + first block column: every q row keeps its causal diagonal
# token, so the pattern compiles at any length (tests/test_blocksparse_attn)
_BW_PAIRS = tuple((i, j) for i in range(8) for j in (0, i))
SPEC_ARGS = [
    dict(kind="causal", block=16),
    dict(kind="local", block=16, window=24),
    dict(kind="local", block=16, window=24, causal=False),
    dict(kind="strided", block=16, stride=2),
    dict(kind="blockwise", block=16, blocks=_BW_PAIRS),
]
SPEC_IDS = [jmask.MaskSpec(**a).tag for a in SPEC_ARGS]


def _specs(args):
    return jmask.MaskSpec(**args), tmask.MaskSpec(**args)


def _qkv(b=2, sq=64, skv=None, hq=4, hkv=2, dk=16, dv=None, seed=0):
    skv = sq if skv is None else skv
    dv = dk if dv is None else dv
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, hq, dk), (b, skv, hkv, dk),
                           (b, skv, hkv, dv)))


def _jax(*arrays, dtype=jnp.float32):
    return tuple(jnp.asarray(a, dtype) for a in arrays)


def _torch(*arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# mask plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tile", [(16, 16), (8, 32)], ids=["16x16", "8x32"])
@pytest.mark.parametrize("sq", [64, 67], ids=["even", "odd"])
@pytest.mark.parametrize("args", SPEC_ARGS, ids=SPEC_IDS)
def test_plans_equal_jax(args, sq, tile):
    js, ts = _specs(args)
    jp = jmask.compile_mask(js, sq, sq, tile)
    tp = tmask.compile_mask(ts, sq, sq, tile)
    assert tp is not None and jp is not None
    for f in ("sq", "skv", "bq", "bk", "nqb", "nkb", "n_live", "live_tokens",
              "density", "waste", "gather_width", "padded_shape", "block"):
        assert getattr(tp, f) == getattr(jp, f), f
    for f in ("bitmap", "tokens", "pair_q", "pair_k", "row_idx", "row_valid"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), f)
        assert getattr(tp, f).dtype == getattr(jp, f).dtype, f
    np.testing.assert_array_equal(tmask.pair_masks(tp), jmask.pair_masks(jp))
    np.testing.assert_array_equal(tmask.gather_masks(tp),
                                  jmask.gather_masks(jp))
    # the kernel's CSR row pointers cut the row-major pair list by q-block
    ptr = tmask.row_pointers(tp)
    for r in range(tp.nqb):
        np.testing.assert_array_equal(tp.pair_k[ptr[r]:ptr[r + 1]],
                                      np.nonzero(tp.bitmap[r])[0])
    assert ptr[-1] == tp.n_live


@pytest.mark.parametrize("args", SPEC_ARGS, ids=SPEC_IDS)
def test_default_tile_and_token_mask_equal_jax(args):
    js, ts = _specs(args)
    for sq, skv in ((64, 64), (67, 5), (3, 200)):
        assert tmask.default_tile(ts, sq, skv) == jmask.default_tile(
            js, sq, skv)
    qp, kp = np.arange(80)[:, None], np.arange(80)[None, :]
    bm = (tmask.block_bitmap(ts, 5, 5) if ts.kind == "blockwise" else None)
    want = jmask.token_mask(js, qp, kp, bitmap=bm)
    np.testing.assert_array_equal(tmask.token_mask(ts, qp, kp, bitmap=bm),
                                  want)
    got = tmask.token_mask(
        ts, torch.from_numpy(qp), torch.from_numpy(kp),
        bitmap=None if bm is None else torch.from_numpy(bm))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("args,sq,skv,tile", [
    (dict(kind="local", block=16, window=24), 0, 64, (16, 16)),
    (dict(kind="local", block=16, window=24), 64, 64, (12, 16)),
    (dict(kind="blockwise", block=16, blocks=((0, 0),), causal=False), 64,
     64, (16, 16)),
], ids=["empty", "misaligned", "row-sees-nothing"])
def test_untileable_plans_are_none_in_both(args, sq, skv, tile):
    js, ts = _specs(args)
    assert jmask.compile_mask(js, sq, skv, tile) is None
    assert tmask.compile_mask(ts, sq, skv, tile) is None


def test_compile_mask_is_cached_per_problem():
    ts = tmask.MaskSpec("local", block=16, window=24)
    assert tmask.compile_mask(ts, 64, 64, (16, 16)) is tmask.compile_mask(
        tmask.MaskSpec("local", block=16, window=24), 64, 64, (16, 16))


@pytest.mark.parametrize("args,match", [
    (dict(kind="banded"), "kind"),
    (dict(kind="causal", block=12), "multiple of 8"),
    (dict(kind="local"), "window"),
    (dict(kind="causal", window=8), "local-only"),
    (dict(kind="strided"), "stride"),
    (dict(kind="causal", stride=2), "strided-only"),
    (dict(kind="blockwise"), "blocks"),
    (dict(kind="blockwise", blocks=((-1, 0),)), "non-negative"),
    (dict(kind="causal", blocks=((0, 0),)), "blockwise-only"),
])
def test_maskspec_validation_matches_jax(args, match):
    with pytest.raises(ValueError, match=match) as jerr:
        jmask.MaskSpec(**args)
    with pytest.raises(ValueError, match=match) as terr:
        tmask.MaskSpec(**args)
    assert str(terr.value) == str(jerr.value)


def test_tags_and_blockwise_normalization_match_jax():
    for args in SPEC_ARGS:
        js, ts = _specs(args)
        assert ts.tag == js.tag
        assert mask_from_jax(js) == ts
    assert len({tmask.MaskSpec(**a).tag for a in SPEC_ARGS}) == len(SPEC_ARGS)
    a = tmask.MaskSpec("blockwise", blocks=((1, 0), (0, 0), (1, 0)))
    b = tmask.MaskSpec("blockwise", blocks=((0, 0), (1, 0)))
    assert a == b and a.tag == b.tag
    assert a.blocks == jmask.MaskSpec("blockwise",
                                      blocks=((1, 0), (0, 0))).blocks


# ---------------------------------------------------------------------------
# the plain lowerings against JAX's oracle and TPU kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq", [64, 67], ids=["even", "odd"])
@pytest.mark.parametrize("args", SPEC_ARGS, ids=SPEC_IDS)
def test_references_match_jax(args, sq):
    js, ts = _specs(args)
    arrays = _qkv(sq=sq)
    want = jref.masked_reference(*_jax(*arrays), spec=js)
    plan = tmask.compile_mask(ts, sq, sq, (16, 16))
    _close(masked_reference(*_torch(*arrays), spec=ts), want)
    _close(blocksparse_torch(*_torch(*arrays), plan=plan), want)
    # the kernel wrapper on CPU tensors runs its plain version
    _close(bkernel.bs_attention(*_torch(*arrays), plan), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("args", [SPEC_ARGS[1], SPEC_ARGS[3]],
                         ids=[SPEC_IDS[1], SPEC_IDS[3]])
def test_lowerings_match_the_tpu_kernel_in_interpret_mode(args, dtype):
    js, ts = _specs(args)
    arrays = _qkv(sq=67, seed=1)
    jdt, tdt, tol = ((jnp.float32, torch.float32, TOL) if dtype == "f32"
                     else (jnp.bfloat16, torch.bfloat16, 1e-2))
    want = run_bs_attention_tpu(
        *_jax(*arrays, dtype=jdt), spec=js,
        plan=jmask.compile_mask(js, 67, 67, (16, 16)), interpret=True)
    plan = tmask.compile_mask(ts, 67, 67, (16, 16))
    for got in (blocksparse_torch(*_torch(*arrays, dtype=tdt), plan=plan),
                masked_reference(*_torch(*arrays, dtype=tdt), spec=ts)):
        assert got.dtype == tdt
        _close(got.float(), np.asarray(want, np.float32), tol)


def test_bf16_and_output_dtype():
    js, ts = _specs(SPEC_ARGS[1])
    arrays = _qkv(sq=64, seed=2)
    want = jref.masked_reference(*_jax(*arrays, dtype=jnp.bfloat16), spec=js)
    plan = tmask.compile_mask(ts, 64, 64, (16, 16))
    for got in (masked_reference(*_torch(*arrays, dtype=torch.bfloat16),
                                 spec=ts),
                blocksparse_torch(*_torch(*arrays, dtype=torch.bfloat16),
                                  plan=plan)):
        assert got.dtype == torch.bfloat16
        _close(got.float(), want, tol=1e-2)


# ---------------------------------------------------------------------------
# the bf16 Hopper kernel's arithmetic: its plain twin, and the host's G' rule
# ---------------------------------------------------------------------------

BF16_TOL = 1e-2  # chip_smoke.py's TOL for bf16 outputs (rtol = atol)


def _budget_share(got, want, tol=BF16_TOL):
    """Largest |got - want| as a share of allclose's allowance."""
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    return float((np.abs(got - want) / (tol + tol * np.abs(want))).max())


# (spec, Sq, Skv, Hq, Hkv, Dk, Dv, scale): yi-9b's head dim 128 under GQA,
# a k-block of 16 (four pairs a 64-slot chunk), Sq != Skv, Dk != Dv
MMA_CASES = [
    (dict(kind="local", block=64, window=96), 130, 130, 4, 2, 128, 128, None),
    (dict(kind="causal", block=16), 67, 67, 8, 1, 128, 128, None),
    (dict(kind="causal", block=16), 40, 72, 4, 2, 128, 128, None),
    (dict(kind="strided", block=16, stride=2), 48, 48, 4, 4, 24, 40, 0.17),
]


@pytest.mark.parametrize("case", MMA_CASES,
                         ids=["local64-d128", "causal16-d128",
                              "causal16-sq40-skv72", "strided16-d24-40"])
def test_mma_twin_matches_the_tpu_kernel_and_reference(case):
    """The bf16 kernel's rounding (scores scaled after the product, P in
    bf16) stays within chip_smoke.py's bf16 tolerance of JAX's TPU kernel
    (interpret mode) and of masked_reference, with room to spare: the
    outputs differ by at most one bf16 step, about half the allowance."""
    args, sq, skv, hq, hkv, dk, dv, scale = case
    js, ts = _specs(args)
    arrays = _qkv(sq=sq, skv=skv, hq=hq, hkv=hkv, dk=dk, dv=dv, seed=5)
    want = run_bs_attention_tpu(
        *_jax(*arrays, dtype=jnp.bfloat16), spec=js, scale=scale,
        plan=jmask.compile_mask(js, sq, skv), interpret=True)
    tq = _torch(*arrays, dtype=torch.bfloat16)
    got = blocksparse_mma(*tq, plan=tmask.compile_mask(ts, sq, skv),
                          scale=scale)
    assert got.dtype == torch.bfloat16 and got.shape == (2, sq, hq, dv)
    ref = masked_reference(*tq, spec=ts, scale=scale)
    for other in (np.asarray(want, np.float32), ref.float()):
        _close(got.float(), other, tol=BF16_TOL)
        assert _budget_share(got.float(), other) < 0.6


@pytest.mark.parametrize("tile", [(16, 16), (64, 64), (128, 128), (24, 40)],
                         ids=["16", "64", "128", "24x40"])
def test_mma_twin_online_softmax_equals_the_gather_lowering(tile):
    """In f32 (P is not rounded) the twin's 64-slot online-softmax steps
    over a q-block's run of live keys give the gather lowering's result:
    four pairs a step (bk 16), one (64), half a pair (128), and steps that
    split a pair (bk 40); rows whose first step is all masked included."""
    js, ts = _specs(dict(kind="local", block=16, window=40, causal=False))
    arrays = _qkv(sq=150, hq=4, hkv=2, dk=24, seed=6)
    plan = tmask.compile_mask(ts, 150, 150, tile)
    got = blocksparse_mma(*_torch(*arrays), plan=plan)
    _close(got, blocksparse_torch(*_torch(*arrays), plan=plan))
    _close(got, jref.masked_reference(*_jax(*arrays), spec=js))


# (B, Sq, tile, Hq, Hkv, SMs, G'): the served local cell and smaller
# grids on a 132-SM card, the grids of tests/test_torch_gpu.py included
GROUP_CASES = [
    (2, 1024, (64, 64), 32, 4, 132, 2),    # 512 CTAs at G' = 2
    (1, 1024, (64, 64), 32, 4, 132, 2),    # 256
    (1, 512, (64, 64), 32, 4, 132, 1),     # 128 at G' = 2: fewer than SMs
    (2, 1000, (128, 128), 32, 4, 132, 2),  # two 64-row parts a q-block
    (2, 1024, (64, 64), 32, 32, 132, 1),   # Hq == Hkv
    (2, 1024, (64, 64), 12, 4, 132, 1),    # Hq / Hkv odd
    (2, 200, (16, 16), 16, 2, 132, 2),     # 208 CTAs
    (2, 200, (16, 16), 16, 8, 132, 2),
    (2, 64, (16, 16), 16, 2, 132, 1),      # 64
    (2, 200, (128, 128), 16, 2, 132, 1),   # 64
]


@pytest.mark.parametrize("case", GROUP_CASES)
def test_heads_per_cta_rule(case):
    b, sq, tile, hq, hkv, sms, want = case
    plan = tmask.compile_mask(tmask.MaskSpec("causal", block=16), sq, sq,
                              tile)
    got = bkernel.heads_per_cta(hq, hkv, b, plan, sms)
    assert got == want
    assert (hq // hkv) % got == 0


def test_value_dim_and_scale_match_jax():
    """MLA-shaped call: Hq == Hkv, Dv != Dk, explicit scale."""
    js, ts = _specs(SPEC_ARGS[3])
    arrays = _qkv(sq=48, hq=4, hkv=4, dk=24, dv=40, seed=3)
    want = jref.masked_reference(*_jax(*arrays), spec=js, scale=0.17)
    got = bs_attention(*_torch(*arrays), spec=ts, scale=0.17, tile=(16, 16))
    assert got.shape == (2, 48, 4, 40)
    _close(got, want)
    _close(masked_reference(*_torch(*arrays), spec=ts, scale=0.17), want)


# ---------------------------------------------------------------------------
# the decode family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", SPEC_ARGS, ids=SPEC_IDS)
def test_masked_decode_matches_jax_in_decode_and_chunk_modes(args):
    js, ts = _specs(args)
    q, k, v = _qkv(sq=96, seed=4)
    lens = np.array([80, 57], np.int32)
    want = jref.masked_decode(*_jax(q[:, 79:80], k, v), spec=js,
                              length=jnp.asarray(lens))
    got = masked_decode(*_torch(q[:, 79:80], k, v), spec=ts,
                        length=torch.from_numpy(lens))
    _close(got, want)
    pos = np.arange(32, 64)
    want = jref.masked_decode(*_jax(q[:, 32:64], k, v), spec=js, length=64,
                              q_positions=jnp.asarray(pos))
    got = masked_decode(*_torch(q[:, 32:64], k, v), spec=ts, length=64,
                        q_positions=torch.from_numpy(pos))
    _close(got, want)


def test_chunked_decode_equals_full_prefill():
    ts = tmask.MaskSpec("local", block=16, window=24)
    q, k, v = _torch(*_qkv(sq=96, seed=5))
    full = bs_attention(q, k, v, spec=ts, tile=(16, 16))
    for c0, c1 in ((0, 32), (32, 64), (64, 96)):
        out = bs_attention_decode(q[:, c0:c1], k, v, spec=ts, length=c1,
                                  q_positions=torch.arange(c0, c1))
        _close(out, full[:, c0:c1])


def test_decode_never_reads_past_length():
    js, ts = _specs(SPEC_ARGS[1])
    q, k, v = _qkv(sq=96, seed=6)
    L = 80
    full = bs_attention(*_torch(q[:, :L], k[:, :L], v[:, :L]), spec=ts,
                        tile=(16, 16))
    kg, vg = k.copy(), v.copy()
    kg[:, L:], vg[:, L:] = 1e3, -1e3
    out = bs_attention_decode(*_torch(q[:, L - 1:L], kg, vg), spec=ts,
                              length=L)
    _close(out, full[:, L - 1:L])
    want = jref.masked_decode(*_jax(q[:, L - 1:L], kg, vg), spec=js, length=L)
    _close(out, want)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def _last():
    return registry.last_dispatch("bs_attention").impl


def test_cpu_routes_the_gather_lowering_and_declines_on_budgets(monkeypatch):
    q, k, v = _torch(*_qkv(sq=128, seed=7))
    registry.clear_history()
    bs_attention(q, k, v, spec=tmask.MaskSpec("local", block=16, window=24),
                 tile=(16, 16))
    assert _last() == "torch_bs_attention"
    # near-dense: a single-block causal grid is density 1.0 > 0.9
    bs_attention(q[:, :32], k[:, :32], v[:, :32],
                 spec=tmask.MaskSpec("causal", block=32), tile=(32, 32))
    assert _last() == "masked_reference"
    # wasteful: window 4 inside 16-token tiles (waste ~7.6x > 4.0) ...
    wspec = tmask.MaskSpec("local", block=16, window=4)
    bs_attention(q, k, v, spec=wspec, tile=(16, 16))
    assert _last() == "masked_reference"
    assert "waste" in registry.last_dispatch("bs_attention").reason
    # ... and raising the budget re-admits the gather lowering
    monkeypatch.setenv("REPRO_BS_WASTE_LIMIT", "32")
    bs_attention(q, k, v, spec=wspec, tile=(16, 16))
    assert _last() == "torch_bs_attention"
    # force ignores the budgets
    monkeypatch.setenv("REPRO_BS_DENSITY_LIMIT", "0.1")
    bs_attention(q, k, v, spec=wspec, tile=(16, 16), policy="force")
    assert _last() == "torch_bs_attention"


def test_policy_off_and_untileable_fall_back_dense_on_the_cpu():
    q, k, v = _torch(*_qkv(sq=64, seed=8))
    spec = tmask.MaskSpec("local", block=16, window=24)
    registry.clear_history()
    bs_attention(q, k, v, spec=spec, policy="off")
    assert _last() == "masked_reference"
    bs_attention(q, k, v, spec=spec, tile=(12, 12))  # misaligned: no plan
    assert _last() == "masked_reference"
    assert registry.dispatch_counts() == {
        ("bs_attention", "masked_reference", "cpu"): 2}


def test_force_untileable_raises_maskforceerror():
    q, k, v = _torch(*_qkv(sq=64, seed=9))
    spec = tmask.MaskSpec("local", block=16, window=24)
    with pytest.raises(MaskForceError):
        bs_attention(q, k, v, spec=spec, policy="force", tile=(12, 12))
    empty_rows = tmask.MaskSpec("blockwise", block=16, blocks=((0, 0),),
                                causal=False)
    with pytest.raises(MaskForceError):
        bs_attention(q, k, v, spec=empty_rows, policy="force", tile=(16, 16))
    with pytest.raises(api.MaskForceError):
        api.explain_dispatch_attention(
            (2, 64, 4, 16), (2, 64, 2, 16), mask=empty_rows, policy="force",
            tile=(16, 16), device="cpu")
    assert issubclass(MaskForceError, registry.KernelForceError)


@pytest.mark.parametrize("args,sq", [
    (dict(kind="local", block=16, window=24), 64),
    (dict(kind="causal", block=32), 32),
    (dict(kind="strided", block=16, stride=2), 67),
], ids=["sparse", "dense-decline", "odd-strided"])
def test_explain_matches_execution_and_jax(args, sq):
    js, ts = _specs(args)
    arrays = _qkv(sq=sq, seed=10)
    tile = (ts.block, ts.block)
    dry = explain_dispatch_attention(arrays[0].shape, arrays[1].shape,
                                     mask=ts, tile=tile, device="cpu")
    registry.clear_history()
    bs_attention(*_torch(*arrays), spec=ts, tile=tile)
    wet = registry.last_dispatch("bs_attention")
    assert dry == wet
    jrec = japi.explain_dispatch_attention(arrays[0].shape, arrays[1].shape,
                                           mask=js, tile=tile)
    assert (dry.impl == "masked_reference") == (
        jrec.impl == "masked_reference")
    assert (dry.padded, dry.block) == (jrec.padded, jrec.block)


def test_explain_decode_family():
    rec = explain_dispatch_attention(
        (2, 1, 4, 16), (2, 64, 2, 16),
        mask=tmask.MaskSpec("local", block=16, window=24), decode=True,
        device="cpu")
    assert (rec.op, rec.impl, rec.backend) == (
        "bs_attention_decode", "masked_decode", "cpu")


def test_cuda_backend_auto_is_force():
    """The dry-run on the cuda backend (it launches nothing): auto picks
    the kernel even at density 1.0, and raises where it has none."""
    spec = tmask.MaskSpec("local", block=16, window=24)
    rec = explain_dispatch_attention((2, 32, 4, 16), (2, 32, 2, 16),
                                     mask=tmask.MaskSpec("causal", block=32),
                                     backend="cuda")
    assert (rec.impl, rec.backend, rec.block) == (
        "cuda_bs_attention", "cuda", (32, 32))
    rec = explain_dispatch_attention((2, 64, 4, 16), (2, 64, 2, 16),
                                     mask=tmask.MaskSpec("local", block=16,
                                                         window=4),
                                     backend="cuda")
    assert rec.impl == "cuda_bs_attention"  # waste 7.6x: no budget here
    for kw in (dict(tile=(12, 12)), dict(policy="force", tile=(12, 12))):
        with pytest.raises(MaskForceError, match="tileable"):
            explain_dispatch_attention((2, 64, 4, 16), (2, 64, 2, 16),
                                       mask=spec, backend="cuda", **kw)
    with pytest.raises(MaskForceError, match="no kernel build"):
        explain_dispatch_attention((2, 64, 4, 160), (2, 64, 2, 160),
                                   mask=spec, backend="cuda")
    with pytest.raises(MaskForceError, match="no kernel build"):
        explain_dispatch_attention((2, 64, 4, 16), (2, 64, 2, 16), mask=spec,
                                   backend="cuda", dtype=torch.float16)
    assert explain_dispatch_attention(
        (2, 64, 4, 16), (2, 64, 2, 16), mask=spec, backend="cuda",
        policy="off").impl == "masked_reference"
    assert explain_dispatch_attention(
        (2, 1, 4, 160), (2, 64, 2, 160), mask=spec, backend="cuda",
        decode=True).impl == "masked_decode"
    # without a device or backend the dry-run explains a call on the card
    assert explain_dispatch_attention((2, 64, 4, 16), (2, 64, 2, 16),
                                      mask=spec).backend == "cuda"


def test_backend_must_match_the_tensors():
    q, k, v = _torch(*_qkv(sq=32, seed=11))
    with pytest.raises(registry.KernelForceError, match="cannot serve"):
        bs_attention(q, k, v, spec=tmask.MaskSpec("causal", block=16),
                     backend="cuda")


def test_shape_validation():
    q, k, v = _torch(*_qkv(sq=32, seed=12))
    spec = tmask.MaskSpec("causal", block=16)
    with pytest.raises(ValueError, match="multiple of"):
        bs_attention(q[:, :, :3], k, v, spec=spec)
    with pytest.raises(ValueError, match="B, S, H, D"):
        bs_attention(q[0], k, v, spec=spec)
    with pytest.raises(TypeError, match="MaskSpec"):
        bs_attention(q, k, v, spec="causal")
    with pytest.raises(ValueError, match="policy mode"):
        bs_attention(q, k, v, spec=spec, policy="always")


# ---------------------------------------------------------------------------
# api.attention
# ---------------------------------------------------------------------------


def test_api_attention_prefill_and_cache_views_match_jax():
    js, ts = _specs(SPEC_ARGS[1])
    arrays = _qkv(sq=64, seed=13)
    q, k, v = _torch(*arrays)
    jq, jk, jv = _jax(*arrays)
    out = api.attention(q, k, v, mask=ts, tile=(16, 16))
    _close(out, japi.attention(jq, jk, jv, mask=js, tile=(16, 16)))
    out_d = api.attention(q[:, -1:], k, v, mask=ts,
                          cache=CacheView.decode(torch.tensor(63)))
    _close(out_d, japi.attention(jq[:, -1:], jk, jv, mask=js,
                                 cache=JaxCacheView.decode(jnp.int32(63))))
    _close(out_d, out[:, -1:])
    out_c = api.attention(q[:, 32:], k, v, mask=ts,
                          cache=CacheView.chunk(torch.tensor([32, 32])))
    _close(out_c, japi.attention(
        jq[:, 32:], jk, jv, mask=js,
        cache=JaxCacheView.chunk(jnp.asarray([32, 32], jnp.int32))))
    _close(out_c, out[:, 32:])


def test_api_attention_rejects_bad_cache_args():
    spec = tmask.MaskSpec("causal", block=16)
    q, k, v = _torch(*_qkv(sq=32, seed=14))
    with pytest.raises(TypeError, match="CacheView"):
        api.attention(q, k, v, mask=spec, cache={"mode": "decode"})
    with pytest.raises(ValueError, match="cache=None"):
        api.attention(q, k, v, mask=spec, cache=CacheView.train())
    with pytest.raises(ValueError, match="cache=None"):
        api.attention(q, k, v, mask=spec, cache=CacheView.prefill())


# ---------------------------------------------------------------------------
# reduced yi-9b with a local mask, on JAX's weights
# ---------------------------------------------------------------------------


def _masked(cfg, spec):
    (blk, rep), = cfg.plan
    mixer = dataclasses.replace(blk.mixer, mask=spec, window=None)
    return dataclasses.replace(
        cfg, plan=((dataclasses.replace(blk, mixer=mixer), rep),),
        sparsity=dataclasses.replace(cfg.sparsity, use_kernel=True))


def _numpy_tree(tree):
    """The JAX param tree as numpy, each NMWeight as the dict interop
    takes."""
    if isinstance(tree, JaxNMWeight):
        return {"vals": np.asarray(tree.vals), "idx": np.asarray(tree.idx),
                "n": tree.nm.n, "m": tree.nm.m, "axis": tree.axis,
                "mode": tree.kernel_policy.mode}
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def masked_yi():
    jcommon.set_compute_dtype(jnp.float32)
    jspec = jmask.MaskSpec("local", block=8, window=12)
    jlm = JaxLM(_masked(jax_reduced("yi-9b"), jspec))
    params = jlm.init(jax.random.PRNGKey(0))
    tcfg = _masked(get_reduced("yi-9b"), mask_from_jax(jspec))
    tlm = lm_from_jax(tcfg, _numpy_tree(params), dtype=torch.float32,
                      device="cpu")
    yield jlm, params, tlm
    jcommon.set_compute_dtype(jnp.bfloat16)


def test_masked_model_train_prefill_decode_match_jax(masked_yi):
    jlm, params, tlm = masked_yi
    toks = np.random.default_rng(15).integers(0, 512, (2, 16)).astype(
        np.int32)
    jl, _, _ = jlm.forward(params, jnp.asarray(toks))
    registry.clear_history()
    with torch.inference_mode():
        tl, _ = tlm(torch.from_numpy(toks))
    _close(tl, jl, LOGIT_TOL)
    assert registry.dispatch_counts("bs_attention") == {
        ("bs_attention", "torch_bs_attention", "cpu"): 2}
    jl, jc, _ = jlm.forward(params, jnp.asarray(toks),
                            view=JaxCacheView.prefill(),
                            caches=jlm.init_cache(2, 32, jnp.float32))
    with torch.inference_mode():
        tl, tc = tlm(torch.from_numpy(toks), view=CacheView.prefill(),
                     caches=tlm.init_cache(2, 32))
    _close(tl, jl, LOGIT_TOL)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    lens = np.array([16, 16], np.int32)
    jd, _, _ = jlm.forward(params, jnp.asarray(nxt),
                           view=JaxCacheView.decode(jnp.asarray(lens)),
                           caches=jc)
    registry.clear_history()
    with torch.inference_mode():
        td, _ = tlm(torch.from_numpy(nxt),
                    view=CacheView.decode(torch.from_numpy(lens)), caches=tc)
    _close(td, jd, LOGIT_TOL)
    assert registry.dispatch_counts("bs_attention") == {
        ("bs_attention_decode", "masked_decode", "cpu"): 2}


def test_masked_model_chunk_mode_matches_jax(masked_yi):
    jlm, params, tlm = masked_yi
    toks = np.random.default_rng(16).integers(0, 512, (2, 16)).astype(
        np.int32)
    jc = jlm.init_cache(2, 32, jnp.float32)
    tc = tlm.init_cache(2, 32)
    for c0 in (0, 8):
        lens = np.full(2, c0, np.int32)
        jl, jc, _ = jlm.forward(params, jnp.asarray(toks[:, c0:c0 + 8]),
                                view=JaxCacheView.chunk(jnp.asarray(lens)),
                                caches=jc)
        with torch.inference_mode():
            tl, tc = tlm(torch.from_numpy(toks[:, c0:c0 + 8]),
                         view=CacheView.chunk(torch.from_numpy(lens)),
                         caches=tc)
        _close(tl, jl, LOGIT_TOL)


def test_masked_greedy_streams_identical_to_jax_engine(masked_yi):
    jlm, params, tlm = masked_yi
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 512, size=int(rng.integers(5, 17))).astype(
        np.int32) for _ in range(5)]
    jeng = JaxServeEngine(jlm, params, slots=2, max_seq=32, prefill_len=16)
    teng = ServeEngine(tlm, slots=2, max_seq=32, prefill_len=16)
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p, max_new=3 + i % 3))
        teng.submit(Request(rid=i, prompt=p, max_new=3 + i % 3))
    registry.clear_history()
    want = {r.rid: r.out for r in jeng.run()}
    got = {r.rid: r.out for r in teng.run()}
    assert got == want and set(got) == set(range(5))
    counts = registry.dispatch_counts("bs_attention")
    assert counts[("bs_attention", "torch_bs_attention", "cpu")] > 0
    assert counts[("bs_attention_decode", "masked_decode", "cpu")] > 0
    assert ("bs_attention", "masked_reference", "cpu") not in counts
