"""The port's MLA (DeepSeek-V2 multi-head latent attention) against the
JAX package's ``mla_apply`` on the CPU, and the block-sparse attention
family at MLA's head dims (dk 192 = nope 128 + rope 64, dv 128).

Weights are the JAX trees handed over through ``repro_torch.interop``
as numpy arrays; inputs come from numpy with a seed; everything runs in
f32 compute. Tolerances:

* the MLA layer, every mode (train, prefill, decode, chunk; slot and
  paged cache): 1e-5 (f32 products summed in another order, |y| O(1));
* fp8 (e4m3) latent cache, against JAX's fp8 run: prefill logits 1e-5;
  the cache bytes equal but for a latent at an e4m3 rounding midpoint
  (its f32 sums ran in another order), which takes the adjacent code;
  the decode on JAX's cache bytes 1e-5 (the port moves fp8 entries as
  bytes, exactly). JAX's own deepseek test that compares fp8's top-1
  with bf16's is no oracle (a near-tie flips it);
* a causal MaskSpec on every MLA layer of reduced deepseek against the
  dense causal model: 2e-4, as ``tests/test_blocksparse_attn.py``;
* attention at dk 192 / dv 128: f32 lowerings 1e-5 from JAX's TPU kernel
  in interpret mode; the bf16 kernel's twin ``blocksparse_mma`` within
  ``chip_smoke.py``'s bf16 tolerance 1e-2 of it and of the oracle.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.configs.base import AttnConfig as JaxAttnConfig
from repro.configs.base import SparsityConfig as JaxSparsityConfig
from repro.kernels.blocksparse_attn import mask as jmask
from repro.kernels.blocksparse_attn.kernel import run_bs_attention_tpu
from repro.models import common as jcommon
from repro.models.attention import mla_apply, mla_empty_cache, mla_init
from repro.models.cache import CacheView as JaxCacheView
from repro.models.transformer import LM as JaxLM
from repro_torch.configs import get_reduced
from repro_torch.configs.base import AttnConfig
from repro_torch.interop import lm_from_jax, mixer_from_jax
from repro_torch.kernels import autotune, registry
from repro_torch.kernels.blocksparse_attn import kernel as bkernel
from repro_torch.kernels.blocksparse_attn import mask as tmask
from repro_torch.kernels.blocksparse_attn.ops import (
    MaskForceError,
    explain_dispatch_attention,
)
from repro_torch.kernels.blocksparse_attn.ref import (
    blocksparse_mma,
    blocksparse_torch,
    masked_reference,
)
from repro_torch.models.attention import MLA
from repro_torch.models.cache import CacheView
from repro_torch.models.transformer import LM
from test_torch_moe import numpy_tree

TOL = 1e-5
MASK_TOL = 2e-4
BF16_TOL = 1e-2
D = 64
MLA_ARGS = dict(kind="mla", q_heads=4, kv_lora_rank=32, rope_head_dim=8,
                nope_head_dim=16, v_head_dim=16)


@pytest.fixture(scope="module", autouse=True)
def f32_compute():
    jcommon.set_compute_dtype(jnp.float32)
    yield
    jcommon.set_compute_dtype(jnp.bfloat16)


# ---------------------------------------------------------------------------
# the MLA layer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[None, 16], ids=["wq", "q_lora"])
def mla(request):
    """(JAX cfg, JAX params, port MLA): 2:4 projections, with or without
    q compression."""
    jcfg = JaxAttnConfig(q_lora_rank=request.param, **MLA_ARGS)
    params = mla_init(jax.random.PRNGKey(0), D, jcfg,
                      sp=JaxSparsityConfig(use_kernel=True))
    tmla = mixer_from_jax(AttnConfig(q_lora_rank=request.param, **MLA_ARGS),
                          numpy_tree(params), dtype=torch.float32,
                          device="cpu")
    return jcfg, params, tmla


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_step(jcfg, params, x, view, cache, positions):
    view = view.with_positions(jnp.asarray(positions))
    y, cache = mla_apply(params, jnp.asarray(x), jcfg, view=view,
                         cache=cache)
    return np.asarray(y), cache


@torch.inference_mode()
def _port_step(tmla, x, view, cache, positions):
    return tmla(torch.from_numpy(x), view=view.replace(
        positions=torch.from_numpy(np.asarray(positions))), cache=cache,
        rope_theta=10_000.0, chunk=512).numpy()


def _positions(cache_len, s):
    return np.asarray(cache_len)[:, None] + np.arange(s)[None, :]


def test_mla_train_matches_jax(mla):
    jcfg, params, tmla = mla
    x = _x((2, 12, D), 0)
    jy, _ = mla_apply(params, jnp.asarray(x), jcfg)
    with torch.inference_mode():
        ty = tmla(torch.from_numpy(x), view=CacheView.train(), cache=None,
                  rope_theta=10_000.0, chunk=4)
    assert isinstance(tmla, MLA)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)


def test_mla_slot_cache_matches_jax(mla):
    """Prefill 8 tokens, a chunk of 3 at per-slot offsets (8, 5), then a
    decode at (11, 8): y and the latent cache equal JAX's."""
    jcfg, params, tmla = mla
    jc = mla_empty_cache(2, 16, jcfg, jnp.float32)
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    x = _x((2, 8, D), 1)
    jy, jc = _jax_step(jcfg, params, x, JaxCacheView.prefill(), jc,
                       np.arange(8))
    ty = _port_step(tmla, x, CacheView.prefill(), tc, np.arange(8))
    np.testing.assert_allclose(ty, jy, rtol=TOL, atol=TOL)
    for mode, lens, s, seed in (("chunk", [8, 5], 3, 2),
                                ("decode", [11, 8], 1, 3)):
        x = _x((2, s, D), seed)
        lens = np.array(lens, np.int32)
        pos = _positions(lens, s)
        jview = getattr(JaxCacheView, mode)(jnp.asarray(lens))
        tview = getattr(CacheView, mode)(torch.from_numpy(lens))
        jy, jc = _jax_step(jcfg, params, x, jview, jc, pos)
        ty = _port_step(tmla, x, tview, tc, pos)
        np.testing.assert_allclose(ty, jy, rtol=TOL, atol=TOL, err_msg=mode)
    for name in ("ckv", "kr"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_mla_paged_cache_matches_jax(mla):
    """Pages of 4: two chunks of 4 through the block table (slot 1 outside
    the write mask in the second), then a decode; y and the page pools
    equal JAX's."""
    jcfg, params, tmla = mla
    table = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    jc = mla_empty_cache(7, 4, jcfg, jnp.float32)
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    steps = (("chunk", [0, 0], [True, True], 4, 4),
             ("chunk", [4, 4], [True, False], 4, 5),
             ("decode", [8, 4], [True, True], 1, 6))
    for mode, lens, mask, s, seed in steps:
        x = _x((2, s, D), seed)
        lens, mask = np.array(lens, np.int32), np.array(mask)
        pos = _positions(lens, s)
        jview = getattr(JaxCacheView, mode)(
            jnp.asarray(lens), block_table=jnp.asarray(table),
            write_mask=jnp.asarray(mask))
        tview = getattr(CacheView, mode)(
            torch.from_numpy(lens), torch.from_numpy(mask),
            block_table=torch.from_numpy(table))
        jy, jc = _jax_step(jcfg, params, x, jview, jc, pos)
        ty = _port_step(tmla, x, tview, tc, pos)
        np.testing.assert_allclose(ty, jy, rtol=TOL, atol=TOL, err_msg=mode)
    for name in ("ckv", "kr"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=TOL, atol=TOL, err_msg=name)


# ---------------------------------------------------------------------------
# reduced deepseek: fp8 cache, masked MLA
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def deepseek():
    jlm = JaxLM(jax_reduced("deepseek-v2-lite-16b"))
    params = jlm.init(jax.random.PRNGKey(0))
    tlm = lm_from_jax(get_reduced("deepseek-v2-lite-16b"), numpy_tree(params),
                      dtype=torch.float32, device="cpu")
    return jlm, params, tlm


def _jax_layers(caches, plan):
    """The JAX LM's cache (a list of leaf dicts per plan group, stacked
    on a leading layer axis where the group repeats) as one dict a
    layer."""
    out = []
    for group, (_, rep) in zip(caches, plan):
        for leaf in group:
            out += [leaf] if rep == 1 else [
                {k: v[i] for k, v in leaf.items()} for i in range(rep)]
    return out


def test_fp8_latent_cache_matches_jax(deepseek):
    """Prefill 16 tokens into an e4m3 ckv / kr cache, then one decode.

    Prefill logits equal JAX's. The cache bytes equal JAX's except where
    an f32 latent, summed in another order, lies at an e4m3 rounding
    midpoint: such a byte is the adjacent code, and they are rare. The
    decode, run on JAX's cache bytes, gives JAX's fp8 decode logits (the
    fp8 read path is exact). The cache bytes are half of bf16's."""
    jlm, params, tlm = deepseek
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                       512))
    jc = jlm.init_cache(2, 32, dtype=jnp.float8_e4m3fn)
    jp, jc, _ = jlm.forward(params, jnp.asarray(toks),
                            view=JaxCacheView.prefill(), caches=jc)
    nxt = np.array(jnp.argmax(jp[:, -1:], -1))
    jd, _, _ = jlm.forward(params, jnp.asarray(nxt), view=JaxCacheView.decode(
        jnp.int32(16)), caches=jc)
    fp8 = torch.float8_e4m3fn
    with torch.inference_mode():
        tc = tlm.init_cache(2, 32, dtype=fp8)
        tp, _ = tlm(torch.from_numpy(toks), view=CacheView.prefill(),
                    caches=tc)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp, np.float32),
                                   rtol=TOL, atol=TOL)
        jlayers = _jax_layers(jc, tlm.cfg.plan)
        assert len(jlayers) == len(tc)
        diff = total = 0
        for want, got in zip(jlayers, tc):
            assert set(got) == {"ckv", "kr"}
            for name, t in got.items():
                assert t.dtype == fp8
                jb = np.asarray(want[name]).view(np.uint8).astype(int)
                tb = t.view(torch.uint8).numpy().astype(int)
                assert (np.abs(jb - tb) <= 1).all(), name
                diff += int((jb != tb).sum())
                total += jb.size
                t.view(torch.uint8).copy_(torch.from_numpy(
                    jb.astype(np.uint8)))
        assert diff <= total // 1000, (diff, total)
        td, _ = tlm(torch.from_numpy(nxt).to(torch.int32),
                    view=CacheView.decode(torch.tensor(16)), caches=tc)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd, np.float32),
                               rtol=TOL, atol=TOL)
    b16 = sum(t.numel() * 2 for c in tlm.init_cache(2, 32, torch.bfloat16)
              for t in c.values())
    assert sum(t.numel() for c in tc for t in c.values()) * 2 == b16


def _mixers(lm, **kw):
    for layer in lm.layers:
        layer.mixer.cfg = dataclasses.replace(layer.mixer.cfg, **kw)


def test_model_mask_matches_dense_equivalent_mla_causal():
    """The mla-causal case of tests/test_blocksparse_attn.py through the
    port: MaskSpec("causal", block=8) on every MLA layer gives the dense
    causal logits (train, prefill, decode); train and prefill dispatch
    the bs_attention family, decode applies the predicate inline."""
    lm = LM.init(get_reduced("deepseek-v2-lite-16b"), seed=0,
                 dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (2, 16)))

    def run():
        with torch.inference_mode():
            full, _ = lm(toks)
            caches = lm.init_cache(2, 32)
            lp, caches = lm(toks, view=CacheView.prefill(), caches=caches)
            ld, _ = lm(lp[:, -1:].argmax(-1), caches=caches,
                       view=CacheView.decode(torch.tensor(16)))
        return full, lp, ld

    dense = run()
    _mixers(lm, mask=tmask.MaskSpec("causal", block=8), window=None)
    registry.clear_history()
    masked = run()
    counts = registry.dispatch_counts("bs_attention")
    assert sum(v for (_, impl, _), v in counts.items()
               if impl == "torch_bs_attention") == 2 * 3, counts
    assert not registry.dispatch_counts("bs_attention_decode")
    for m, d in zip(masked, dense):
        np.testing.assert_allclose(m.numpy(), d.numpy(), rtol=MASK_TOL,
                                   atol=MASK_TOL)


# ---------------------------------------------------------------------------
# bs_attention at MLA's head dims
# ---------------------------------------------------------------------------

MLA_DK, MLA_DV = 192, 128


def _qkv(sq, h=2, dk=MLA_DK, dv=MLA_DV, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((2, sq, h, dk), (2, sq, h, dk), (2, sq, h, dv)))


@pytest.mark.parametrize("args,sq", [
    (dict(kind="causal", block=16), 80),
    (dict(kind="local", block=16, window=40), 67)],
    ids=["causal16", "local16-w40"])
def test_lowerings_at_dk192_dv128_match_the_tpu_kernel(args, sq):
    """masked_reference, torch_bs_attention (f32) and the bf16 kernel's
    twin blocksparse_mma against JAX's _bs_attn_call in interpret mode,
    Hq = Hkv as MLA calls it, scale 192^-0.5."""
    js, ts = jmask.MaskSpec(**args), tmask.MaskSpec(**args)
    arrays = _qkv(sq, seed=3)
    scale = MLA_DK ** -0.5
    tplan = tmask.compile_mask(ts, sq, sq)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, TOL),
                          (jnp.bfloat16, torch.bfloat16, BF16_TOL)):
        want = np.asarray(run_bs_attention_tpu(
            *(jnp.asarray(a, jdt) for a in arrays), spec=js, scale=scale,
            plan=jmask.compile_mask(js, sq, sq), interpret=True), np.float32)
        tq = tuple(torch.from_numpy(a).to(tdt) for a in arrays)
        outs = [masked_reference(*tq, spec=ts, scale=scale),
                blocksparse_torch(*tq, plan=tplan, scale=scale)]
        if tdt == torch.bfloat16:
            outs.append(blocksparse_mma(*tq, plan=tplan, scale=scale))
        for got in outs:
            assert got.shape == (2, sq, 2, MLA_DV) and got.dtype == tdt
            np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                       atol=tol)
        # the wrapper on CPU tensors runs its plain version
        np.testing.assert_allclose(
            bkernel.bs_attention(*tq, tplan, scale).float().numpy(), want,
            rtol=tol, atol=tol)


@pytest.mark.parametrize("dk,dv,ok", [
    (192, 128, True), (128, 128, True), (64, 128, True), (192, 64, True),
    (193, 128, False), (192, 129, False), (256, 256, False)])
def test_host_head_dim_limits(dk, dv, ok):
    """dk up to 192 and dv up to 128 have a build; beyond either the cuda
    backend raises MaskForceError (auto is force there) and the wrapper's
    operand check raises; the cpu backend still serves."""
    spec = tmask.MaskSpec("causal", block=16)
    assert bkernel.has_build(torch.bfloat16, dk, dv) is ok
    assert bkernel.has_build(torch.float32, dk, dv) is ok
    assert not bkernel.has_build(torch.float16, dk, dv)
    shapes = ((2, 64, 16, dk), (2, 64, 16, dk))
    if ok:
        rec = explain_dispatch_attention(*shapes, mask=spec, backend="cuda",
                                         dtype=torch.bfloat16, dv=dv)
        assert rec.impl == "cuda_bs_attention"
    else:
        with pytest.raises(MaskForceError, match="no kernel build"):
            explain_dispatch_attention(*shapes, mask=spec, backend="cuda",
                                       dtype=torch.bfloat16, dv=dv)
        q, k, v = (torch.zeros(s) for s in (shapes[0], shapes[1],
                                            (2, 64, 16, dv)))
        with pytest.raises(ValueError, match="dk up to 192"):
            bkernel.check_operands(q, k, v, tmask.compile_mask(spec, 64, 64))
    assert explain_dispatch_attention(*shapes, mask=spec, backend="cpu",
                                      dv=dv).impl != "masked_decode"


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    autotune.clear_memory_cache()
    yield path
    autotune.clear_memory_cache()


def test_attention_tuner_takes_dv(tmp_cache, monkeypatch):
    """sweep_attn builds V at dv (not dk), keys the cache by dv, and the
    hot path finds the entry only at that dv."""
    shapes = []
    real = bkernel.bs_attention

    def spy(q, k, v, plan, scale=None):
        shapes.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return real(q, k, v, plan, scale)

    def timer(device):
        return lambda fn, repeats: {(8, 8): 0.1}.get(
            fn.__defaults__[0] if fn.__defaults__ else None, 1.0)

    monkeypatch.setattr(autotune, "_timer", timer)
    monkeypatch.setattr(bkernel, "bs_attention", spy)
    spec = tmask.MaskSpec("local", block=16, window=24)
    assert autotune.ensure_tuned_attn(64, 64, 24, spec, dv=16,
                                      heads=(2, 2)) == (8, 8)
    assert shapes and set(shapes) == {(24, 24, 16)}
    key, = json.loads(tmp_cache.read_text())
    assert f"|{spec.tag}|dv16|" in key and key.endswith("64x64x24")
    assert autotune.best_attn_tile(64, 64, 24, spec, dv=16) == (8, 8)
    assert autotune.best_attn_tile(64, 64, 24, spec) == \
        tmask.default_tile(spec, 64, 64)
    assert autotune.candidate_attn_tiles(spec, 64, 64, torch.bfloat16,
                                         192, 128)
    assert not autotune.candidate_attn_tiles(spec, 64, 64, torch.bfloat16,
                                             192, 192)


def test_engine_tunes_mla_attention_at_dk_and_dv(monkeypatch):
    """ServeEngine(autotune_blocks=True) on a masked MLA model asks the
    attention tuner for MLA's dk (nope + rope) and dv, with Hq = Hkv."""
    from repro_torch.serving.engine import ServeEngine

    calls = []
    monkeypatch.setattr(autotune, "ensure_tuned_attn",
                        lambda *a, **kw: calls.append((a, kw)))
    lm = LM.init(get_reduced("deepseek-v2-lite-16b"), seed=0,
                 dtype=torch.float32, device="cpu")
    lm.cfg = dataclasses.replace(lm.cfg, plan=tuple(
        (dataclasses.replace(blk, mixer=dataclasses.replace(
            blk.mixer, mask=tmask.MaskSpec("causal", block=8))), rep)
        for blk, rep in lm.cfg.plan))
    ServeEngine(lm, slots=2, max_seq=24, prefill_len=16,
                autotune_blocks=True)
    assert calls and all(
        a[:3] == (16, 16, 24) and kw["dv"] == 16 and kw["heads"] == (4, 4)
        for a, kw in calls)
