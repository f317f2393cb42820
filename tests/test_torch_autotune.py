"""The port's launch autotuner (``repro_torch.kernels.autotune``) against
the JAX package's autotune tests (``tests/test_dispatch_padding.py``
autotune cache, ``tests/test_quant.py`` int8 keys and the engine's
warm-up walk), on the CPU.

The kernels do not run here, so nothing is timed for real: the tests
replace the timer (``autotune._timer``), as the JAX tests replace
``ensure_tuned``, and the candidates run the wrappers' plain versions.
Without a replaced timer a CPU sweep gives the rule's launch and writes
nothing. Beside the cache: the plan a dispatch record names is the tile
(or decode launch) handed to the launcher; a pinned block wins and one
that names no launch is refused; no sweep runs while a graph is
captured; every decode candidate's plain twin equals JAX's TPU decode
kernel in interpret mode on the integer lattice (exact: every split
order sums integers below 2^24).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jax_autotune
from repro.kernels.blocksparse_attn.mask import MaskSpec as JaxMaskSpec
from repro_torch.core.nmweight import KernelPolicy, NMWeight
from repro_torch.core.sparsity import NMConfig, apply_mask, compress_nm, \
    prune_mask_nm
from repro_torch.kernels import autotune, padding, registry
from repro_torch.kernels.blocksparse_attn.mask import MaskSpec
from repro_torch.kernels.blocksparse_attn.ops import bs_attention
from repro_torch.kernels.indexmac import ops
from repro_torch.kernels.indexmac.ops import nm_matmul
from repro_torch.kernels.indexmac.ref import nm_decode_split_ref
from repro_torch.quant import quantize_nm
from test_torch_decode_design import _jax_decode, _t, _weights, _x

CFG = NMConfig(2, 4)


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    autotune.clear_memory_cache()
    yield path
    autotune.clear_memory_cache()


@pytest.fixture
def fake_timer(monkeypatch):
    """A timer for the CPU: each candidate's ms from ``ms`` (by block),
    else 1.0; ``calls`` lists the blocks timed."""
    ms, calls = {}, []

    def timer(device):
        def time_ms(fn, repeats):
            blk = fn.__defaults__[0] if fn.__defaults__ else None
            calls.append(blk)
            return ms.get(blk, 1.0)
        return time_ms

    monkeypatch.setattr(autotune, "_timer", timer)
    return ms, calls


def _weight(k, n, dtype=torch.float32, seed=0, policy="auto", **pol):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(k, n, generator=g)
    vals, idx = compress_nm(apply_mask(w, prune_mask_nm(w, CFG)), CFG)
    return NMWeight(vals.to(dtype), idx, CFG,
                    kernel_policy=KernelPolicy(policy, **pol))


def _x32(m, k, seed=1):
    return torch.randn(m, k, generator=torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------


def test_autotune_persists_and_reloads(tmp_cache, fake_timer):
    ms, _ = fake_timer
    small = (128, 32, 32)
    ms[small] = 0.5
    block = autotune.tune(64, 128, 256, CFG)
    assert block == small
    on_disk = json.loads(tmp_cache.read_text())
    assert list(on_disk.values()) == [[128, 32, 32]]
    assert list(on_disk)[0] == \
        "v1|cpu|0|prefill|float32|float32|2:4|64x256x128"
    # a fresh in-memory state reloads from disk
    autotune.clear_memory_cache()
    assert autotune.cached_block(64, 128, 256, CFG, torch.float32) == small
    assert autotune.best_block(64, 128, 256, CFG, torch.float32) == small


def test_best_block_defaults_without_tuning(tmp_cache):
    """A miss takes the rule, and the call launches the rule's tile."""
    assert autotune.best_block(8192, 1024, 64, CFG, torch.float32) == \
        padding.prefill_block(CFG, 8192, 1024, torch.float32, torch.float32)
    assert autotune.best_block(4, 512, 4096, CFG, torch.bfloat16,
                               "decode") == \
        padding.decode_block(CFG, 4, 4096, 512, 2)
    registry.clear_history()
    nm_matmul(_x32(64, 256), _weight(256, 128))
    assert registry.last_dispatch("nm_matmul").block == \
        padding.prefill_block(CFG, 64, 128, torch.float32, torch.float32)
    assert not tmp_cache.exists()


def test_cpu_ensure_tuned_gives_the_rule_and_writes_nothing(tmp_cache):
    assert autotune.ensure_tuned(64, 128, 256, CFG, torch.float32) == \
        padding.prefill_block(CFG, 64, 128, torch.float32, torch.float32)
    assert autotune.ensure_tuned(4, 128, 256, CFG, torch.int8, "decode",
                                 x_dtype=torch.bfloat16) == \
        padding.decode_block(CFG, 4, 256, 128, 1)
    spec = MaskSpec("local", block=16, window=24)
    assert autotune.ensure_tuned_attn(64, 64, 16, spec) == (16, 16)
    assert not tmp_cache.exists()


def test_nm_matmul_uses_cached_block(tmp_cache, fake_timer):
    ms, _ = fake_timer
    ms[(128, 32, 32)] = 0.1
    autotune.tune(8192, 1024, 64, CFG)
    registry.clear_history()
    nm_matmul(_x32(8192, 64), _weight(64, 1024))
    rec = registry.last_dispatch("nm_matmul")
    assert rec.impl == "nm_spmm" and rec.block == (128, 32, 32)


def test_autotune_env_sweeps_inline(tmp_cache, fake_timer, monkeypatch):
    """REPRO_AUTOTUNE=1: a miss sweeps inside the call, stores the winner
    and launches it; the next call is a hit."""
    ms, calls = fake_timer
    ms[(128, 32, 32)] = 0.1
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    registry.clear_history()
    nm_matmul(_x32(8192, 64), _weight(64, 1024))
    assert registry.last_dispatch("nm_matmul").block == (128, 32, 32)
    assert sorted(calls) == [(128, 32, 32), (128, 128, 32)]
    assert list(json.loads(tmp_cache.read_text()).values()) == [
        [128, 32, 32]]
    nm_matmul(_x32(8192, 64), _weight(64, 1024))
    assert len(calls) == 2  # a hit: no second sweep


def test_no_sweep_while_a_graph_is_captured(tmp_cache, fake_timer,
                                            monkeypatch):
    """Under capture a miss takes the rule even with REPRO_AUTOTUNE=1, and
    the record says so."""
    _, calls = fake_timer
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    monkeypatch.setattr(autotune, "_capturing", lambda: True)
    registry.clear_history()
    nm_matmul(_x32(8192, 64), _weight(64, 1024))
    rec = registry.last_dispatch("nm_matmul")
    assert rec.block == padding.prefill_block(CFG, 8192, 1024,
                                              torch.float32, torch.float32)
    assert autotune.CAPTURE_NOTE in rec.reason
    assert not calls and not tmp_cache.exists()


def test_int8_autotune_keys_are_their_own_family(tmp_cache, fake_timer):
    """An int8 winner is stored under its own key, invisible to the float
    family (and to another x dtype)."""
    blk_q = autotune.tune(8, 128, 128, CFG, dtype=torch.int8,
                          candidates=[(128, 32, 32)], repeats=1)
    assert blk_q == (128, 32, 32)
    assert autotune.cached_block(8, 128, 128, CFG, torch.int8) == blk_q
    assert autotune.cached_block(8, 128, 128, CFG, torch.float32) is None
    assert autotune.cached_block(8, 128, 128, CFG, torch.int8,
                                 x_dtype=torch.bfloat16) is None
    key, = json.loads(tmp_cache.read_text())
    assert "|prefill|float32|int8|2:4|8x128x128" in key


def test_jax_cache_is_never_touched(tmp_path, monkeypatch, fake_timer):
    jax_file = tmp_path / "jax.json"
    jax_file.write_text(json.dumps({
        "v2|cpu|tpu|float32|2:4|64x256x128": [64, 128, 256]}))
    before = jax_file.read_text()
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(jax_file))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "port.json"))
    autotune.clear_memory_cache()
    assert autotune.cache_path() != jax_autotune.cache_path()
    assert autotune.cached_block(64, 128, 256, CFG, torch.float32) is None
    autotune.tune(64, 128, 256, CFG)
    assert jax_file.read_text() == before
    assert (tmp_path / "port.json").exists()
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    assert autotune.cache_path().endswith(
        "/.cache/repro_torch/autotune.json")
    autotune.clear_memory_cache()


# ---------------------------------------------------------------------------
# the launched plan is the routed plan; pinned blocks
# ---------------------------------------------------------------------------


def _spy(monkeypatch):
    """Fake launchers: record what each wrapper is handed, run its plain
    version."""
    seen = []
    for name in ("nm_spmm", "nm_spmm_q"):
        orig = getattr(ops, name)

        def fake(*a, tile, _orig=orig, **kw):
            seen.append(("tile", tile))
            return _orig(*a, **kw)
        monkeypatch.setattr(ops, name, fake)
    for name in ("nm_spmm_decode", "nm_spmm_decode_q"):
        orig = getattr(ops, name)

        def fake(*a, plan, _orig=orig, **kw):
            seen.append(("plan", plan))
            return _orig(*a, **kw)
        monkeypatch.setattr(ops, name, fake)
    return seen


def test_pinned_small_tile_is_launched_where_the_rule_takes_the_large(
        tmp_cache, monkeypatch):
    """The repair: the tile a record names is the tile the launcher gets.
    M = 8192, N = 1024 fills the card with 128 x 128 tiles, so the rule
    takes them; the policy pins 128 x 32."""
    seen = _spy(monkeypatch)
    assert padding.prefill_tile(8192, 1024, CFG, torch.float32,
                                torch.float32) == (128, 128)
    w = _weight(64, 1024, block=[128, 32, 32])
    assert w.kernel_policy.block == (128, 32, 32)  # normalised to a tuple
    registry.clear_history()
    nm_matmul(_x32(8192, 64), w)
    assert registry.last_dispatch("nm_matmul").block == (128, 32, 32)
    assert seen == [("tile", (128, 32))]
    seen.clear()
    q = quantize_nm(_weight(64, 1024))
    nm_matmul(_x32(8192, 64), q)
    assert seen == [("tile", registry.last_dispatch("nm_matmul_q").block[:2])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_record_names_the_launched_plan(tmp_cache, monkeypatch,
                                               dtype):
    seen = _spy(monkeypatch)
    k, n = 4096, 512
    w = _weight(k, n, dtype)
    registry.clear_history()
    nm_matmul(_x32(4, k).to(dtype), w)
    rec = registry.last_dispatch("nm_matmul_decode")
    (_, plan), = seen
    assert rec.block == (plan.rows, plan.cols, plan.span)
    assert plan == padding.decode_plan(4, k, n, CFG, dtype.itemsize)
    # a pinned decode launch: every candidate is launched as named
    for p in padding.decode_candidates(4, k, n, CFG, dtype.itemsize)[:4]:
        seen.clear()
        pinned = _weight(k, n, dtype, decode_block=(p.rows, p.cols, p.span))
        nm_matmul(_x32(4, k).to(dtype), pinned)
        assert seen == [("plan", p)]
        assert registry.last_dispatch("nm_matmul_decode").block == \
            (p.rows, p.cols, p.span)


def test_pinned_block_naming_no_launch_is_refused(tmp_cache):
    x = _x32(64, 256)
    for bad in ((64, 64, 32), (128, 32, 16)):
        registry.clear_history()
        nm_matmul(x, _weight(256, 128, block=bad))  # auto on the cpu
        rec = registry.last_dispatch("nm_matmul")
        assert rec.impl == "reference" and "names no launch" in rec.reason
        with pytest.raises(registry.KernelForceError, match="names no"):
            nm_matmul(x, _weight(256, 128, policy="force", block=bad))
    for bad in ((4, 256, 1022), (4, 100, 1024), (2, 256, 1024)):
        with pytest.raises(registry.KernelForceError, match="names no"):
            nm_matmul(_x32(4, 4096),
                      _weight(4096, 512, policy="force", decode_block=bad))


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------


def test_prefill_candidates_are_the_fitting_tiles():
    for nm in (NMConfig(2, 4), NMConfig(1, 4), NMConfig(7, 8)):
        for xd in (torch.float32, torch.bfloat16):
            cands = padding.prefill_candidates(nm, 512, 4096, xd, xd)
            assert padding.prefill_block(nm, 512, 4096, xd, xd) in cands
            path = padding.prefill_path(nm, xd, xd)
            assert all(padding.prefill_smem(c[:2], path, nm, xd, xd)
                       <= padding.PREFILL_SMEM_MAX for c in cands)
    # f32 x with f32 vals at 7:8 fits only the small tile
    assert padding.prefill_candidates(
        NMConfig(7, 8), 8192, 1024, torch.float32, torch.float32) == [
        (128, 32, 32)]


@pytest.mark.parametrize("kn", [(4096, 512), (4096, 11008), (11008, 4096)],
                         ids=lambda s: "K%dN%d" % s)
@pytest.mark.parametrize("itemsize", [2, 1])
def test_decode_rule_picks_among_the_candidates(kn, itemsize):
    k, n = kn
    cands = padding.decode_candidates(4, k, n, CFG, itemsize)
    assert padding.decode_plan(4, k, n, CFG, itemsize) in cands
    slots = padding.NUM_SMS * padding.decode_ctas_per_sm(itemsize)
    assert all(c.ctas <= slots for c in cands) or all(
        c.ctas > slots for c in cands)
    for c in cands:
        assert padding.decode_launch((c.rows, c.cols, c.span), 4, k, n, CFG,
                                     itemsize) == c


@pytest.mark.parametrize("nm", [(2, 4), (1, 4)], ids=["2:4", "1:4"])
def test_every_decode_candidate_twin_equals_the_jax_kernel(nm):
    """Each decode launch the tuner may choose sums K in its own split
    order; on the lattice every one equals JAX's TPU decode kernel
    (interpret mode) bit for bit, float and int8 values."""
    k, n, m = 3072, 264, 4
    vals, idx, jnm = _weights(k, n, nm, seed=5, lattice=True)
    x = _x(m, k, seed=5, lattice=True)
    cfg = NMConfig(*nm)
    want = _jax_decode(x, vals, idx, jnm, None, None)
    scales = np.full(n, 2.0 ** -6, np.float32)
    want_q = _jax_decode(x, vals.astype(np.int8), idx, jnm, None, None,
                         scales)
    for itemsize in (4, 1):
        cands = padding.decode_candidates(m, k, n, cfg, itemsize)
        assert len({c.splits for c in cands}) > 1
        for c in cands:
            if itemsize == 4:
                got = nm_decode_split_ref(_t(x), _t(vals), _t(idx), None,
                                          None, cfg, None, c)
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                got = nm_decode_split_ref(
                    _t(x), _t(vals.astype(np.int8)), _t(idx), _t(scales),
                    None, cfg, None, c)
                np.testing.assert_array_equal(got.numpy(), want_q)


# ---------------------------------------------------------------------------
# bs_attn family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    (dict(kind="local", block=64, window=192), 1024),
    (dict(kind="causal", block=32), 200),
    (dict(kind="strided", block=64, stride=4), 1000),
    (dict(kind="local", block=16, window=24), 64),
], ids=["local64", "causal32", "strided64", "local16"])
def test_attention_candidates_equal_jax(case):
    kw, s = case
    assert autotune.candidate_attn_tiles(MaskSpec(**kw), s, s) == \
        jax_autotune.candidate_attn_tiles(JaxMaskSpec(**kw), s, s)


def test_attention_tile_is_tuned_and_used(tmp_cache, fake_timer):
    ms, _ = fake_timer
    spec = MaskSpec("local", block=16, window=24)
    ms[(8, 8)] = 0.1
    q = torch.randn(1, 64, 4, 16)
    kv = torch.randn(1, 64, 4, 16)
    assert autotune.tune_attn(64, 64, 16, spec) == (8, 8)
    registry.clear_history()
    bs_attention(q, kv, kv, spec=spec)
    assert registry.last_dispatch("bs_attention").block == (8, 8)
    key, = json.loads(tmp_cache.read_text())
    assert "|bs_attn|float32|float32|" in key and key.endswith("64x64x16")


# ---------------------------------------------------------------------------
# the engine's warm-up walk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_autotune_blocks_walks_every_compressed_leaf(monkeypatch, quantize):
    """``autotune_blocks=True`` asks for every compressed GEMM shape the
    JAX engine's warm-up asks for (the same weights), int8 keys for int8
    weights, the decode family at M <= 8."""
    import dataclasses

    import jax

    from repro.configs import get_reduced as jax_reduced
    from repro.models.transformer import LM as JaxLM
    from repro.serving.engine import ServeEngine as JaxServeEngine
    from repro_torch.configs import get_reduced
    from repro_torch.interop import lm_from_jax
    from repro_torch.serving.engine import ServeEngine
    from test_torch_model import numpy_tree

    def kern(cfg):
        return dataclasses.replace(cfg, sparsity=dataclasses.replace(
            cfg.sparsity, use_kernel=True))

    jlm = JaxLM(kern(jax_reduced("yi-9b")))
    params = jlm.init(jax.random.PRNGKey(0))
    want = []
    monkeypatch.setattr(
        jax_autotune, "ensure_tuned",
        lambda m, n, k, nm, dtype=None, family="", backend="tpu":
            want.append((m, n, k, nm.tag, jnp.dtype(dtype).name,
                         family or "prefill")) or (8, 128, 128))
    from repro.models import common as jcommon

    jcommon.set_compute_dtype(jnp.float32)  # the port's model is f32
    try:
        JaxServeEngine(jlm, params, slots=2, max_seq=64, prefill_len=8,
                       autotune_blocks=True, quantize=quantize)
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)
    tlm = lm_from_jax(kern(get_reduced("yi-9b")), numpy_tree(params),
                      dtype=torch.float32, device="cpu")
    asked = []
    monkeypatch.setattr(
        autotune, "ensure_tuned",
        lambda m, n, k, nm, dtype, family="prefill", **kw:
            asked.append((m, n, k, nm.tag, str(dtype).removeprefix(
                "torch."), family)) or (128, 32, 32))
    ServeEngine(tlm, slots=2, max_seq=64, prefill_len=8,
                autotune_blocks=True, quantize=quantize)
    assert asked and sorted(asked) == sorted(want)
    assert all(a[4] == ("int8" if quantize else "float32") for a in asked)
