"""Reduced jamba-v0.1-52b (Mamba + attention + MoE, one 8-layer period)
against the JAX package on the CPU at f32, the serving engine on both
recurrent models (rwkv6-3b and jamba), and the launch helpers that walk
periods.

Tolerances: logits and caches 1e-4 (``LOGIT_TOL``), MoE outputs 1e-5
(``tests/test_torch_moe.py``'s ``TOL``), the loss 1e-5 relative and
every gradient 5e-5 relative to its largest entry (``SCAN_GRAD_TOL``:
the backward through the selective scan; see ``tests/test_torch_rwkv.py``).
Greedy token streams must be identical.

The engine zeroes a slot's recurrent state before a from-zero prefill
(``LM.reset_state``); the JAX engine starts that prefill from the
state the slot's last occupant left. So the first admission of each
slot gives the JAX engine's stream, and a request served after another
in the same slot gives the stream it has when served alone.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.data.pipeline import DataPipeline as JaxPipeline
from repro.data.pipeline import PipelineConfig as JaxPipelineConfig
from repro.models import common as jcommon
from repro.models.moe import _moe_apply_local
from repro.models.transformer import LM as JaxLM
from repro.quant import quantize_tree as jax_quantize_tree
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import AttnConfig, MambaConfig
from repro_torch.interop import lm_from_jax
from repro_torch.kernels.blocksparse_attn.mask import MaskSpec
from repro_torch.launch.profile_decode import decode_weight_bytes, state_bytes
from repro_torch.launch.serve import build_model, cut_plan
from repro_torch.models.attention import CacheLenError
from repro_torch.models.cache import CacheView
from repro_torch.models.mamba import Mamba
from repro_torch.models.moe import MoE, capacity
from repro_torch.models.rwkv import rwkv_empty_cache
from repro_torch.models.transformer import LM
from repro_torch.quant import quantize_tree
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.training import train_loop
from test_torch_hybrid_witness import check_f32_witness
from test_torch_moe import TOL, _pair, _port, _x, numpy_tree
from test_torch_rwkv import (
    SCAN_GRAD_TOL,
    _jax_layer_caches,
    _lm_steps,
    bf16_lm_check,
)
from test_torch_training import GRAD_TOL, _fill_idx

LOGIT_TOL = 1e-4
JAMBA, RWKV6 = "jamba-v0.1-52b", "rwkv6-3b"
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def f32_compute():
    jcommon.set_compute_dtype(jnp.float32)
    yield
    jcommon.set_compute_dtype(jnp.bfloat16)


def _close(got, want, tol=LOGIT_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def _with_kernels(cfg):
    return dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, use_kernel=True))


@pytest.fixture(scope="module")
def jamba():
    jlm = JaxLM(_with_kernels(jax_reduced(JAMBA)))
    params = jlm.init(jax.random.PRNGKey(0))
    tlm = lm_from_jax(_with_kernels(get_reduced(JAMBA)), numpy_tree(params),
                      device="cpu")
    return jlm, params, tlm


# ---------------------------------------------------------------------------
# configs and the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_jamba_configs_agree(reduced):
    from repro.configs import get_config as jax_config

    j = (jax_reduced if reduced else jax_config)(JAMBA)
    t = (get_reduced if reduced else get_config)(JAMBA)
    assert (j.vocab_size, j.d_model, j.n_layers, j.max_seq, j.pos_embed) == (
        t.vocab_size, t.d_model, t.n_layers, t.max_seq, t.pos_embed)
    (jp, jr), = j.plan
    (tp, tr), = t.plan
    assert jr == tr and len(jp) == len(tp) == 8
    for jb, tb in zip(jp, tp):
        assert type(jb.mixer).__name__ == type(tb.mixer).__name__
        assert dataclasses.asdict(jb.mixer).items() >= {
            k: v for k, v in dataclasses.asdict(tb.mixer).items()
            if k != "mask"}.items()
        assert dataclasses.asdict(jb.mlp) == dataclasses.asdict(tb.mlp)


def test_learned_positions_are_refused():
    """The guard on ``pos_embed``: learned positions (whisper's) are
    ported now and pass it; a kind the JAX package lacks is refused."""
    cfg = dataclasses.replace(get_reduced(RWKV6), pos_embed="learned")
    assert cfg.pos_embed == "learned"
    with pytest.raises(ValueError, match="pos_embed"):
        dataclasses.replace(get_reduced(RWKV6), pos_embed="sinusoidal")


def test_interop_unstacks_the_period(jamba):
    """Eight layers in the period's order: attention at 4, Mamba elsewhere,
    MoE on odd layers without a shared expert, FFN on even ones."""
    _, _, tlm = jamba
    kinds = [(type(layer.mixer).__name__, type(layer.mlp).__name__)
             for layer in tlm.layers]
    assert kinds == [("GQA" if i == 4 else "Mamba",
                      "MoE" if i % 2 else "FFN") for i in range(8)]
    assert all(layer.mlp.shared is None for layer in tlm.layers
               if isinstance(layer.mlp, MoE))


def test_prefill_and_four_decode_steps_match_jax(jamba):
    jlm, params, tlm = jamba
    toks = np.random.default_rng(0).integers(0, 512, (2, 8)).astype(
        np.int32)
    for step, (tl, jl, tc, jc) in enumerate(_lm_steps(jlm, params, tlm,
                                                      toks)):
        _close(tl, jl, msg=f"logits, call {step}")
        for layer, (t, j) in enumerate(zip(tc, _jax_layer_caches(
                jc, jlm.cfg.plan))):
            assert set(t) == ({"k", "v"} if layer == 4 else {"conv", "ssm"})
            for k in t:
                _close(t[k], j[k], msg=f"call {step} layer {layer} {k}")


def test_bf16_logits_as_close_to_f32_as_jax_bf16(jamba):
    """bf16 weights and activations over a prefill and 4 decode steps
    (``tests/test_torch_rwkv.py``'s ``bf16_lm_check``)."""
    jlm, params, tlm = jamba
    bf16_lm_check(jlm, params, tlm.cfg)


def test_train_view_logits_match_jax(jamba):
    jlm, params, tlm = jamba
    toks = np.random.default_rng(1).integers(0, 512, (2, 12)).astype(
        np.int32)
    jl, _, _ = jlm.forward(params, jnp.asarray(toks))
    with torch.inference_mode():
        tl, _ = tlm(torch.from_numpy(toks))
    _close(tl, jl)


def test_loss_and_grads_match_jax():
    """``LM.loss`` (nll plus the MoE aux) of reduced jamba and the gradient
    of every float parameter against the JAX ``LM.loss``'s, at f32."""
    jcfg = jax_reduced(JAMBA)
    jlm = JaxLM(jcfg)
    params = jax.jit(jlm.init)(jax.random.PRNGKey(2))
    b = JaxPipeline(JaxPipelineConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                      global_batch=2)).next()
    (jl, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, {k: jnp.asarray(v) for k, v in b.items()}),
        has_aux=True, allow_int=True))(params)
    tlm = lm_from_jax(get_reduced(JAMBA), numpy_tree(params), device="cpu")
    params_t = train_loop.trainable(tlm)
    tl, tparts = tlm.loss({k: torch.as_tensor(v) for k, v in b.items()})
    assert float(jparts["aux"]) > 0
    for got, want in ((tl, jl), (tparts["nll"], jparts["nll"]),
                      (tparts["aux"], jparts["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=GRAD_TOL)
    tg = torch.autograd.grad(tl, list(params_t.values()))
    tree = numpy_tree(jax.tree.map(
        lambda g: g if jnp.issubdtype(g.dtype, jnp.floating) else
        np.zeros(g.shape, np.int8), jg))
    _fill_idx(tree, numpy_tree(params))
    want = dict(lm_from_jax(tlm.cfg, tree, device="cpu").named_parameters())
    assert set(want) == set(params_t)
    for (name, _), g in zip(params_t.items(), tg):
        w = want[name].detach()
        scale = float(w.abs().max()) or 1.0
        np.testing.assert_allclose(g.numpy() / scale, w.numpy() / scale,
                                   rtol=0, atol=SCAN_GRAD_TOL, err_msg=name)


def test_int8_through_quantize_tree(jamba):
    """Every compressed projection (Mamba's 3, attention's 4, each FFN's
    and expert's 3) int8 with JAX's scales; w_dt and the routers dense;
    logits of the int8 model against JAX's int8 model."""
    jlm, params, _ = jamba
    tcfg = _with_kernels(get_reduced(JAMBA))
    tlm = quantize_tree(lm_from_jax(tcfg, numpy_tree(params), device="cpu"))
    qparams = jax_quantize_tree(params)
    want = lm_from_jax(tcfg, numpy_tree(qparams), device="cpu")
    quantized = [m for m in tlm.modules() if getattr(m, "quantized", False)]
    assert len(quantized) == 7 * 3 + 4 + 4 * 3 + 4 * 4 * 3
    for layer, ref in zip(tlm.layers, want.layers):
        if isinstance(layer.mixer, Mamba):
            assert not layer.mixer.w_dt.quantized
            assert torch.equal(layer.mixer.w_x.scales, ref.mixer.w_x.scales)
    toks = np.random.default_rng(5).integers(0, 512, (2, 8)).astype(np.int32)
    for step, (tl, jl, _, _) in enumerate(_lm_steps(jlm, qparams, tlm, toks,
                                                    steps=2)):
        _close(tl, jl, msg=f"int8 logits, call {step}")


@pytest.mark.parametrize("tokens", [16, 4], ids=["prefill", "decode"])
def test_moe_without_shared_expert_matches_jax(tokens):
    """jamba's MoE: no shared expert, top-2 of 16, at the capacity of a
    prefill and a decode step (M = slots x prefill_len, M = slots)."""
    jcfg, params, tmoe = _pair(e=16, k=2, dexp=64, shared=0)
    assert tmoe.shared is None and "shared" not in params
    x = _x((1, tokens, 32), seed=tokens)
    jy, jaux = _moe_apply_local(params, jnp.asarray(x), jcfg)
    ty, taux = _port(tmoe, x)
    np.testing.assert_allclose(ty, np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(taux, float(jaux), rtol=TOL, atol=TOL)
    moe = get_config(JAMBA).plan[0][0][1].mlp
    assert (capacity(4, moe), capacity(512, moe)) == (8, 80)


# ---------------------------------------------------------------------------
# cache bounds
# ---------------------------------------------------------------------------


def test_bound_comes_from_the_attention_cache(jamba):
    """jamba's bound is its attention layer's cache length (layer 4; the
    Mamba caches' second dim is d_conv - 1); rwkv has none, so a decode
    past any length the cache was made for runs."""
    _, _, tlm = jamba
    caches = tlm.init_cache(1, 12)
    assert tuple(tlm.attn_cache(caches).shape[:2]) == (1, 12)
    tok = torch.zeros((1, 1), dtype=torch.long)
    with torch.inference_mode():
        tlm(tok, view=CacheView.decode(torch.tensor([11])), caches=caches)
        with pytest.raises(CacheLenError):
            tlm(tok, view=CacheView.decode(torch.tensor([12])), caches=caches)
        rwkv = LM.init(get_reduced(RWKV6), dtype=torch.float32, device="cpu")
        caches = rwkv.init_cache(1, 4)
        assert rwkv.attn_cache(caches) is None
        logits, _ = rwkv(tok, view=CacheView.decode(torch.tensor([500])),
                         caches=caches)
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """Both recurrent models, the JAX one (reference policy) and the port's
    on the same weights."""
    out = {}
    for arch in (RWKV6, JAMBA):
        jlm = JaxLM(jax_reduced(arch))
        params = jlm.init(jax.random.PRNGKey(1))
        out[arch] = (jlm, params, lm_from_jax(get_reduced(arch),
                                              numpy_tree(params),
                                              device="cpu"))
    return out


def _serve(make, req_cls, prompts, max_new, **kw):
    eng = make(**kw)
    for i, p in enumerate(prompts):
        eng.submit(req_cls(rid=i, prompt=p.copy(), max_new=max_new))
    return {r.rid: tuple(r.out) for r in eng.run()}


def _engines(arch, engines):
    jlm, params, tlm = engines[arch]
    return (lambda **kw: JaxServeEngine(jlm, params, **kw),
            lambda **kw: ServeEngine(tlm, **kw))


@pytest.mark.parametrize("arch", [RWKV6, JAMBA])
def test_first_admission_of_each_slot_equals_jax(engines, arch):
    """One request a slot (a short prompt left-padded): the port's greedy
    streams are the JAX engine's."""
    jax_eng, port_eng = _engines(arch, engines)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 512, size=n).astype(np.int32) for n in (8, 5)]
    kw = dict(slots=2, max_seq=32, prefill_len=8)
    want = _serve(jax_eng, JaxRequest, prompts, 6, **kw)
    assert _serve(port_eng, Request, prompts, 6, **kw) == want


@pytest.mark.parametrize("arch", [RWKV6, JAMBA])
def test_request_after_another_in_one_slot_equals_it_alone(engines, arch):
    """slots=1, greedy, 6 new tokens, prompts A and B from default_rng(0):
    B served after A gives B's stream served alone (and JAX's stream of B
    alone): the prefill zeroed the slot's state. The JAX engine's B after
    A differs from its B alone on rwkv6-3b (its prefill starts from A's
    state); on jamba the decaying Mamba state leaves its greedy tokens
    as they are."""
    jax_eng, port_eng = _engines(arch, engines)
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, 512, size=8).astype(np.int32) for _ in range(2))
    kw = dict(slots=1, max_seq=32, prefill_len=8)
    after = _serve(port_eng, Request, [a, b], 6, **kw)
    alone = _serve(port_eng, Request, [b], 6, **kw)
    assert after[1] == alone[0]
    assert _serve(jax_eng, JaxRequest, [b], 6, **kw)[0] == alone[0]
    if arch == RWKV6:
        assert _serve(jax_eng, JaxRequest, [a, b], 6, **kw)[1] != alone[0]


@pytest.mark.parametrize("arch", [RWKV6, JAMBA])
@pytest.mark.parametrize("kw", [dict(prefill_chunk=4), dict(paged=True)],
                         ids=["chunked", "paged"])
def test_chunked_and_paged_are_refused(engines, arch, kw):
    _, _, tlm = engines[arch]
    with pytest.raises(NotImplementedError, match="attention"):
        ServeEngine(tlm, slots=1, max_seq=32, prefill_len=8, **kw)


def test_reset_state_zeroes_only_the_masked_slots(engines):
    _, _, tlm = engines[JAMBA]
    caches = tlm.init_cache(2, 8)
    for c in caches:
        for v in c.values():
            v.fill_(1.0)
    tlm.reset_state(caches, torch.tensor([True, False]))
    for layer, c in zip(tlm.layers, caches):
        attn = isinstance(layer.block.mixer, AttnConfig)
        for v in c.values():
            assert float(v[0].abs().sum()) == (v[0].numel() if attn else 0)
            assert bool((v[1] == 1).all())


# ---------------------------------------------------------------------------
# launch helpers: periods, masks, GEMM counts, the decode floor
# ---------------------------------------------------------------------------


def test_cut_plan_counts_a_periods_blocks():
    plan = get_config(JAMBA).plan
    period = plan[0][0]
    assert cut_plan(plan, 8) == ((period, 1),)
    assert cut_plan(plan, 4) == ((period[:4], 1),)
    assert cut_plan(plan, 12) == ((period, 1), (period[:4], 1))
    assert cut_plan(plan, 40) == ((period, 5),)
    ds = get_config("deepseek-v2-lite-16b").plan
    assert cut_plan(ds, 4) == ((ds[0][0], 1), (ds[1][0], 3))
    cfg = dataclasses.replace(get_config(JAMBA), plan=cut_plan(plan, 12))
    assert cfg.n_layers == len(cfg.blocks()) == 12


def test_mask_goes_on_the_attention_of_a_period_only():
    spec = MaskSpec("local", block=8, window=16)
    cfg, lm = build_model(JAMBA, full=False, kernels=True, device="cpu",
                          dtype=torch.float32, mask=spec)
    for i, blk in enumerate(cfg.blocks()):
        if i == 4:
            assert isinstance(blk.mixer, AttnConfig)
            assert blk.mixer.mask == spec and blk.mixer.window is None
        else:
            assert isinstance(blk.mixer, MambaConfig)
    assert lm.layers[4].mixer.cfg.mask == spec


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v2-lite-16b", RWKV6,
                                  JAMBA])
def test_gemms_per_step_counts_every_mixer(arch):
    """chip_smoke.py's count from the config's shapes equals the model's
    compressed Linears (reduced), and at full width: rwkv6-3b 32 x 8,
    one jamba period 7 x 3 (Mamba) + 4 (attention) + 4 x 3 (FFN) + 4 x
    16 x 3 (experts)."""
    cs = _chip_smoke()
    cfg = get_reduced(arch)
    lm = LM.init(cfg, dtype=torch.float32, device="cpu")
    assert cs.gemms_per_step(cfg) == cs.compressed_linears(lm)
    full = {RWKV6: 32 * 8, JAMBA: 7 * 3 + 4 + 4 * 3 + 4 * 16 * 3}
    if arch in full:
        cut = get_config(arch)
        if arch == JAMBA:
            cut = dataclasses.replace(cut, plan=cut_plan(cut.plan, 8))
        assert cs.gemms_per_step(cut) == full[arch]


@pytest.mark.parametrize("arch", [RWKV6])
@pytest.mark.parametrize("scale", [None, 1 + 2 ** -6],
                         ids=["kernels", "kernels-off"])
def test_f32_witness(arch, scale, monkeypatch):
    """``launch/witness.py`` on reduced bf16 rwkv6-3b
    (``test_torch_hybrid_witness.check_f32_witness``; jamba's cases, the
    slowest of this file, are in ``tests/test_torch_hybrid_witness.py``)."""
    check_f32_witness(arch, scale, monkeypatch)


def test_decode_floor_adds_the_recurrent_state():
    """The state a decode step reads and writes: rwkv6-3b at 4 slots
    32 x 4 x 40 x 64 x 64 x 4 B of WKV state (83.9 MB) plus the token
    shifts in bf16; a jamba period's 7 Mamba layers 7 x 4 x (8192 x 16 +
    3 x 8192) x 4 B."""
    cfg = get_config(RWKV6)
    mx = cfg.plan[0][0].mixer
    one = sum(t.numel() * t.element_size() for t in rwkv_empty_cache(
        4, cfg.d_model, mx, torch.bfloat16, "meta").values())
    assert one * 32 == 32 * 4 * 40 * 64 * 64 * 4 + 32 * 2 * 4 * 2560 * 2
    lm = LM.init(get_reduced(RWKV6), dtype=torch.float32, device="cpu")
    st = state_bytes(lm, 4)
    assert st == 2 * 4 * (4 * 32 * 32 + 2 * 128) * 4
    assert decode_weight_bytes(lm, slots=4) == decode_weight_bytes(lm) + 2 * st
    jamba = LM.init(get_reduced(JAMBA), dtype=torch.float32, device="cpu")
    assert state_bytes(jamba, 4) == 7 * 4 * (256 * 8 + 3 * 256) * 4


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", [RWKV6, JAMBA])
def test_remat_runs_through_the_time_loops(arch, remat):
    """``LM.loss`` with each layer a checkpoint region: the recomputed
    forward (the scans' loops again) gives the same loss and gradients
    as without remat."""
    lm = LM.init(get_reduced(arch), dtype=torch.float32, device="cpu")
    params = train_loop.trainable(lm)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, 512, (2, 10)))
    batch = {"tokens": toks, "labels": toks}
    out = {}
    for mode in ("none", remat):
        loss, _ = lm.loss(batch, remat=mode)
        out[mode] = (loss.detach(), torch.autograd.grad(
            loss, list(params.values())))
    torch.testing.assert_close(out[remat][0], out["none"][0], rtol=0,
                               atol=0)
    for got, want in zip(out[remat][1], out["none"][1]):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
