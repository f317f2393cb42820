"""The port's RWKV-6 mixer and reduced rwkv6-3b against the JAX package
(``repro.models.rwkv``, ``repro.models.transformer``) on the CPU, at f32
on the same weights (the JAX trees handed over through
``repro_torch.interop``).

Tolerances: outputs, caches and logits 1e-4 (``LOGIT_TOL``: f32 sums in
another order through a few layers; |values| are O(1)); the loss 1e-5
relative (``GRAD_TOL``, as ``tests/test_torch_training.py`` holds
reduced deepseek's) and every gradient 5e-5 relative to its largest
entry (``SCAN_GRAD_TOL``): the backward through 16 steps of the WKV
recurrence sums more f32 products than attention's, and each side's f32
gradient lies up to 1.5e-5 from the same gradient taken in f64 (the
port in f64, measured on these weights), so the two may differ by 3e-5.

* The time-mix in train, prefill (from a zero cache and from a non-zero
  one) and decode, with the new cache leaves; the channel-mix; a write
  mask keeps the slots outside it.
* bf16 (``tests/test_torch_mamba.py``'s ``BF16_C``): the time-mix and
  channel-mix outputs against JAX's bf16 run, ``wkv`` (f32 from the same
  bf16 r, k, v and decay) and the token shifts within ``LOGIT_TOL``,
  every leaf's dtype JAX's; reduced rwkv6-3b's logits over a prefill and
  4 decode steps (``bf16_lm_check``), and its caches' dtypes.
* Reduced rwkv6-3b: prefill plus 4 decode steps, the caches after each;
  ``LM.loss`` and the gradient of every float parameter; the int8 model
  through ``quantize_tree`` (scales bit-equal to JAX's, logits); a JAX
  checkpoint read back by ``read_jax_checkpoint``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.configs.base import RWKVConfig as JaxRWKVConfig
from repro.configs.base import SparsityConfig as JaxSparsity
from repro.data.pipeline import DataPipeline as JaxPipeline
from repro.data.pipeline import PipelineConfig as JaxPipelineConfig
from repro.models import common as jcommon
from repro.models import rwkv as jrwkv
from repro.models.cache import CacheView as JaxCacheView
from repro.models.transformer import LM as JaxLM
from repro.optim.optimizer import adamw_init as jax_adamw_init
from repro.quant import quantize_tree as jax_quantize_tree
from repro.training.checkpoint import Checkpointer as JaxCheckpointer
from repro_torch.configs import get_reduced
from repro_torch.configs.base import RWKVConfig
from repro_torch.interop import lm_from_jax, mixer_from_jax
from repro_torch.kernels import registry
from repro_torch.models.cache import CacheView
from repro_torch.models.common import Linear
from repro_torch.models.rwkv import RWKV
from repro_torch.quant import QNMWeight, quantize_tree
from repro_torch.training import train_loop
from repro_torch.training.checkpoint import read_jax_checkpoint
from test_torch_mamba import (
    assert_bf16_as_close,
    bf16_params,
    jax_f32_and_bf16,
)
from test_torch_moe import numpy_tree
from test_torch_training import GRAD_TOL, _fill_idx

LOGIT_TOL = 1e-4
SCAN_GRAD_TOL = 5e-5
ARCH = "rwkv6-3b"
D, HEAD, FF = 64, 16, 128


@pytest.fixture(scope="module", autouse=True)
def f32_compute():
    jcommon.set_compute_dtype(jnp.float32)
    yield
    jcommon.set_compute_dtype(jnp.bfloat16)


def _close(got, want, tol=LOGIT_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def _mixer(seed=0):
    """A JAX RWKV tree (random LoRA b's and decay, so every term counts)
    and the port's module on the same weights."""
    jcfg = JaxRWKVConfig(head_dim=HEAD, decay_lora=8, mix_lora=4)
    key = jax.random.PRNGKey(seed)
    params = jrwkv.rwkv_init(key, D, jcfg, d_ff=FF,
                             sp=JaxSparsity(use_kernel=True))
    ks = jax.random.split(jax.random.fold_in(key, 7), 3)
    params["mix_lora_b"] = 0.3 * jax.random.normal(
        ks[0], params["mix_lora_b"].shape)
    params["decay_lora_b"] = 0.3 * jax.random.normal(
        ks[1], params["decay_lora_b"].shape)
    params["decay_base"] = jax.random.uniform(ks[2], (D,), minval=-6.0,
                                              maxval=0.5)
    tcfg = RWKVConfig(head_dim=HEAD, decay_lora=8, mix_lora=4)
    tm = mixer_from_jax(tcfg, numpy_tree(params), device="cpu")
    assert isinstance(tm, RWKV)
    return jcfg, params, tm


def _cache(b, seed, zero):
    rng = np.random.default_rng(seed)
    h = D // HEAD
    if zero:
        return {"wkv": np.zeros((b, h, HEAD, HEAD), np.float32),
                "tm_last": np.zeros((b, D), np.float32),
                "cm_last": np.zeros((b, D), np.float32)}
    return {"wkv": rng.standard_normal((b, h, HEAD, HEAD)).astype(
        np.float32) * 0.5,
            "tm_last": rng.standard_normal((b, D)).astype(np.float32),
            "cm_last": rng.standard_normal((b, D)).astype(np.float32)}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port_view(mode, b):
    if mode == "decode":
        return CacheView.decode(torch.full((b,), 3))
    return CacheView(mode=mode)


@pytest.mark.parametrize("mode,zero", [("train", True), ("prefill", True),
                                       ("prefill", False),
                                       ("decode", False)],
                         ids=["train", "prefill-zero", "prefill-state",
                              "decode"])
def test_time_and_channel_mix_match_jax(mode, zero):
    """The time-mix output and the new ``wkv`` / ``tm_last``; then the
    channel-mix of the residual stream and ``cm_last``."""
    jcfg, params, tm = _mixer()
    s = 1 if mode == "decode" else 7
    x = _x((2, s, D), seed=1)
    cache = None if mode == "train" else _cache(2, seed=2, zero=zero)
    jy, jc = jrwkv.rwkv_apply(
        params, jnp.asarray(x), jcfg, mode=mode,
        cache=None if cache is None else {k: jnp.asarray(v)
                                          for k, v in cache.items()})
    tc = (None if cache is None
          else {k: torch.from_numpy(v.copy()) for k, v in cache.items()})
    view = _port_view(mode, 2)
    with torch.inference_mode():
        ty = tm(torch.from_numpy(x), view=view, cache=tc)
    _close(ty, jy, msg="time-mix")
    if tc is not None:
        _close(tc["wkv"], jc["wkv"], msg="wkv")
        _close(tc["tm_last"], jc["tm_last"], msg="tm_last")
    # channel-mix on the residual stream, normed by cm_norm (as the JAX
    # block wrapper does)
    xr = x + np.asarray(jy)
    hm = jcommon.rmsnorm_apply(params["cm_norm"], jnp.asarray(xr))
    jcm, jlast = jrwkv.rwkv_channel_mix(
        params, hm, last=None if cache is None
        else jnp.asarray(cache["cm_last"]))
    with torch.inference_mode():
        tcm = tm.channel_mix(torch.from_numpy(xr), view=view, cache=tc)
    _close(tcm, jcm, msg="channel-mix")
    if tc is not None:
        _close(tc["cm_last"], jlast, msg="cm_last")


def same_dtypes(port: dict, jax_tree: dict) -> bool:
    return ({k: str(v.dtype).removeprefix("torch.") for k, v in port.items()}
            == {k: jnp.dtype(v.dtype).name for k, v in jax_tree.items()})


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_time_and_channel_mix_bf16_match_jax_bf16(mode):
    """bf16 weights and activations: both outputs at most BF16_C times as
    far from JAX's f32 answer as JAX's bf16 path; ``wkv``, ``tm_last``
    and ``cm_last`` equal to JAX's bf16 run's (LOGIT_TOL), in its
    dtypes."""
    jcfg, params, tm = _mixer()
    params = bf16_params(params)
    tm = mixer_from_jax(tm.cfg, numpy_tree(params), dtype=torch.bfloat16,
                        device="cpu")
    s = 1 if mode == "decode" else 7
    x = torch.from_numpy(_x((2, s, D), seed=1)).bfloat16()
    xr = torch.from_numpy(_x((2, s, D), seed=3)).bfloat16()  # residual
    cache = None if mode == "train" else _cache(2, seed=2, zero=False)

    def run(dt):
        jx, jxr = (jnp.asarray(a.float().numpy()).astype(dt) for a in (x, xr))
        jc = None if cache is None else {
            k: jnp.asarray(v).astype(jnp.float32 if k == "wkv" else dt)
            for k, v in cache.items()}
        jy, jc = jrwkv.rwkv_apply(params, jx, jcfg, mode=mode, cache=jc)
        hm = jcommon.rmsnorm_apply(params["cm_norm"], jxr)
        jcm, jlast = jrwkv.rwkv_channel_mix(
            params, hm, last=None if cache is None else jnp.asarray(
                cache["cm_last"]).astype(dt))
        return jy, jc, jcm, jlast

    (y32, _, cm32, _), (y16, c16, cm16, last16) = jax_f32_and_bf16(run)
    tc = None if cache is None else {
        k: torch.from_numpy(v.copy()).to(
            torch.float32 if k == "wkv" else torch.bfloat16)
        for k, v in cache.items()}
    view = _port_view(mode, 2)
    with torch.inference_mode():
        ty = tm(x, view=view, cache=tc)
        tcm = tm.channel_mix(xr, view=view, cache=tc)
    assert ty.dtype == tcm.dtype == torch.bfloat16
    assert y16.dtype == cm16.dtype == jnp.bfloat16
    assert_bf16_as_close(ty, y32, y16, "time-mix")
    assert_bf16_as_close(tcm, cm32, cm16, "channel-mix")
    if tc is not None:
        assert same_dtypes(tc, dict(c16, cm_last=last16))
        _close(tc["wkv"], c16["wkv"], msg="wkv")
        _close(tc["tm_last"].float(), c16["tm_last"], msg="tm_last")
        _close(tc["cm_last"].float(), last16, msg="cm_last")


def test_write_mask_keeps_the_other_slots():
    """A prefill under write mask [True, False] writes slot 0's state as
    an unmasked prefill does and leaves slot 1's as it was."""
    _, _, tm = _mixer()
    x = torch.from_numpy(_x((2, 5, D), seed=3))
    start = _cache(2, seed=4, zero=False)
    full = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    part = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    with torch.inference_mode():
        y_full = tm(x, view=CacheView.prefill(), cache=full)
        tm.channel_mix(x, view=CacheView.prefill(), cache=full)
        mask = torch.tensor([True, False])
        y_part = tm(x, view=CacheView.prefill(mask), cache=part)
        tm.channel_mix(x, view=CacheView.prefill(mask), cache=part)
    assert torch.equal(y_full, y_part)
    for k in start:
        assert torch.equal(part[k][0], full[k][0]), k
        assert torch.equal(part[k][1], torch.from_numpy(start[k][1])), k


def test_chunk_and_paged_views_are_refused():
    _, _, tm = _mixer()
    x = torch.zeros(1, 2, D)
    cache = {k: torch.from_numpy(v) for k, v in _cache(1, 0, True).items()}
    with pytest.raises(NotImplementedError, match="attention"):
        tm(x, view=CacheView.chunk(torch.tensor([0])), cache=cache)


def _with_kernels(cfg):
    return dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, use_kernel=True))


@pytest.fixture(scope="module")
def rwkv():
    """Reduced rwkv6-3b with the kernels' policy (on the CPU the port's
    wrappers run their plain versions)."""
    jlm = JaxLM(_with_kernels(jax_reduced(ARCH)))
    params = jlm.init(jax.random.PRNGKey(0))
    tlm = lm_from_jax(_with_kernels(get_reduced(ARCH)), numpy_tree(params),
                      device="cpu")
    return jlm, params, tlm


def test_configs_agree():
    j, t = jax_reduced(ARCH), get_reduced(ARCH)
    (jb, jr), = j.plan
    (tb, tr), = t.plan
    assert (j.vocab_size, j.d_model, j.n_layers, j.max_seq, j.pos_embed,
            jr) == (t.vocab_size, t.d_model, t.n_layers, t.max_seq,
                    t.pos_embed, tr)
    assert (jb.mixer.head_dim, jb.mixer.decay_lora, jb.mixer.mix_lora,
            jb.mlp.d_ff) == (tb.mixer.head_dim, tb.mixer.decay_lora,
                             tb.mixer.mix_lora, tb.mlp.d_ff)


def _lm_steps(jlm, params, tlm, toks, steps=4):
    """Prefill then ``steps`` greedy decode steps through both; logits and
    every cache leaf after each call."""
    b, s = toks.shape
    jc = jlm.init_cache(b, s + steps, jnp.float32)
    tc = tlm.init_cache(b, s + steps)
    jl, jc, _ = jlm.forward(params, jnp.asarray(toks),
                            view=JaxCacheView.prefill(), caches=jc)
    with torch.inference_mode():
        tl, tc = tlm(torch.from_numpy(toks), view=CacheView.prefill(),
                     caches=tc)
    def snap(tc):  # the port writes its caches in place
        return [{k: v.clone() for k, v in c.items()} for c in tc]

    outs = [(tl, jl, snap(tc), jc)]
    for i in range(steps):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        lens = np.full((b,), s + i, np.int32)
        jl, jc, _ = jlm.forward(params, jnp.asarray(nxt),
                                view=JaxCacheView.decode(jnp.asarray(lens)),
                                caches=jc)
        with torch.inference_mode():
            tl, tc = tlm(torch.from_numpy(nxt),
                         view=CacheView.decode(torch.from_numpy(lens)),
                         caches=tc)
        outs.append((tl, jl, snap(tc), jc))
    return outs


def _jax_layer_caches(jc, plan):
    """The JAX cache as one dict a layer (stacked groups unstacked)."""
    out = []
    for group, (entry, rep) in zip(jc, plan):
        for i in range(rep):
            for c in group:
                out.append({k: (v[i] if rep > 1 else v)
                            for k, v in c.items()})
    return out


def test_prefill_and_four_decode_steps_match_jax(rwkv):
    jlm, params, tlm = rwkv
    toks = np.random.default_rng(0).integers(0, 512, (2, 8)).astype(
        np.int32)
    registry.clear_history()
    for step, (tl, jl, tc, jc) in enumerate(_lm_steps(jlm, params, tlm,
                                                      toks)):
        _close(tl, jl, msg=f"logits, call {step}")
        for layer, (t, j) in enumerate(zip(tc, _jax_layer_caches(
                jc, jlm.cfg.plan))):
            assert set(t) == {"wkv", "tm_last", "cm_last"}
            assert t["wkv"].dtype == torch.float32
            for k in t:
                _close(t[k], j[k], msg=f"call {step} layer {layer} {k}")
    counts = registry.dispatch_counts()
    assert counts[("nm_matmul", "nm_spmm", "cpu")] > 0
    assert counts[("nm_matmul_decode", "nm_spmm_decode", "cpu")] > 0


def bf16_lm_check(jlm, params, tcfg, steps=4) -> None:
    """The port's model on ``params`` rounded to bf16, in bf16, against
    the JAX model on the same weights at its f32 and bf16 compute: a
    prefill of random tokens and ``steps`` decode steps on fed tokens
    (the same for all three), every call's logits at most BF16_C times as
    far from JAX's f32 ones as JAX's bf16 ones; the caches after the
    last call in the dtypes of JAX's empty bf16 cache (JAX's Mamba decode
    leaves its conv history in bf16; the port keeps it f32)."""
    params = bf16_params(params)
    tlm = lm_from_jax(tcfg, numpy_tree(params), dtype=torch.bfloat16,
                      device="cpu")
    b, s = 2, 8
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
    feed = rng.integers(0, tcfg.vocab_size, (steps, b, 1)).astype(np.int32)
    calls = [toks] + list(feed)

    def run(dt):
        jc = jlm.init_cache(b, s + steps, dt)
        views = [JaxCacheView.prefill()] + [JaxCacheView.decode(
            jnp.full((b,), s + i, jnp.int32)) for i in range(steps)]
        out = []
        for t, v in zip(calls, views):
            jl, jc, _ = jlm.forward(params, jnp.asarray(t), view=v,
                                    caches=jc)
            out.append(jl)
        return out, jc

    (l32, _), (l16, _) = jax_f32_and_bf16(run)
    tc = tlm.init_cache(b, s + steps)
    with torch.inference_mode():
        tl = [tlm(torch.from_numpy(toks), view=CacheView.prefill(),
                  caches=tc)[0]]
        for i in range(steps):
            tl.append(tlm(torch.from_numpy(feed[i]), view=CacheView.decode(
                torch.full((b,), s + i)), caches=tc)[0])
    for i, (t, a32, a16) in enumerate(zip(tl, l32, l16)):
        assert_bf16_as_close(t, a32, a16, f"logits, call {i}")
    for layer, (t, j) in enumerate(zip(tc, _jax_layer_caches(
            jlm.init_cache(b, s + steps, jnp.bfloat16), jlm.cfg.plan))):
        assert same_dtypes(t, j), f"layer {layer}"


def test_bf16_logits_as_close_to_f32_as_jax_bf16(rwkv):
    jlm, params, tlm = rwkv
    bf16_lm_check(jlm, params, tlm.cfg)


def test_train_view_logits_match_jax(rwkv):
    jlm, params, tlm = rwkv
    toks = np.random.default_rng(1).integers(0, 512, (2, 12)).astype(
        np.int32)
    jl, _, _ = jlm.forward(params, jnp.asarray(toks))
    with torch.inference_mode():
        tl, _ = tlm(torch.from_numpy(toks))
    _close(tl, jl)


def test_interop_layout(rwkv):
    """Two layers, each an RWKV mixer holding its channel-mix, no norm2
    or mlp; the N:M projections compressed, the LoRAs dense."""
    _, params, tlm = rwkv
    assert len(tlm.layers) == 2
    for i, layer in enumerate(tlm.layers):
        assert isinstance(layer.mixer, RWKV)
        assert layer.norm2 is None and layer.mlp is None
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o", "w_cm_k", "w_cm_v",
                     "w_cm_r"):
            lin = getattr(layer.mixer, name)
            want = params["groups"][0][0]["mixer"][name]
            assert lin.nm is not None, name
            np.testing.assert_array_equal(lin.vals.detach().numpy(),
                                          np.asarray(want.vals[i]))
        np.testing.assert_array_equal(
            layer.mixer.decay_lora_a.detach().numpy(),
            np.asarray(params["groups"][0][0]["mixer"]["decay_lora_a"][i]))


def test_loss_and_grads_match_jax():
    """``LM.loss`` of reduced rwkv6-3b and the gradient of every float
    parameter against ``jax.value_and_grad`` of the JAX ``LM.loss``
    (the JAX tests/test_arch_smoke.py train step), at f32."""
    jcfg = jax_reduced(ARCH)
    jlm = JaxLM(jcfg)
    params = jax.jit(jlm.init)(jax.random.PRNGKey(3))
    b = JaxPipeline(JaxPipelineConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                      global_batch=2)).next()
    (jl, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, {k: jnp.asarray(v) for k, v in b.items()}),
        has_aux=True, allow_int=True))(params)
    tlm = lm_from_jax(get_reduced(ARCH), numpy_tree(params), device="cpu")
    params_t = train_loop.trainable(tlm)
    tl, tparts = tlm.loss({k: torch.as_tensor(v) for k, v in b.items()})
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=GRAD_TOL)
    np.testing.assert_allclose(float(tparts["nll"].detach()),
                               float(jparts["nll"]), rtol=GRAD_TOL)
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


def test_int8_through_quantize_tree(rwkv):
    """``quantize_tree`` turns every compressed projection (5 time-mix, 3
    channel-mix a layer) into int8 with JAX's scales, bit-equal, and
    leaves the LoRAs, mixes, decay and bonus as they were; the int8
    model's logits match JAX's int8 model's."""
    jlm, params, _ = rwkv
    tcfg = _with_kernels(get_reduced(ARCH))
    tlm = quantize_tree(lm_from_jax(tcfg, numpy_tree(params), device="cpu"))
    qparams = jax_quantize_tree(params)
    want = lm_from_jax(tcfg, numpy_tree(qparams), device="cpu")
    pairs = [(a, b) for a, b in zip(tlm.modules(), want.modules())
             if isinstance(a, Linear) and b.nm is not None]
    assert len(pairs) == 2 * 8
    for got, ref in pairs:
        assert isinstance(got.weight, QNMWeight)
        assert torch.equal(got.scales, ref.scales)
        assert torch.equal(got.vals, ref.vals)
    base = lm_from_jax(tcfg, numpy_tree(params), device="cpu")
    for layer, ref in zip(tlm.layers, base.layers):
        for name in ("mu", "mix_lora_a", "mix_lora_b", "decay_base",
                     "decay_lora_a", "decay_lora_b", "bonus", "cm_mu"):
            assert torch.equal(getattr(layer.mixer, name),
                               getattr(ref.mixer, name)), name
    toks = np.random.default_rng(5).integers(0, 512, (2, 8)).astype(np.int32)
    for step, (tl, jl, _, _) in enumerate(_lm_steps(jlm, qparams, tlm, toks,
                                                    steps=2)):
        _close(tl, jl, msg=f"int8 logits, call {step}")


def test_jax_checkpoint_read_back(tmp_path):
    """A JAX checkpoint of reduced rwkv6-3b ({"params", "opt"}) read by
    ``read_jax_checkpoint``: equal logits on the same tokens, every
    moment in place."""
    jlm = JaxLM(jax_reduced(ARCH))
    params = jax.jit(jlm.init)(jax.random.PRNGKey(6))
    JaxCheckpointer(str(tmp_path)).save(
        3, {"params": params, "opt": jax_adamw_init(params)})
    toks = np.random.default_rng(6).integers(0, 512, (2, 8)).astype(np.int32)
    jl, _, _ = jlm.forward(params, jnp.asarray(toks))
    lm, opt, meta = read_jax_checkpoint(str(tmp_path), get_reduced(ARCH),
                                        device="cpu")
    assert meta["step"] == 3
    assert set(opt["m"]) == set(opt["v"]) == {
        n for n, _ in lm.named_parameters()}
    with torch.inference_mode():
        tl, _ = lm(torch.from_numpy(toks))
    _close(tl, jl)
