"""Reduced whisper-medium (the encoder-decoder: an encoder over frame
embeddings, learned positions, cross-attention in every decoder block)
against the JAX package on the CPU at f32, on the same weights through
``repro_torch.interop``; the port's serving path for it
(``make_serve_steps`` with ``enc_input``), the engine's refusal, the
cache's cross leaves, and a JAX-written checkpoint read back.

Tolerances: the encoder's output, logits and cache leaves 1e-4
(``LOGIT_TOL``, as ``tests/test_torch_hybrid.py``); the loss 1e-5
relative and every gradient 1e-5 relative to its largest entry
(``GRAD_TOL``, ``tests/test_torch_training.py``'s); int8 logits 1e-4.
Greedy token streams must be identical.

The JAX references are computed once a module (``jax_ref``): a train
forward, a prefill and 4 greedy decode steps with every cache leaf
after each call, and an int8 prefill.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.data.pipeline import DataPipeline as JaxPipeline
from repro.data.pipeline import PipelineConfig as JaxPipelineConfig
from repro.models import common as jcommon
from repro.models.cache import CacheView as JaxCacheView
from repro.models.transformer import LM as JaxLM
from repro.optim.optimizer import adamw_init as jax_adamw_init
from repro.quant import quantize_tree as jax_quantize_tree
from repro.training.checkpoint import Checkpointer as JaxCheckpointer
from repro_torch.configs import get_reduced
from repro_torch.interop import lm_from_jax
from repro_torch.models.attention import CacheLenError
from repro_torch.models.cache import CacheView
from repro_torch.serving.engine import ServeEngine, make_serve_steps
from repro_torch.training import train_loop
from repro_torch.training.checkpoint import read_jax_checkpoint
from test_torch_moe import numpy_tree
from test_torch_rwkv import _jax_layer_caches
from test_torch_training import GRAD_TOL, _fill_idx

LOGIT_TOL = 1e-4
WHISPER = "whisper-medium"
B, S, STEPS = 2, 8, 4


def _close(got, want, tol=LOGIT_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def _with_kernels(cfg):
    return dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, use_kernel=True))


def _inputs(seed=0):
    cfg = get_reduced(WHISPER)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    enc = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    return toks, enc


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX model, its params, the port's model on them, and JAX's
    answers: encode, train logits, prefill + STEPS greedy decode steps
    (logits, the tokens fed, every layer's cache after each call) and
    an int8 prefill."""
    jcommon.set_compute_dtype(jnp.float32)
    try:
        jlm = JaxLM(_with_kernels(jax_reduced(WHISPER)))
        params = jax.jit(jlm.init)(jax.random.PRNGKey(0))
        toks, enc = _inputs()
        ref = {"toks": toks, "enc": enc}
        ref["encode"] = np.asarray(jlm.encode(params, jnp.asarray(enc)))
        ref["train"] = np.asarray(jlm.forward(
            params, jnp.asarray(toks), enc_input=jnp.asarray(enc))[0])
        jc = jlm.init_cache(B, S + STEPS, jnp.float32)
        jl, jc, _ = jlm.forward(params, jnp.asarray(toks),
                                view=JaxCacheView.prefill(), caches=jc,
                                enc_input=jnp.asarray(enc))
        calls = [(np.asarray(jl), None, _jax_layer_caches(
            jax.tree.map(np.asarray, jc), jlm.cfg.plan))]
        for i in range(STEPS):
            nxt = np.argmax(calls[-1][0][:, -1], -1).astype(np.int32)[:, None]
            lens = np.full((B,), S + i, np.int32)
            jl, jc, _ = jlm.forward(params, jnp.asarray(nxt),
                                    view=JaxCacheView.decode(
                                        jnp.asarray(lens)), caches=jc)
            calls.append((np.asarray(jl), nxt, _jax_layer_caches(
                jax.tree.map(np.asarray, jc), jlm.cfg.plan)))
        ref["calls"] = calls
        qparams = jax_quantize_tree(params)
        ref["int8"] = np.asarray(jlm.forward(
            qparams, jnp.asarray(toks), view=JaxCacheView.prefill(),
            caches=jlm.init_cache(B, S, jnp.float32),
            enc_input=jnp.asarray(enc))[0])
        ref["qtree"] = numpy_tree(qparams)
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)
    tlm = lm_from_jax(_with_kernels(get_reduced(WHISPER)),
                      numpy_tree(params), device="cpu")
    return jlm, params, tlm, ref


def test_interop_builds_the_encoder_and_cross_blocks(jax_ref):
    _, _, tlm, _ = jax_ref
    cfg = tlm.cfg
    assert len(tlm.enc_layers) == len(cfg.encoder_blocks()) == 2
    assert len(tlm.layers) == cfg.n_layers == 2
    assert all(layer.cross is not None for layer in tlm.layers)
    assert all(layer.cross is None for layer in tlm.enc_layers)
    assert tlm.pos.table.shape == (cfg.max_seq, cfg.d_model)
    assert tlm.enc_pos.table.shape == (cfg.encoder_seq, cfg.d_model)
    assert tlm.enc_embed is None and tlm.lm_head is not None


@pytest.mark.parametrize("what", ["encode", "train"])
def test_encode_and_train_logits_match_jax(jax_ref, what):
    _, _, tlm, ref = jax_ref
    enc = torch.from_numpy(ref["enc"])
    with torch.inference_mode():
        got = (tlm.encode(enc) if what == "encode" else
               tlm(torch.from_numpy(ref["toks"]), enc_input=enc)[0])
    _close(got, ref[what])


def _port_calls(tlm, ref):
    """The port's prefill and decode steps on JAX's fed tokens: (logits,
    every layer's cache leaves) after each call."""
    cache = tlm.init_cache(B, S + STEPS)
    out = []
    with torch.inference_mode():
        for i, (_, nxt, _) in enumerate(ref["calls"]):
            if i == 0:
                tl, _ = tlm(torch.from_numpy(ref["toks"]),
                            view=CacheView.prefill(), caches=cache,
                            enc_input=torch.from_numpy(ref["enc"]))
            else:
                lens = torch.full((B,), S + i - 1)
                tl, _ = tlm(torch.from_numpy(nxt),
                            view=CacheView.decode(lens), caches=cache)
            out.append((tl.clone(), [{k: v.clone() for k, v in c.items()}
                                     for c in cache]))
    return out


def test_prefill_and_four_decode_steps_match_jax(jax_ref):
    """The cross K/V written at prefill (equal to JAX's) are what decode
    reads: every call's logits and every cache leaf, self and cross."""
    _, _, tlm, ref = jax_ref
    for step, ((tl, tc), (jl, _, jc)) in enumerate(zip(
            _port_calls(tlm, ref), ref["calls"])):
        _close(tl, jl, msg=f"logits, call {step}")
        for layer, (t, j) in enumerate(zip(tc, jc)):
            assert set(t) == set(j) == {"k", "v", "cross_k", "cross_v"}
            for k in t:
                _close(t[k], j[k], msg=f"call {step} layer {layer} {k}")


def test_make_serve_steps_prefill_with_enc_input(jax_ref):
    """``make_serve_steps``' prefill with ``enc_input`` gives JAX's last
    logits, and its decode step after it JAX's first decode logits."""
    _, _, tlm, ref = jax_ref
    prefill, decode = make_serve_steps(tlm)
    caches = tlm.init_cache(B, S + STEPS)
    with torch.inference_mode():
        last = prefill(caches, tokens=ref["toks"], enc_input=ref["enc"])
        _close(last, ref["calls"][0][0][:, -1])
        nxt = ref["calls"][1][1]
        step = decode(caches, tokens=nxt, cache_len=np.full((B,), S))
        _close(step, ref["calls"][1][0][:, 0])
        with pytest.raises(ValueError, match="encoder_seq"):
            prefill(caches, tokens=ref["toks"], enc_input=ref["enc"][:, :4])
    assert prefill.built and decode.built


def test_learned_positions_at_a_vector_cache_len(jax_ref):
    """A decode step whose slots sit at different offsets: each slot's
    learned position row (JAX's ``pos[cache_len[:, None] + arange]``)."""
    jlm, params, tlm, ref = jax_ref
    lens = np.array([S, S - 3], np.int32)
    nxt = ref["calls"][1][1]
    jcommon.set_compute_dtype(jnp.float32)
    try:
        jc = jlm.init_cache(B, S + STEPS, jnp.float32)
        _, jc, _ = jlm.forward(params, jnp.asarray(ref["toks"]),
                               view=JaxCacheView.prefill(), caches=jc,
                               enc_input=jnp.asarray(ref["enc"]))
        jl, _, _ = jlm.forward(params, jnp.asarray(nxt),
                               view=JaxCacheView.decode(jnp.asarray(lens)),
                               caches=jc)
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)
    cache = tlm.init_cache(B, S + STEPS)
    with torch.inference_mode():
        tlm(torch.from_numpy(ref["toks"]), view=CacheView.prefill(),
            caches=cache, enc_input=torch.from_numpy(ref["enc"]))
        tl, _ = tlm(torch.from_numpy(nxt),
                    view=CacheView.decode(torch.from_numpy(lens)),
                    caches=cache)
    _close(tl, jl)


def test_positions_past_the_learned_table_are_refused(jax_ref):
    _, _, tlm, _ = jax_ref
    cache = tlm.init_cache(B, 2 * tlm.cfg.max_seq)
    with pytest.raises(CacheLenError):
        tlm(torch.zeros((B, 1), dtype=torch.long),
            view=CacheView.decode(torch.full((B,), tlm.cfg.max_seq)),
            caches=cache)


def test_int8_prefill_matches_jax_quantize_tree(jax_ref):
    """Every compressed projection (encoder, self and cross attention,
    FFN) int8 with JAX's scales; the head and tables stay float."""
    _, _, _, ref = jax_ref
    qlm = lm_from_jax(_with_kernels(get_reduced(WHISPER)), ref["qtree"],
                      device="cpu")
    assert {m.quantized for m in qlm.modules()
            if getattr(m, "nm", None) is not None} == {True}
    with torch.inference_mode():
        tl, _ = qlm(torch.from_numpy(ref["toks"]), view=CacheView.prefill(),
                    caches=qlm.init_cache(B, S),
                    enc_input=torch.from_numpy(ref["enc"]))
    _close(tl, ref["int8"])


def test_attn_cache_is_the_self_attention_k(jax_ref):
    """The serving steps' bound reads the self-attention ``k`` (S =
    max_seq), never a cross block's ``cross_k`` (S = encoder_seq)."""
    _, _, tlm, _ = jax_ref
    caches = tlm.init_cache(B, 40)
    first = tlm.attn_cache(caches)
    assert first is caches[0]["k"] and first.shape[1] == 40
    assert caches[0]["cross_k"].shape[1] == tlm.cfg.encoder_seq
    # a cache dict whose cross leaves come first reads the same
    caches[0] = {"cross_k": caches[0]["cross_k"],
                 "cross_v": caches[0]["cross_v"], "k": caches[0]["k"],
                 "v": caches[0]["v"]}
    assert tlm.attn_cache(caches) is caches[0]["k"]


def test_cross_kv_rows_outside_the_write_mask_are_kept(jax_ref):
    """A prefill under a write mask writes the cross K/V of the admitted
    slots only; the others keep what they held; ``reset_state`` leaves
    the cross leaves alone."""
    _, _, tlm, ref = jax_ref
    caches = tlm.init_cache(B, S + STEPS)
    enc = torch.from_numpy(ref["enc"])
    toks = torch.from_numpy(ref["toks"])
    with torch.inference_mode():
        tlm(toks, view=CacheView.prefill(), caches=caches, enc_input=enc)
        before = [{k: v.clone() for k, v in c.items()} for c in caches]
        tlm.reset_state(caches, torch.tensor([True, True]))
        for c, b in zip(caches, before):
            assert torch.equal(c["cross_k"], b["cross_k"])
        tlm(toks.flip(0), view=CacheView.prefill(
            write_mask=torch.tensor([False, True])), caches=caches,
            enc_input=enc.flip(0))
    for c, b in zip(caches, before):
        for k in ("cross_k", "cross_v"):
            assert torch.equal(c[k][0], b[k][0])
            assert torch.equal(c[k][1], b[k][0])  # slot 1 now has slot 0's
            assert not torch.equal(c[k][1], b[k][1])


def test_engine_refuses_an_encoder_decoder(jax_ref):
    _, _, tlm, _ = jax_ref
    with pytest.raises(NotImplementedError, match="make_serve_steps"):
        ServeEngine(tlm, slots=2, max_seq=16, prefill_len=8)


def test_forward_needs_enc_input_at_train_and_prefill(jax_ref):
    _, _, tlm, ref = jax_ref
    with pytest.raises(ValueError, match="enc_input"):
        tlm(torch.from_numpy(ref["toks"]))


def test_loss_and_grads_match_jax():
    """``LM.loss`` with ``enc_input`` and the gradient of every float
    parameter (encoder, cross blocks, both position tables) against the
    JAX ``LM.loss``'s, at f32."""
    jcfg = jax_reduced(WHISPER)
    jlm = JaxLM(jcfg)
    params = jax.jit(jlm.init)(jax.random.PRNGKey(2))
    b = JaxPipeline(JaxPipelineConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                      global_batch=2)).next()
    b["enc_input"] = np.random.default_rng(3).standard_normal(
        (2, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    jcommon.set_compute_dtype(jnp.float32)
    try:
        (jl, jparts), jg = jax.value_and_grad(
            lambda p: jlm.loss(p, {k: jnp.asarray(v) for k, v in b.items()}),
            has_aux=True, allow_int=True)(params)
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)
    tlm = lm_from_jax(get_reduced(WHISPER), numpy_tree(params), device="cpu")
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
    assert any(n.startswith("enc_layers.") for n in want)
    assert {"pos.table", "enc_pos.table"} <= set(want)
    for (name, _), g in zip(params_t.items(), tg):
        w = want[name].detach()
        scale = float(w.abs().max()) or 1.0
        np.testing.assert_allclose(g.numpy() / scale, w.numpy() / scale,
                                   rtol=0, atol=GRAD_TOL, err_msg=name)


def test_read_jax_checkpoint_of_whisper(tmp_path):
    """A JAX-written checkpoint of reduced whisper (params and AdamW
    state) read by ``read_jax_checkpoint``: the train logits with frames
    equal JAX's (1e-4), and the moments keyed by the port's parameter
    names, encoder and position tables included."""
    jcommon.set_compute_dtype(jnp.float32)
    try:
        jlm = JaxLM(jax_reduced(WHISPER))
        params = jax.jit(jlm.init)(jax.random.PRNGKey(4))
        JaxCheckpointer(str(tmp_path)).save(
            3, {"params": params, "opt": jax_adamw_init(params)})
        toks, enc = _inputs(seed=5)
        jl = np.asarray(jlm.forward(params, jnp.asarray(toks),
                                    enc_input=jnp.asarray(enc))[0])
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)
    lm, opt, meta = read_jax_checkpoint(str(tmp_path), get_reduced(WHISPER),
                                        device="cpu")
    assert meta["step"] == 3 and int(opt["step"]) == 0
    names = {n for n, _ in lm.named_parameters()}
    assert set(opt["m"]) == set(opt["v"]) == names
    assert {"pos.table", "enc_pos.table", "enc_final_norm.scale"} <= names
    with torch.inference_mode():
        tl, _ = lm(torch.from_numpy(toks), enc_input=torch.from_numpy(enc))
    _close(tl, jl)


def test_decode_floor_counts_the_cross_cache(jax_ref):
    """The ITL floor's bytes: the decoder's weights but the cross wk / wv
    (prefill only), the f32 head, no encoder weight and no table; with
    ``slots`` the cross K/V a decode step reads, 2 x slots x layers x
    encoder_seq x kv_heads x head_dim in the model's dtype."""
    from repro_torch.launch.profile_decode import (
        cross_bytes,
        decode_weight_bytes,
    )

    _, _, tlm, _ = jax_ref
    cfg = tlm.cfg
    mx = cfg.plan[0][0].mixer
    assert cross_bytes(tlm, 4) == (2 * 4 * cfg.n_layers * cfg.encoder_seq
                                   * mx.kv_heads * mx.head_dim * 4)
    assert decode_weight_bytes(tlm, slots=4) == (decode_weight_bytes(tlm)
                                                 + cross_bytes(tlm, 4))
    read = sum(p.numel() * p.element_size()
               for m in (tlm.final_norm, tlm.lm_head) for p in
               [*m.parameters(), *m.buffers()])
    for layer in tlm.layers:
        read += sum(t.numel() * t.element_size() for name, t in
                    [*layer.named_parameters(), *layer.named_buffers()]
                    if not name.startswith(("cross.wk.", "cross.wv.")))
    assert decode_weight_bytes(tlm) == read
