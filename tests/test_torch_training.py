"""The port's training path against the JAX package's on the CPU.

* ``nm_matmul``'s backward (the autograd Function around the kernels'
  forward) against the JAX ``custom_vjp`` of ``_nm_matmul_core``: dx,
  dvals and dbias, prefill (M = 16) and decode (M = 4) families, no
  epilogue, bias, bias + each activation, 2:4 and 1:4, and a weight
  whose blocks repeat an index (the sum ``decompress_nm`` makes). f32
  throughout: 1e-5 (both run the same f32 products, summed in another
  order).
* ``MaskedNMWeight.project`` and its gradient (zero at pruned entries).
* Train steps of reduced yi-9b, the port's ``make_train_step`` against
  JAX's from the same weights (``interop``) and the same ``DataPipeline``
  batches: loss, nll, lr, grad_norm, every parameter and both moments.
  At f32 compute they agree to 1e-5 (loss, lr, grad_norm relative) and
  the parameters and moments to 2e-5 absolute after three steps (AdamW
  divides by sqrt(v): a gradient near zero moves its entry by up to
  lr whatever its last bits). At bf16 compute the two round their
  activations in other places (XLA fuses converts; PyTorch rounds each
  op's output): the loss agrees to 1e-3 relative, grad_norm to 5e-3,
  both moments of every parameter (the gradients) to 3% in norm, and
  each parameter's update from the initial weights in norm to 0.35
  after one step and 0.15 after three (AdamW moves an entry by about lr
  a step whatever its gradient's size, so a near-zero gradient whose
  sign the roundings flip moves it the other way).
  Also with 2 microbatches and in masked mode (f32 compute, as tight),
  and with int8 gradient compression: there a gradient entry within
  rounding noise of an int8 rounding boundary lands one quantum apart on
  the two sides, so the loss agrees to 1e-4, grad_norm to 1e-3, the
  moments to 6% in norm (a quantum is max|g| / 127 of its tensor) and
  the updates to 0.25 in norm after two steps.
* Reduced deepseek-v2-lite-16b (MLA + MoE aux): loss, nll, aux and every
  gradient (f32, 1e-5 relative to the largest entry).
* Ports of ``tests/test_training.py``; ``_int8_compress`` bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core.nmweight import KernelPolicy as JaxPolicy
from repro.core.nmweight import MaskedNMWeight as JaxMasked
from repro.core.nmweight import NMWeight as JaxNMWeight
from repro.core.sparsity import NMConfig as JaxNM
from repro.data.pipeline import DataPipeline as JaxPipeline
from repro.data.pipeline import PipelineConfig as JaxPipelineConfig
from repro.kernels.epilogue import Epilogue as JaxEpilogue
from repro.kernels.indexmac.ops import nm_matmul as jax_nm_matmul
from repro.models import common as jcommon
from repro.models.transformer import LM as JaxLM
from repro.optim.optimizer import AdamWConfig as JaxAdamW
from repro.optim.optimizer import adamw_init as jax_adamw_init
from repro.training import train_loop as jtrain
from repro_torch.configs import get_reduced
from repro_torch.core.nmweight import KernelPolicy, MaskedNMWeight, NMWeight
from repro_torch.core.sparsity import NMConfig
from repro_torch.interop import lm_from_jax
from repro_torch.kernels import registry
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.indexmac.ops import nm_matmul
from repro_torch.optim.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
from repro_torch.quant import quantize_nm
from repro_torch.training import train_loop
from repro_torch.training.train_loop import (
    TrainConfig,
    init_compress_state,
    init_train_state,
    make_train_step,
)

GRAD_TOL = 1e-5
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def numpy_tree(tree):
    """The JAX param tree as numpy arrays, each weight node as the dict
    ``repro_torch.interop`` takes."""
    if isinstance(tree, JaxNMWeight):
        return {"vals": np.asarray(tree.vals), "idx": np.asarray(tree.idx),
                "n": tree.nm.n, "m": tree.nm.m, "axis": tree.axis,
                "mode": tree.kernel_policy.mode}
    if isinstance(tree, JaxMasked):
        return {"w": np.asarray(tree.w), "n": tree.nm.n, "m": tree.nm.m,
                "axis": tree.axis}
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# nm_matmul's backward against the JAX custom_vjp
# ---------------------------------------------------------------------------


def _grads_pair(m, k, n, pattern, bias, act, *, seed=0, idx=None):
    nmc = NMConfig(*pattern)
    rng = np.random.default_rng(seed)
    kc = k * nmc.n // nmc.m
    x = rng.standard_normal((m, k)).astype(np.float32)
    vals = (rng.standard_normal((kc, n)) * k ** -0.5).astype(np.float32)
    if idx is None:  # distinct ascending indices in every block
        idx = np.stack([np.sort(rng.choice(nmc.m, nmc.n, replace=False))
                        for _ in range(kc // nmc.n * n)])
        idx = idx.reshape(kc // nmc.n, n, nmc.n).transpose(0, 2, 1)
        idx = idx.reshape(kc, n)
    idx = idx.astype(np.int8)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    r = rng.standard_normal((m, n)).astype(np.float32)

    jw = JaxNMWeight(jnp.asarray(vals), jnp.asarray(idx),
                     JaxNM(*pattern), 0, JaxPolicy("off"))

    def jloss(x_, v_, b_):
        w = dataclasses.replace(jw, vals=v_)
        y = jax_nm_matmul(x_, w, epilogue=JaxEpilogue(bias=b_,
                                                      activation=act))
        return jnp.sum(y * r)

    argnums = (0, 1, 2) if bias else (0, 1)
    jg = jax.grad(jloss, argnums=argnums)(
        jnp.asarray(x), jnp.asarray(vals), None if b is None else
        jnp.asarray(b))

    tx = torch.tensor(x, requires_grad=True)
    tv = torch.nn.Parameter(torch.tensor(vals))
    tb = torch.tensor(b, requires_grad=True) if bias else None
    tw = NMWeight(tv, torch.tensor(idx), nmc, 0, KernelPolicy("auto"))
    registry.clear_history()
    y = nm_matmul(tx, tw, epilogue=Epilogue(bias=tb, activation=act))
    (y * torch.tensor(r)).sum().backward()
    tg = (tx.grad, tv.grad) + ((tb.grad,) if bias else ())
    return jg, tg


@pytest.mark.parametrize("pattern", [(2, 4), (1, 4)], ids=["2:4", "1:4"])
@pytest.mark.parametrize("epilogue", [
    (False, None), (True, None), (True, "relu"), (True, "gelu"),
    (True, "silu"), (True, "relu_sq")],
    ids=["none", "bias", "bias-relu", "bias-gelu", "bias-silu",
         "bias-relu_sq"])
@pytest.mark.parametrize("m", [16, 4], ids=["prefill", "decode"])
def test_nm_matmul_grads_match_jax_custom_vjp(m, epilogue, pattern):
    bias, act = epilogue
    jg, tg = _grads_pair(m, 64, 24, pattern, bias, act)
    fam = "nm_matmul" if m > 8 else "nm_matmul_decode"
    kern = "nm_spmm" if m > 8 else "nm_spmm_decode"
    # the forward ran the kernel family (its plain version on the CPU)
    assert registry.dispatch_counts(fam) == {(fam, kern, "cpu"): 1}
    for name, j, t in zip(("dx", "dvals", "dbias"), jg, tg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def test_repeated_indices_get_the_gradient_of_their_position():
    """A block that repeats an index (as the zero-padded pairs of
    ``pad_compressed_kn`` do) decompresses to the sum of its values;
    each value's gradient is the dense gradient at that position, as
    JAX's one-hot vjp gives it."""
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 4, (32, 24))  # 2:4 blocks, repeats included
    assert (idx.reshape(16, 2, 24)[:, 0] == idx.reshape(16, 2, 24)[:, 1]
            ).any()
    jg, tg = _grads_pair(16, 64, 24, (2, 4), True, "silu", idx=idx)
    for j, t in zip(jg, tg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_bf16_call_returns_grads_in_the_operands_dtypes():
    x = torch.randn(16, 64, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(64, 32)
    from repro_torch.api import sparsify

    sw = sparsify(w, NMConfig(2, 4), kernel_policy="auto")
    vals = torch.nn.Parameter(sw.vals)  # f32 storage, bf16 compute
    y = nm_matmul(x, dataclasses.replace(sw, vals=vals))
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and vals.grad.dtype == torch.float32


def test_int8_weight_is_inference_only():
    sw = NMWeight(*_pruned(64, 32), NMConfig(2, 4), 0, KernelPolicy("auto"))
    qw = quantize_nm(sw)
    x = torch.randn(16, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference only"):
        nm_matmul(x, qw)
    with torch.no_grad():
        assert nm_matmul(x, qw).shape == (16, 32)


def _pruned(k, n):
    from repro_torch.core.sparsity import (
        apply_mask,
        compress_nm,
        prune_mask_nm,
    )

    w = torch.randn(k, n)
    return compress_nm(apply_mask(w, prune_mask_nm(w, NMConfig(2, 4))),
                       NMConfig(2, 4))


def test_serving_calls_record_no_graph():
    """Frozen weights (the default) and no grad on x: the call never
    enters the autograd Function."""
    sw = NMWeight(*_pruned(64, 32), NMConfig(2, 4), 0, KernelPolicy("auto"))
    y = nm_matmul(torch.randn(16, 64), sw)
    assert y.grad_fn is None


# ---------------------------------------------------------------------------
# conv VJP (mirrors tests/test_conv.py::test_conv_grad_matches_dense_vjp)
# ---------------------------------------------------------------------------


def test_conv_grad_matches_dense_vjp():
    from repro_torch.configs.base import ConvSpec, SparsityConfig
    from repro_torch.models.conv import SparseConv2D, conv2d

    spec = ConvSpec("c", 8, 16, 3, 3, 2)
    gen = torch.Generator().manual_seed(0)
    conv = SparseConv2D.init(spec, gen, sp=SparsityConfig(
        targets=("conv",), use_kernel=True))
    conv.vals.requires_grad_(True)
    x = torch.randn(2, 9, 9, 8, generator=gen, requires_grad=True)
    (conv(x) ** 2).sum().backward()
    w2d = conv.weight.to_dense().detach().requires_grad_(True)
    x_ref = x.detach().clone().requires_grad_(True)
    (conv2d(x_ref, w2d, kh=3, kw=3, stride=2) ** 2).sum().backward()
    torch.testing.assert_close(x.grad, x_ref.grad, rtol=1e-4, atol=1e-4)
    kc = conv.vals.shape[0]
    grow = (torch.arange(kc)[:, None] // 2) * 4 + conv.idx.long()
    torch.testing.assert_close(conv.vals.grad,
                               torch.gather(w2d.grad, 0, grow),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# MaskedNMWeight
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axis", [0, 1])
def test_masked_project_and_grad_match_jax(axis):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((16, 12)).astype(np.float32)
    r = rng.standard_normal((16, 12)).astype(np.float32)
    jm = JaxMasked(jnp.asarray(w), JaxNM(2, 4), axis)
    jp = np.asarray(jm.project())
    jg = np.asarray(jax.grad(lambda w_: jnp.sum(
        dataclasses.replace(jm, w=w_).project() * r))(jnp.asarray(w)))
    tw = torch.tensor(w, requires_grad=True)
    tm = MaskedNMWeight(tw, NMConfig(2, 4), axis)
    tp = tm.project()
    (tp * torch.tensor(r)).sum().backward()
    np.testing.assert_array_equal(tp.detach().numpy(), jp)
    np.testing.assert_array_equal(tw.grad.numpy(), jg)
    assert (tw.grad.numpy()[jp == 0] == 0).all()  # pruned: no gradient


# ---------------------------------------------------------------------------
# train steps against JAX's make_train_step
# ---------------------------------------------------------------------------


def _jax_and_port(arch="yi-9b", compute="f32", mode="compressed", **tkw):
    """(JAX params, its step, port LM, its step, opt states) from the
    same weights."""
    jcfg = jax_reduced(arch)
    tcfg_ = get_reduced(arch)
    if mode == "masked":
        jcfg = dataclasses.replace(jcfg, sparsity=dataclasses.replace(
            jcfg.sparsity, mode="masked"))
        tcfg_ = dataclasses.replace(tcfg_, sparsity=dataclasses.replace(
            tcfg_.sparsity, mode="masked"))
    jcommon.set_compute_dtype(jnp.float32 if compute == "f32"
                              else jnp.bfloat16)
    jlm = JaxLM(jcfg)
    params = jax.jit(jlm.init)(jax.random.PRNGKey(0))
    jstep = jax.jit(jtrain.make_train_step(
        jlm, jtrain.TrainConfig(opt=JaxAdamW(**OPT), remat="none", **tkw)))
    tlm = lm_from_jax(tcfg_, numpy_tree(params), dtype=torch.float32,
                      device="cpu")
    if compute != "f32":
        tlm.set_compute_dtype(torch.bfloat16)
    tc = TrainConfig(opt=AdamWConfig(**OPT), remat="none", **tkw)
    return (jcfg, params, jstep, tlm, make_train_step(tlm, tc),
            init_train_state(tlm, tc))


def _run(arch, compute, steps, mode="compressed", **tkw):
    """Both sides for ``steps`` steps: each step's (JAX metrics, port
    metrics), and after every step the state of both, by the port's
    parameter names (JAX's trees go through interop, so an LM built from
    them names its parameters as the port's do): {"jax": (params, m,
    v), "port": (params, m, v)}."""
    try:
        jcfg, params, jstep, tlm, tstep, tstate = _jax_and_port(
            arch, compute, mode, **tkw)
        comp = tkw.get("grad_compression", False)
        jopt = jax_adamw_init(params)
        jerr = jtrain.init_compress_state(params) if comp else None
        topt = tstate[1]
        terr = tstate[2] if comp else None
        pipe = JaxPipeline(JaxPipelineConfig(
            vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4))
        init = {n: p.detach().clone() for n, p in tlm.named_parameters()}
        out, states = [], []
        for _ in range(steps):
            b = pipe.next()
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            if comp:
                params, jopt, jerr, jm = jstep(params, jopt, jb, jerr)
                tlm, topt, terr, tm = tstep(tlm, topt, b, terr)
            else:
                params, jopt, jm = jstep(params, jopt, jb)
                tlm, topt, tm = tstep(tlm, topt, b)
            out.append((jm, tm))
            states.append(_states(tlm, params, jopt, topt, init))
        return out, states, tlm, topt
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)


def _states(tlm, params, jopt, topt, init):
    cfg = tlm.cfg
    jax_side = [dict(lm_from_jax(cfg, numpy_tree(params), device="cpu")
                     .named_parameters())]
    for part in ("m", "v"):
        tree = numpy_tree(jopt[part])
        _fill_idx(tree, numpy_tree(params))
        jax_side.append(dict(lm_from_jax(cfg, tree, device="cpu")
                             .named_parameters()))
    port = ({n: p.detach().clone() for n, p in tlm.named_parameters()},
            {n: t.clone() for n, t in topt["m"].items()},
            {n: t.clone() for n, t in topt["v"].items()})
    return {"jax": jax_side, "port": port, "init": init}


def _fill_idx(tree, params):
    """The JAX moment trees hold a scalar idx placeholder: take the
    params' idx so interop can build the tree."""
    if isinstance(tree, dict):
        if "idx" in tree and "vals" in tree:
            tree["idx"] = params["idx"]
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                _fill_idx(v, params[k])
    elif isinstance(tree, list):
        for v, p in zip(tree, params):
            _fill_idx(v, p)


def _check_metrics(out, rtol_loss, rtol_gnorm):
    for jm, tm in out:
        for key, rtol in (("loss", rtol_loss), ("nll", rtol_loss),
                          ("lr", 1e-6), ("grad_norm", rtol_gnorm)):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=rtol, atol=1e-7, err_msg=key)
        np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                                   rtol=rtol_loss, atol=1e-7)


def _pairs(state):
    """(name, what, port tensor, JAX tensor) of every parameter and both
    moments."""
    for name in state["port"][0]:
        for i, what in enumerate(("param", "m", "v")):
            yield (name, what, state["port"][i][name],
                   state["jax"][i][name].detach())


def _check_exact(state, atol):
    for name, what, got, want in _pairs(state):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=atol, err_msg=f"{what} {name}")


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _check_close(state, rel, rel_update):
    """Each moment within ``rel`` of JAX's in norm, and each parameter's
    update from the common initial weights within ``rel_update``. Adam's
    first update is about lr * sign(g) an entry, so an entry whose
    gradient rounds to the other sign moves the other way: the updates
    are held looser than the moments."""
    for name, what, got, want in _pairs(state):
        tol = rel
        if what == "param":
            got, want = got - state["init"][name], want - state["init"][name]
            tol = rel_update
        assert _rel(got, want) < tol, (what, name, _rel(got, want))


@pytest.fixture(scope="module")
def f32_run():
    return _run("yi-9b", "f32", 3)


@pytest.fixture(scope="module")
def bf16_run():
    return _run("yi-9b", "bf16", 3)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax_at_f32(f32_run, steps):
    out, states, _, _ = f32_run
    _check_metrics(out[:steps], 1e-5, 1e-5)
    _check_exact(states[steps - 1], 2e-5)


# the updates at bf16 compute by steps: 0.3-1.5 % of a weight's entries
# flip sign at step 1 (worst 0.24 in norm, final_norm.scale), fewer by
# step 3 (0.085)
BF16_REL_UPDATE = {1: 0.35, 3: 0.15}


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax_at_bf16(bf16_run, steps):
    out, states, _, topt = bf16_run
    _check_metrics(out[:steps], 1e-3, 5e-3)
    _check_close(states[steps - 1], 0.03, BF16_REL_UPDATE[steps])
    assert int(topt["step"]) == 3


@pytest.mark.parametrize("variant", ["microbatches", "compression",
                                     "masked"])
def test_train_step_variants_match_jax(variant):
    kw = {"microbatches": dict(microbatches=2),
          "compression": dict(grad_compression=True),
          "masked": dict(mode="masked")}[variant]
    out, states, tlm, _ = _run("yi-9b", "f32", 2, **kw)
    if variant == "compression":
        # int8 rounding: a gradient entry within 1e-7 of a rounding
        # boundary lands one quantum (max|g| / 127) apart on the two sides
        _check_metrics(out, 1e-4, 1e-3)
        _check_close(states[-1], 0.06, 0.25)  # updates: 0.168
    else:
        _check_metrics(out, 1e-5, 1e-5)
        _check_exact(states[-1], 2e-5)
    if variant == "masked":
        from repro_torch.models.common import linear_weight_dense

        lin = tlm.layers[0].mlp.w_up
        assert lin.mask_nm is not None and lin.nm is None
        assert torch.equal(linear_weight_dense(lin.weight),
                           lin.weight.project())


def test_deepseek_loss_and_grads_match_jax():
    """Reduced deepseek-v2-lite-16b cut to its dense layer 0 and one MoE
    layer (MLA, MoE with its aux loss): loss parts and every parameter's
    gradient at f32."""
    def cut(cfg):
        (b0, _), (b1, _) = cfg.plan
        return dataclasses.replace(cfg, plan=((b0, 1), (b1, 1)))

    jcommon.set_compute_dtype(jnp.float32)
    try:
        jcfg = cut(jax_reduced("deepseek-v2-lite-16b"))
        jlm = JaxLM(jcfg)
        params = jax.jit(jlm.init)(jax.random.PRNGKey(0))
        b = JaxPipeline(JaxPipelineConfig(vocab_size=jcfg.vocab_size,
                                          seq_len=16, global_batch=2)).next()
        (jl, jparts), jg = jax.jit(jax.value_and_grad(
            lambda p: jlm.loss(p, {k: jnp.asarray(v) for k, v in b.items()}),
            has_aux=True, allow_int=True))(params)
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)
    tlm = lm_from_jax(cut(get_reduced("deepseek-v2-lite-16b")),
                      numpy_tree(params), device="cpu")
    params_t = train_loop.trainable(tlm)
    tl, tparts = tlm.loss({k: torch.as_tensor(v) for k, v in b.items()})
    assert float(jparts["aux"]) > 0
    for got, want in ((tl.detach(), jl), (tparts["nll"].detach(),
                                          jparts["nll"]),
                      (tparts["aux"].detach(), jparts["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    tg = torch.autograd.grad(tl, list(params_t.values()))
    tree = numpy_tree(jax.tree.map(
        lambda g: g if jnp.issubdtype(g.dtype, jnp.floating) else
        np.zeros(g.shape, np.int8), jg, is_leaf=lambda x: False))
    _fill_idx(tree, numpy_tree(params))
    want = dict(lm_from_jax(tlm.cfg, tree, device="cpu").named_parameters())
    for (name, _), g in zip(params_t.items(), tg):
        w = want[name].detach()
        scale = float(w.abs().max()) or 1.0
        np.testing.assert_allclose(g.numpy() / scale, w.numpy() / scale,
                                   rtol=0, atol=GRAD_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# ports of tests/test_training.py
# ---------------------------------------------------------------------------


def test_cosine_schedule_shape_and_jax_values():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                      min_lr_frac=0.1)
    steps = (0, 5, 10, 60, 110, 200)
    lrs = [float(cosine_schedule(cfg, s)) for s in steps]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 0.5) < 1e-6
    assert abs(lrs[2] - 1.0) < 1e-6
    assert lrs[3] < lrs[2]
    assert abs(lrs[4] - 0.1) < 1e-6 and abs(lrs[5] - 0.1) < 1e-6
    from repro.optim.optimizer import cosine_schedule as jcos

    jcfg = JaxAdamW(lr=1.0, warmup_steps=10, total_steps=110,
                    min_lr_frac=0.1)
    np.testing.assert_allclose(
        lrs, [float(jcos(jcfg, jnp.int32(s))) for s in steps], rtol=1e-6)


def test_adamw_update_in_pieces_equals_the_whole(monkeypatch):
    """A tensor above ``optimizer.CHUNK`` entries is updated in pieces
    (bounded temporaries): bit for bit the whole tensor's update, a
    non-contiguous gradient and a contiguous one alike."""
    from repro_torch.optim import optimizer

    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(33, 17, generator=gen),
              "b": torch.randn(5, generator=gen)}
    grads = {"a": torch.randn(17, 33, generator=gen).t(),
             "b": torch.randn(5, generator=gen)}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    out = []
    for chunk in (optimizer.CHUNK, 64):
        monkeypatch.setattr(optimizer, "CHUNK", chunk)
        p = {k: v.clone() for k, v in params.items()}
        state = adamw_init(p)
        for _ in range(3):
            _, state, _ = adamw_update(cfg, p, grads, state)
        out.append((p, state))
    for part in ("m", "v"):
        for k in params:
            assert torch.equal(out[0][1][part][k], out[1][1][part][k])
    for k in params:
        assert torch.equal(out[0][0][k], out[1][0][k])


def test_adamw_trains_floats_and_leaves_idx_alone():
    """idx is a buffer: no moments, no update, bit-identical; vals, the
    dense weight and a masked weight's storage train."""
    from repro_torch.api import sparsify
    from repro_torch.models.common import Linear

    torch.manual_seed(0)
    lin = Linear(sparsify(torch.randn(8, 4), NMConfig(2, 4),
                          kernel_policy="off"))
    dense = Linear(torch.ones(8, 4))
    masked = Linear(MaskedNMWeight(torch.ones(8, 4), NMConfig(2, 4)))
    mod = torch.nn.ModuleDict({"lin": lin, "dense": dense, "masked": masked})
    params = train_loop.trainable(mod)
    assert set(params) == {"lin.vals", "dense.w", "masked.w"}
    idx0 = lin.idx.clone()
    st = adamw_init(params)
    assert set(st["m"]) == set(params)
    x = torch.ones(2, 8)
    loss = sum((m(x) ** 2).sum() for m in mod.values())
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10,
                      weight_decay=0.0)
    vals0 = lin.vals.detach().clone()
    adamw_update(cfg, params, grads, st)
    assert torch.equal(lin.idx, idx0) and lin.idx.dtype == torch.int8
    assert not torch.allclose(lin.vals, vals0)
    assert not torch.allclose(dense.w, torch.ones(8, 4))
    assert not torch.allclose(masked.w, torch.ones(8, 4))


def test_quantized_weights_are_frozen_buffers():
    from repro_torch.models.common import Linear

    lin = Linear(quantize_nm(NMWeight(*_pruned(8, 4), NMConfig(2, 4))))
    assert dict(lin.named_parameters()) == {}
    assert train_loop.trainable(lin) == {}
    assert set(dict(lin.named_buffers())) == {"vals", "idx", "scales"}


def test_global_norm():
    g = {"a": torch.ones(3) * 2.0, "b": torch.ones(4),
         "i": torch.zeros(2, dtype=torch.int8)}
    assert abs(float(global_norm(g)) - 4.0) < 1e-6


def test_microbatch_equivalence():
    """Accumulating 4 microbatches equals one batch (f32 weights)."""
    def step(mb):
        lm = _small_lm(sparse=False)
        tc = TrainConfig(microbatches=mb, remat="none")
        _, opt = init_train_state(lm, tc)
        toks = torch.randint(0, lm.cfg.vocab_size, (8, 16),
                             generator=torch.Generator().manual_seed(1))
        _, _, m = make_train_step(lm, tc)(lm, opt, {"tokens": toks,
                                                    "labels": toks})
        return lm, m

    lm1, m1 = step(1)
    lm4, m4 = step(4)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    p4 = dict(lm4.named_parameters())
    for n, p in lm1.named_parameters():
        torch.testing.assert_close(p, p4[n], rtol=0, atol=2e-5)


def _small_lm(sparse=True, compute=None):
    from repro_torch.models.transformer import LM

    return LM.init(get_reduced("yi-9b", sparse=sparse), seed=0,
                   dtype=torch.float32,
                   device="cpu").set_compute_dtype(compute)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_changes_memory_not_the_loss_or_grads(remat):
    lm = _small_lm(compute=torch.bfloat16)
    params = train_loop.trainable(lm)
    toks = torch.randint(0, lm.cfg.vocab_size, (4, 16),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    out = {}
    for r in ("none", remat):
        loss, _ = lm.loss(batch, remat=r)
        out[r] = (loss, torch.autograd.grad(loss, list(params.values())))
    assert float(out["none"][0]) == float(out[remat][0])
    for a, b in zip(out["none"][1], out[remat][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="remat"):
        lm.loss(batch, remat="some")


def test_grad_compression_roundtrip():
    lm = _small_lm(compute=torch.bfloat16)
    tc = TrainConfig(grad_compression=True)
    _, opt, err = init_train_state(lm, tc)
    assert set(err) == set(train_loop.trainable(lm))
    toks = torch.randint(0, lm.cfg.vocab_size, (4, 16),
                         generator=torch.Generator().manual_seed(1))
    _, _, err2, metrics = make_train_step(lm, tc)(
        lm, opt, {"tokens": toks, "labels": toks}, err)
    assert np.isfinite(float(metrics["loss"]))
    assert float(global_norm(err2)) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_compress_bit_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((64, 33)) * 10 ** rng.uniform(-4, 1)).astype(
        np.float32)
    g[0, :5] = np.array([0.5, 1.5, -2.5, 0, 127], np.float32) * (
        np.abs(g).max() / 127)  # ties of round-half-even
    jq, js = jtrain._int8_compress(jnp.asarray(g))
    tq, ts = train_loop._int8_compress(torch.tensor(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    err = rng.standard_normal(g.shape).astype(np.float32) * 1e-3
    jd, je = jtrain._compress_tree({"g": jnp.asarray(g)},
                                   {"g": jnp.asarray(err)})
    td, te = train_loop._compress_tree({"g": torch.tensor(g)},
                                       {"g": torch.tensor(err)})
    np.testing.assert_array_equal(td["g"].numpy(), np.asarray(jd["g"]))
    np.testing.assert_array_equal(te["g"].numpy(), np.asarray(je["g"]))
    assert init_compress_state({"g": torch.tensor(g)})["g"].dtype == \
        torch.float32


def test_loss_decreases_end_to_end():
    """The training loop at micro scale: the loss drops."""
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig

    lm = _small_lm(compute=torch.bfloat16)
    tc = TrainConfig(opt=AdamWConfig(lr=3e-3, warmup_steps=5,
                                     total_steps=40), remat="none")
    _, opt = init_train_state(lm, tc)
    step = make_train_step(lm, tc)
    pipe = DataPipeline(PipelineConfig(vocab_size=lm.cfg.vocab_size,
                                       seq_len=32, global_batch=8))
    losses = []
    for _ in range(40):
        _, opt, m = step(lm, opt, pipe.next())
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.2, losses[::10]
