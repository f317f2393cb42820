"""The port's deepseek-v2-236b config and model against the JAX
package's, on the CPU, one device, f32 compute:

* ``config()`` and ``reduced()`` equal to the JAX package's field for
  field (a dataclass at a time; MLA with q_lora_rank 1536, 160 routed
  experts top-6 of width 1536, 2 shared, layer 0 dense);
* the full config's stored parameter count (compressed values and
  indices, 2:4) equal to ``jax.eval_shape(lm.init)``'s: the port's
  layers are made under ``FakeTensorMode`` (shapes only), its dense
  layer and one MoE layer, the other 58 MoE layers being the same shape;
* reduced deepseek-v2-236b on the JAX package's weights (interop): the
  logits of a prefill and two decode steps within 1e-4 (and the aux
  loss within 1e-5) of the JAX package's ``LM.forward``, with the q
  low-rank path's wq_a / q_a_norm / wq_b carried across; greedy streams
  of the slot engine equal to the JAX package's ``ServeEngine``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.core.nmweight import NMWeight as JaxNMWeight
from repro.models import common as jcommon
from repro.models.cache import CacheView as JaxCacheView
from repro.models.transformer import LM as JaxLM
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.interop import lm_from_jax
from repro_torch.launch.serve import cut_plan
from repro_torch.models.cache import CacheView
from repro_torch.models.transformer import LM
from repro_torch.serving.engine import Request, ServeEngine

ARCH = "deepseek-v2-236b"
LOGIT_TOL = 1e-4
AUX_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny CPU ops: idle threads
    would spin beside the suite's other workers and the ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_tree(tree):
    if isinstance(tree, JaxNMWeight):
        return {"vals": np.asarray(tree.vals), "idx": np.asarray(tree.idx),
                "n": tree.nm.n, "m": tree.nm.m, "axis": tree.axis,
                "mode": tree.kernel_policy.mode}
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    return np.asarray(tree)


def _fields(obj):
    """A config as nested plain values, class names kept."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: _fields(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return tuple(_fields(v) for v in obj)
    return obj


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("which", ["config", "reduced"])
def test_config_equals_jax_field_for_field(which, sparse):
    assert ARCH in ARCHS
    get_j = jax_config if which == "config" else jax_reduced
    get_t = get_config if which == "config" else get_reduced
    assert _fields(get_t(ARCH, sparse=sparse)) == _fields(
        get_j(ARCH, sparse=sparse))


def test_full_parameter_count_equals_jax_eval_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode

    jlm = JaxLM(jax_config(ARCH))
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0)))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    cfg = get_config(ARCH)
    (dense, n_dense), (moe, n_moe) = cfg.plan
    cut = dataclasses.replace(cfg, plan=cut_plan(cfg.plan, 2))
    with FakeTensorMode():
        lm = LM.init(cut, device="cpu", dtype=torch.bfloat16)

        def count(mod):
            return sum(t.numel() for t in list(mod.parameters())
                       + list(mod.buffers()))

        layers = [count(layer) for layer in lm.layers]
        rest = count(lm) - sum(layers)
    got = rest + n_dense * layers[0] + n_moe * layers[1]
    assert (n_dense, n_moe) == (1, 59)
    assert got == want, (got, want)
    assert 2.0e11 < got < 2.6e11  # 2:4 halves the values, idx as many


@pytest.fixture(scope="module")
def models():
    jcommon.set_compute_dtype(jnp.float32)
    try:
        jlm = JaxLM(jax_reduced(ARCH))
        params = jax.jit(jlm.init)(jax.random.PRNGKey(0))
        tlm = lm_from_jax(get_reduced(ARCH), numpy_tree(params),
                          dtype=torch.float32, device="cpu")
        yield jlm, params, tlm
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)


def test_reduced_forward_matches_jax(models):
    jlm, params, tlm = models
    assert tlm.layers[1].mixer.wq_a is not None  # the q low-rank path
    assert tlm.layers[1].mixer.wq is None
    toks = np.random.default_rng(0).integers(0, 512, (2, 8)).astype(
        np.int32)
    prefill = jax.jit(lambda p, t, c: jlm.forward(
        p, t, view=JaxCacheView.prefill(), caches=c))
    decode = jax.jit(lambda p, t, c, n: jlm.forward(
        p, t, view=JaxCacheView.decode(n), caches=c))
    jl, jc, jaux = prefill(params, jnp.asarray(toks),
                           jlm.init_cache(2, 16, jnp.float32))
    with torch.inference_mode():
        tc = tlm.init_cache(2, 16)
        tl, _, taux = tlm(torch.from_numpy(toks), view=CacheView.prefill(),
                          caches=tc, with_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_TOL,
                               atol=AUX_TOL)
    for i in range(2):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        lens = np.full((2,), 8 + i, np.int32)
        jl, jc, _ = decode(params, jnp.asarray(nxt), jc, jnp.asarray(lens))
        with torch.inference_mode():
            tl, _ = tlm(torch.from_numpy(nxt),
                        view=CacheView.decode(torch.from_numpy(lens)),
                        caches=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_reduced_greedy_serve_matches_jax(models):
    jlm, params, tlm = models
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=8).astype(np.int32)
               for _ in range(4)]
    kw = dict(slots=2, max_seq=32, prefill_len=8)

    def serve(eng, request):
        for i, p in enumerate(prompts):
            eng.submit(request(rid=i, prompt=p, max_new=3 + i))
        return {r.rid: list(map(int, r.out)) for r in eng.run()}

    want = serve(JaxServeEngine(jlm, params, **kw), JaxRequest)
    got = serve(ServeEngine(tlm, **kw), Request)
    assert got == want
