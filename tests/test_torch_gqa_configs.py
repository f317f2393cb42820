"""The configs this port adds beside whisper-medium and gemma3-27b's
modules: chameleon-34b (qk-norm), codeqwen1.5-7b (MHA, theta 1e6) and
internlm2-20b (GQA 48/8), reduced, against the JAX package on the CPU
at f32 on the same weights (a prefill and two greedy decode steps); and
all five new configs' ``config()`` and ``reduced()`` equal to the JAX
package's field for field.

Tolerance: logits 1e-4 (``LOGIT_TOL``, as ``tests/test_torch_model.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import common as jcommon
from repro.models.cache import CacheView as JaxCacheView
from repro.models.transformer import LM as JaxLM
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.interop import lm_from_jax
from repro_torch.kernels import registry
from repro_torch.models.cache import CacheView
from test_torch_moe import numpy_tree

LOGIT_TOL = 1e-4
GQA = ("chameleon-34b", "codeqwen1.5-7b", "internlm2-20b")
NEW = ("whisper-medium", "gemma3-27b") + GQA


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", NEW)
def test_config_equals_jax(arch, reduced):
    """Every field, the plans' Blocks (mixer, MLP, cross_attn), the
    sparsity, and an encoder's plan included."""
    assert arch in ARCHS
    j = (jax_reduced if reduced else jax_config)(arch)
    t = (get_reduced if reduced else get_config)(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.n_layers == j.n_layers
    assert len(t.encoder_blocks()) == sum(
        r for _, r in (j.encoder_plan or ()))


@pytest.mark.parametrize("arch", GQA)
def test_prefill_and_decode_match_jax(arch):
    """A prefill of 8 tokens and two greedy decode steps through the
    kernel families (their plain versions on the CPU): every call's
    logits."""
    def kernels(cfg):
        return dataclasses.replace(cfg, sparsity=dataclasses.replace(
            cfg.sparsity, use_kernel=True))

    b, s, steps = 2, 8, 2
    toks = np.random.default_rng(0).integers(0, 512, (b, s)).astype(np.int32)
    jcommon.set_compute_dtype(jnp.float32)
    try:
        jlm = JaxLM(kernels(jax_reduced(arch)))
        params = jax.jit(jlm.init)(jax.random.PRNGKey(0))
        jc = jlm.init_cache(b, s + steps, jnp.float32)
        jl, jc, _ = jlm.forward(params, jnp.asarray(toks),
                                view=JaxCacheView.prefill(), caches=jc)
        calls = [(np.asarray(jl), toks)]
        for i in range(steps):
            nxt = np.argmax(calls[-1][0][:, -1], -1).astype(np.int32)[:, None]
            jl, jc, _ = jlm.forward(
                params, jnp.asarray(nxt), view=JaxCacheView.decode(
                    jnp.asarray(np.full((b,), s + i, np.int32))), caches=jc)
            calls.append((np.asarray(jl), nxt))
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)
    tlm = lm_from_jax(kernels(get_reduced(arch)), numpy_tree(params),
                      device="cpu")
    cache = tlm.init_cache(b, s + steps)
    registry.clear_history()
    with torch.inference_mode():
        for i, (jl, fed) in enumerate(calls):
            view = (CacheView.prefill() if i == 0 else
                    CacheView.decode(torch.full((b,), s + i - 1)))
            tl, _ = tlm(torch.from_numpy(fed), view=view, caches=cache)
            np.testing.assert_allclose(tl.numpy(), jl, rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL, err_msg=f"call {i}")
    counts = registry.dispatch_counts()
    assert counts[("nm_matmul", "nm_spmm", "cpu")] == 7 * 2
    assert counts[("nm_matmul_decode", "nm_spmm_decode", "cpu")] == 7 * 2 * 2
    assert not any(k[1].startswith("reference") for k in counts), counts
