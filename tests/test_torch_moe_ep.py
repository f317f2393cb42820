"""The port's expert-parallel MoE (``MoE`` split over a mesh's "model"
ranks, under ``parallel.hints.mesh_context``) on gloo ranks on the CPU,
against the JAX package, in f32, on the same weights (the JAX
package's, through ``repro_torch.interop``) and inputs (numpy, seeded):

* at meshes 1x2, 2x2 and 1x4 with ample capacity (factor 8, nothing
  dropped) against ``_moe_apply_local``: y within 1e-4, the aux loss
  within 1e-3 (``tests/test_moe_distributed.py``'s bounds: at 2x2 the
  aux is the mean of the data shards' losses, equal to the global one up
  to the across-shard variance); 2:4 experts and dense ones;
* at capacity factor 1.0, where experts overflow and the drops are per
  data shard (GShard groups), at 2x2 against the JAX package's
  ``_moe_apply_shard_map`` on a forced 8-device host platform with a
  (2, 2) mesh, run in a JAX subprocess as ``tests/test_moe_distributed.py``
  runs it: y within 1e-4, aux within 1e-3; and the local path differs
  there (the drops are really per shard);
* reduced deepseek-v2-236b's ``LM.forward`` under expert parallelism (a
  prefill and 2 decode steps) at 1x2, 1x4 and 2x2, with ample capacity,
  against the JAX package's ``LM.forward``: logits within 1e-4, aux
  within 1e-3;
* each rank holds and runs only its own E / model experts.

One spawn a world size runs all of its meshes' cases; the JAX
subprocess runs beside them.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.configs.base import SparsityConfig as JaxSparsityConfig
from repro.core.nmweight import NMWeight as JaxNMWeight
from repro.models import common as jcommon
from repro.models.cache import CacheView as JaxCacheView
from repro.models.moe import _moe_apply_local, moe_init
from repro.models.transformer import LM as JaxLM
from repro_torch.configs import get_reduced
from repro_torch.configs.base import MoEConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.sharded import cases_rank

D = 32
Y_TOL = 1e-4
AUX_TOL = 1e-3
LOGIT_TOL = 1e-4
SPAWN_TIMEOUT_S = 120
MOE_MESHES = ((1, 2), (2, 2), (1, 4))
KW = dict(n_experts=8, top_k=2, d_expert=64, n_shared=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny CPU ops: idle threads
    would spin beside the suite's other workers and the ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_SUBPROC = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
import numpy as np
from repro.models import common
common.set_compute_dtype(jnp.float32)
from repro import compat
from repro.configs.base import MoEConfig
from repro.models.moe import moe_init, moe_apply, _moe_apply_local

cfg = MoEConfig(n_experts=8, top_k=2, d_expert=64, n_shared=2,
                capacity_factor=1.0)
params = moe_init(jax.random.PRNGKey(0), 32, cfg)
x = jnp.asarray(np.load(sys.argv[1]))
mesh = compat.make_mesh((2, 2), ("data", "model"))
with compat.set_mesh(mesh):
    y, aux = jax.jit(lambda p, x: moe_apply(p, x, cfg))(params, x)
np.savez(sys.argv[2], y=np.asarray(y), aux=float(aux))
print("RESULT ok")
"""


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


def _with_capacity(cfg, factor):
    """A config with every MoE block's capacity factor set (either
    package's)."""
    def blk(b):
        if not hasattr(b.mlp, "capacity_factor"):
            return b
        return dataclasses.replace(b, mlp=dataclasses.replace(
            b.mlp, capacity_factor=factor))
    return dataclasses.replace(cfg, plan=tuple(
        (blk(b), rep) for b, rep in cfg.plan))


def _moe_params():
    """{case: (JAX MoEConfig, params)}: 2:4 and dense experts with ample
    capacity, and the capacity-1.0 dense weights of the JAX subprocess
    (the same key)."""
    out = {}
    for name, sparse, factor in (("2:4", True, 8.0), ("dense", False, 8.0),
                                 ("cf1", False, 1.0)):
        jcfg = JaxMoEConfig(**KW, capacity_factor=factor)
        sp = JaxSparsityConfig(use_kernel=True) if sparse else None
        out[name] = jcfg, jax.jit(lambda k, c=jcfg, s=sp: moe_init(
            k, D, c, sp=s))(jax.random.PRNGKey(0))
    return out


def _moe_cases(x, params):
    """(names and meshes, rank cases) of the MoE layer cases."""
    names, cases = [], []
    for name in ("2:4", "dense"):
        tree = numpy_tree(params[name][1])
        for m in MOE_MESHES:
            names.append((f"local {name} {m[0]}x{m[1]}", m))
            cases.append(dict(kind="moe", mesh=m, x=x, tree=tree,
                              cfg=MoEConfig(**KW, capacity_factor=8.0)))
    names.append(("shard_map 2x2", (2, 2)))
    cases.append(dict(kind="moe", mesh=(2, 2), x=x,
                      tree=numpy_tree(params["cf1"][1]),
                      cfg=MoEConfig(**KW, capacity_factor=1.0)))
    return names, cases


def _moe_refs(x, params):
    """{case name: (y, aux)} of ``_moe_apply_local``."""
    out = {}
    for name, (jcfg, p) in params.items():
        y, aux = jax.jit(lambda p, x, c=jcfg: _moe_apply_local(p, x, c))(
            p, jnp.asarray(x))
        out[name] = np.asarray(y), float(aux)
    return out


def _jax_lm_calls(jlm, params, toks, feed):
    """The JAX LM's last-position logits of a prefill and decode steps,
    and the prefill's aux."""
    b, s = toks.shape
    prefill = jax.jit(lambda p, t, c: jlm.forward(
        p, t, view=JaxCacheView.prefill(), caches=c))
    decode = jax.jit(lambda p, t, c, n: jlm.forward(
        p, t, view=JaxCacheView.decode(n), caches=c))
    logits, caches, aux = prefill(
        params, jnp.asarray(toks),
        jlm.init_cache(b, s + feed.shape[0], jnp.float32))
    out = [np.asarray(logits)[:, -1]]
    for i in range(feed.shape[0]):
        logits, caches, _ = decode(params, jnp.asarray(feed[i]), caches,
                                   jnp.full((b,), s + i, jnp.int32))
        out.append(np.asarray(logits)[:, -1])
    return out, float(aux)


def _lm_cases(toks, feed):
    """Ample capacity (factor 8): the data shards' capacities drop
    nothing either, so every mesh holds to one JAX forward. Returns
    (names and meshes, rank cases, the JAX LM and params)."""
    jcfg = _with_capacity(jax_reduced("deepseek-v2-236b"), 8.0)
    tcfg = _with_capacity(get_reduced("deepseek-v2-236b"), 8.0)
    jlm = JaxLM(jcfg)
    params = jax.jit(jlm.init)(jax.random.PRNGKey(3))
    tree = numpy_tree(params)
    names, cases = [], []
    for m in ((1, 2), (1, 4), (2, 2)):
        names.append((f"deepseek-v2-236b {m[0]}x{m[1]}", m))
        cases.append(dict(kind="ep", mesh=m, cfg=tcfg, tree=tree, toks=toks,
                          feed=feed, dtype=torch.float32))
    return names, cases, (jlm, params)


@pytest.fixture(scope="module")
def runs():
    jcommon.set_compute_dtype(jnp.float32)
    tmp = tempfile.TemporaryDirectory(prefix="moe_ep_")
    try:
        x = np.random.default_rng(1).standard_normal((4, 16, D)).astype(
            np.float32)
        np.save(os.path.join(tmp.name, "x.npy"), x)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.abspath(
            os.path.join(os.path.dirname(__file__), "..", "src"))
        proc = subprocess.Popen(
            [sys.executable, "-c", _SUBPROC,
             os.path.join(tmp.name, "x.npy"),
             os.path.join(tmp.name, "y.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        try:
            params = _moe_params()
            rng = np.random.default_rng(2)
            toks = rng.integers(0, 512, (4, 8)).astype(np.int32)
            feed = rng.integers(0, 512, (2, 4, 1)).astype(np.int32)
            moe_names, moe_cases = _moe_cases(x, params)
            lm_names, lm_cases, (jlm, jparams) = _lm_cases(toks, feed)
            by_world = {}
            for name, case in zip(moe_names + lm_names,
                                  moe_cases + lm_cases):
                w = name[1][0] * name[1][1]
                by_world.setdefault(w, []).append((name, case))
            started = {w: mesh_mod.start(
                cases_rank, *pairs[0][0][1], backend="gloo", device="cpu",
                timeout_s=SPAWN_TIMEOUT_S,
                args=([c for _, c in pairs],), verbose=False)
                for w, pairs in by_world.items()}
            try:  # the JAX references while the ranks run
                local = _moe_refs(x, params)
                lm_ref = _jax_lm_calls(jlm, jparams, toks, feed)
                results = {w: r.join() for w, r in started.items()}
            finally:
                for r in started.values():
                    r.stop()
            out, err = proc.communicate(timeout=SPAWN_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
        assert proc.returncode == 0, err[-3000:]
        shard_map = np.load(os.path.join(tmp.name, "y.npz"))
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)
        tmp.cleanup()
    refs = {f"local {n} {m[0]}x{m[1]}": local[n] for n in ("2:4", "dense")
            for m in MOE_MESHES}
    refs.update({f"deepseek-v2-236b {m[0]}x{m[1]}": lm_ref
                 for m in ((1, 2), (1, 4), (2, 2))})
    got = {}
    for w, pairs in by_world.items():
        for i, ((name, mesh), _) in enumerate(pairs):
            got[name] = (mesh, refs.get(name),
                         [rank[i] for rank in results[w]])
    return dict(got=got, shard_map=(shard_map["y"], float(shard_map["aux"])),
                local_cf1=local["cf1"])


def _names(prefix):
    return [f"{prefix} {m[0]}x{m[1]}" for m in MOE_MESHES]


@pytest.mark.parametrize("name", _names("local 2:4") + _names("local dense"))
def test_ep_moe_matches_jax_local_path(runs, name):
    mesh, (y, aux), ranks = runs["got"][name]
    for rank, res in enumerate(ranks):
        np.testing.assert_allclose(res["y"], y, rtol=Y_TOL, atol=Y_TOL)
        assert abs(res["aux"] - aux) < AUX_TOL, (res["aux"], aux)
        per = KW["n_experts"] // mesh[1]
        assert res["experts"] == ((rank % mesh[1]) * per, per)


def test_ep_moe_at_capacity_one_matches_jax_shard_map(runs):
    y, aux = runs["shard_map"]
    _, _, ranks = runs["got"]["shard_map 2x2"]
    for res in ranks:
        np.testing.assert_allclose(res["y"], y, rtol=Y_TOL, atol=Y_TOL)
        assert abs(res["aux"] - aux) < AUX_TOL, (res["aux"], aux)
    # the per-shard capacity drops other assignments than the local path
    assert np.abs(runs["local_cf1"][0] - y).max() > 1e-3


@pytest.mark.parametrize("mesh", ["1x2", "1x4", "2x2"])
def test_reduced_deepseek_236b_forward_under_ep_matches_jax(runs, mesh):
    shape, (logits, aux), ranks = runs["got"][f"deepseek-v2-236b {mesh}"]
    calls = ranks[0]["calls"]
    assert len(calls) == len(logits)
    for call, ref in zip(calls, logits):
        np.testing.assert_allclose(call["logits"], ref, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
    per = 8 // shape[1]
    for rank, res in enumerate(ranks):
        assert abs(res["aux"] - aux) < AUX_TOL, (res["aux"], aux)
        assert res["experts"] == [((rank % shape[1]) * per, per)] * 2


def test_sharded_moe_outside_a_mesh_raises_and_whole_moe_under_one():
    from repro_torch.launch.mesh import ServeMesh
    from repro_torch.models.moe import MoE
    from repro_torch.parallel.hints import mesh_context

    gen = torch.Generator().manual_seed(0)
    cfg = MoEConfig(**KW)
    x = torch.randn(2, 4, D)
    moe = MoE.init(gen, D, cfg, sp=None, dtype=torch.float32)
    with torch.inference_mode(), mesh_context(ServeMesh(1, 2, 0, "gloo",
                                                    torch.device("cpu"))):
        with pytest.raises(ValueError, match="split over 1 rank"):
            moe(x)
    gen.manual_seed(0)
    half = MoE.init(gen, D, cfg, sp=None, dtype=torch.float32,
                    experts=(1, 2))
    assert (half.expert_offset, len(half.experts), half.ep_size) == (4, 4, 2)
    assert half.shared.w_up.w.shape == (D, KW["n_shared"] * 64 // 2)
    assert half.shared.w_down.w.shape == (KW["n_shared"] * 64 // 2, D)
    for got, want in zip(half.experts, list(moe.experts)[4:]):
        assert torch.equal(got.w_up.w, want.w_up.w)
    with torch.inference_mode(), pytest.raises(RuntimeError,
                                               match="never as a partial"):
        half(x)
