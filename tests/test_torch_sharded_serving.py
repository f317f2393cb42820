"""The port's ``ShardedServeEngine`` on gloo ranks on the CPU, at meshes
1x2 and 2x2, against both single-device engines (the port's
``ServeEngine`` and the JAX package's) on the same weights (the JAX
package's, handed over through ``repro_torch.interop``), in f32.

The matrix is the JAX package's (``tests/test_serving_sharded.py``):
reduced yi-9b, the same 5 prompts of 8 tokens, slots 2, max_seq 64,
prefill 8, max_new 4 + i; variants float 2:4, chunked (4), int8, mixed
2:4 / 1:4, kv heads split (kv_heads 4), block-sparse (local mask, block
8, window 12, chunked) and paged (kv heads split, chunks and pages of 4,
every prompt sharing its first page), plus a stream sampled at
temperature 0.8 (held to the port's single-device engine: the JAX
package's generator differs). Under jax 0.9.0 the JAX package's own
sharded engine compiles its prefill twice (its recompile assert fails
before its other variants run), so its single-device engine is the
reference here, the parity its test states.

Gates, on every rank: the streams equal; the last-position logits of a
prefill of the first two prompts within 1e-4 * max|logits| of the
port's single-device model; one nm_matmul dispatch per compressed
Linear each step call (no reference dispatch counts: on the CPU every
compressed GEMM runs its plain version); paged: one page sub-pool a data
shard (2 at 2x2) and prefix hits >= 1. One spawn per mesh runs every
variant; both meshes run while the single-device engines do.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.configs.base import AttnConfig as JaxAttnConfig
from repro.configs.base import SparsityConfig as JaxSparsityConfig
from repro.core.nmweight import MaskedNMWeight as JaxMaskedNMWeight
from repro.core.nmweight import NMWeight as JaxNMWeight
from repro.core.sparsity import NMConfig as JaxNMConfig
from repro.kernels.blocksparse_attn.mask import MaskSpec as JaxMaskSpec
from repro.models import common as jcommon
from repro.models.transformer import LM as JaxLM
from repro.quant import QNMWeight as JaxQNMWeight
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_reduced
from repro_torch.configs.base import SparsityConfig
from repro_torch.core.sparsity import NMConfig
from repro_torch.interop import lm_from_jax
from repro_torch.kernels.blocksparse_attn.mask import MaskSpec
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.sharded import prefill_logits, serve_rank
from repro_torch.serving.engine import Request, ServeEngine

MESHES = ((1, 2), (2, 2))
VARIANTS = ("float24", "chunked", "int8", "mixednm", "kvsharded",
            "blocksparse", "paged", "sampled")
ENGINE = dict(slots=2, max_seq=64, prefill_len=8)
LOGIT_TOL = 1e-4
SPAWN_TIMEOUT_S = 120


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny CPU ops: idle threads
    would spin beside the suite's other workers and the ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_tree(tree):
    if isinstance(tree, (JaxNMWeight, JaxQNMWeight)):
        node = {"vals": np.asarray(tree.vals), "idx": np.asarray(tree.idx),
                "n": tree.nm.n, "m": tree.nm.m, "axis": tree.axis,
                "mode": tree.kernel_policy.mode}
        if isinstance(tree, JaxQNMWeight):
            node["scales"] = np.asarray(tree.scales)
        return node
    if isinstance(tree, JaxMaskedNMWeight):
        return {"w": np.asarray(tree.w), "n": tree.nm.n, "m": tree.nm.m,
                "axis": tree.axis}
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    return np.asarray(tree)


def _cfgs(variant):
    """(JAX config, port config) of a variant."""
    j, t = jax_reduced("yi-9b"), get_reduced("yi-9b")
    if variant == "mixednm":
        j = dataclasses.replace(j, sparsity=JaxSparsityConfig(
            nm=JaxNMConfig(2, 4), mode="compressed",
            targets=("ffn", "attn_proj"),
            nm_overrides=(("attn_proj", JaxNMConfig(1, 4)),)))
        t = dataclasses.replace(t, sparsity=SparsityConfig(
            nm=NMConfig(2, 4), mode="compressed",
            targets=("ffn", "attn_proj"),
            nm_overrides=(("attn_proj", NMConfig(1, 4)),)))
    elif variant in ("kvsharded", "paged"):
        j, t = (dataclasses.replace(c, plan=tuple(
            (dataclasses.replace(b, mixer=dataclasses.replace(
                b.mixer, kv_heads=4)), rep) for b, rep in c.plan))
            for c in (j, t))
    elif variant == "blocksparse":
        def jmask(b):
            if not isinstance(b.mixer, JaxAttnConfig):
                return b
            return dataclasses.replace(b, mixer=dataclasses.replace(
                b.mixer, mask=JaxMaskSpec("local", block=8, window=12),
                window=None))
        j = dataclasses.replace(j, plan=tuple(
            (jmask(b), rep) for b, rep in j.plan))
        t = t.map_blocks(lambda b: dataclasses.replace(
            b, mixer=dataclasses.replace(
                b.mixer, mask=MaskSpec("local", block=8, window=12),
                window=None)))
    return j, t


# variants on the same weights (a mask changes no parameter)
WEIGHTS = {"mixednm": "mixednm", "kvsharded": "kvsharded",
           "paged": "kvsharded"}


def _case(variant, seed, params):
    """The variant's numpy weights, prompts and engine arguments."""
    jcfg, tcfg = _cfgs(variant)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, jcfg.vocab_size, size=8).astype(np.int32)
               for _ in range(5)]
    engine = dict(ENGINE)
    if variant in ("chunked", "blocksparse", "paged"):
        engine["prefill_chunk"] = 4
    if variant == "paged":
        for p in prompts[1:]:
            p[:4] = prompts[0][:4]  # every request shares the first page
    if variant == "sampled":
        engine.update(temperature=0.8, seed=3)
    return dict(variant=variant, jcfg=jcfg, cfg=tcfg, params=params[0],
                tree=params[1], prompts=prompts,
                max_new=[4 + i for i in range(5)], engine=engine,
                quantize="int8" if variant == "int8" else None,
                logits_prompts=np.stack(prompts[:2]))


def _serve(make, case, request):
    eng = make()
    for i, (p, n) in enumerate(zip(case["prompts"], case["max_new"])):
        eng.submit(request(rid=i, prompt=p, max_new=n))
    return {r.rid: list(map(int, r.out)) for r in eng.run()}


def _rank_case(case, paged):
    keep = ("cfg", "tree", "prompts", "max_new", "quantize",
            "logits_prompts")
    out = {k: case[k] for k in keep}
    out["engine"] = dict(case["engine"], paged=paged)
    out["dtype"] = torch.float32
    return out


@pytest.fixture(scope="module")
def runs():
    jcommon.set_compute_dtype(jnp.float32)  # exactness for parity
    try:
        weights = {}
        for w in dict.fromkeys(WEIGHTS.get(v, "yi") for v in VARIANTS):
            p = jax.jit(JaxLM(_cfgs(w)[0]).init)(
                jax.random.PRNGKey(len(weights)))
            weights[w] = p, numpy_tree(p)
        cases = {v: _case(v, i, weights[WEIGHTS.get(v, "yi")])
                 for i, v in enumerate(VARIANTS)}
        rank_cases = [_rank_case(cases[v], v == "paged") for v in VARIANTS]
        started = {m: mesh_mod.start(serve_rank, *m, backend="gloo",
                                     device="cpu",
                                     timeout_s=SPAWN_TIMEOUT_S,
                                     args=(rank_cases,), verbose=False)
                   for m in MESHES}
        try:
            single, jax_single, logits = {}, {}, {}
            for v, case in cases.items():
                lm = lm_from_jax(case["cfg"], case["tree"],
                                 dtype=torch.float32, device="cpu")
                single[v] = _serve(lambda: ServeEngine(
                    lm, quantize=case["quantize"], **case["engine"]), case,
                    Request)
                # after the engine: int8 quantizes the model in place
                logits[v] = prefill_logits(
                    lm, mesh_mod.make_serve_mesh(backend="gloo",
                                                 device="cpu"),
                    case["logits_prompts"])
                if v != "sampled":
                    jl = JaxLM(case["jcfg"])
                    jax_single[v] = _serve(lambda: JaxServeEngine(
                        jl, case["params"], quantize=case["quantize"],
                        **case["engine"]), case, JaxRequest)
            sharded = {m: r.join() for m, r in started.items()}
        finally:
            for r in started.values():
                r.stop()
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)
    return dict(cases=cases, single=single, jax=jax_single, logits=logits,
                sharded={m: {v: [rank[i] for rank in res]
                             for i, v in enumerate(VARIANTS)}
                         for m, res in sharded.items()})


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("variant", VARIANTS)
def test_sharded_streams_equal_both_single_device_engines(runs, variant,
                                                          mesh):
    single = runs["single"][variant]
    if variant != "sampled":
        assert single == runs["jax"][variant], (variant, "port single vs "
                                                "JAX single")
    assert len(single) == 5
    for rank, res in enumerate(runs["sharded"][mesh][variant]):
        assert res["streams"] == single, (variant, mesh, rank)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("variant", VARIANTS)
def test_sharded_logits_and_one_dispatch_per_linear_a_step(runs, variant,
                                                           mesh):
    ref = runs["logits"][variant]
    tol = LOGIT_TOL * float(np.abs(ref).max())
    for res in runs["sharded"][mesh][variant]:
        np.testing.assert_allclose(res["logits"], ref, rtol=0, atol=tol)
        calls = sum(res["step_calls"].values())
        nm = {k: v for k, v in res["counts"]["dispatches"].items()
              if k[0].startswith("nm_matmul")}
        assert sum(nm.values()) == res["linears"] * calls, (nm, calls)
        # the tensor-parallel plan of reduced yi-9b (q 8, kv 1 or 4)
        kv = variant in ("kvsharded", "paged")
        assert res["plan"] == (True, kv, True)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_paged_sub_pool_per_data_shard_and_prefix_hits(runs, mesh):
    for res in runs["sharded"][mesh]["paged"]:
        assert res["groups"] == mesh[0]
        assert res["stats"]["prefix_hit_pages"] >= 1, res["stats"]


def test_slots_must_divide_over_data_and_moe_is_refused():
    from repro_torch.launch.mesh import ServeMesh
    from repro_torch.models.transformer import LM
    from repro_torch.serving.engine import ShardedServeEngine

    mesh = ServeMesh(2, 1, 0, "gloo", torch.device("cpu"))
    lm = LM.init(get_reduced("yi-9b"), seed=0, dtype=torch.float32,
                 device="cpu")
    with pytest.raises(ValueError, match="divide over the data axis"):
        ShardedServeEngine(lm, mesh=mesh, slots=3, max_seq=16,
                           prefill_len=8)
    with pytest.raises(NotImplementedError, match="eagerly"):
        ShardedServeEngine(lm, mesh=mesh, slots=2, max_seq=16,
                           prefill_len=8, graphs=True)
    ds = LM.init(get_reduced("deepseek-v2-236b"), seed=0,
                 dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        ShardedServeEngine(ds, mesh=mesh, slots=2, max_seq=16,
                           prefill_len=8)


def test_a_rank_that_raises_fails_the_spawn_without_a_hang():
    """A rank that raises before the others' collective: the spawn raises
    (with the rank's traceback) and kills the ranks left waiting."""
    case = dict(cfg=get_reduced("deepseek-v2-236b"), seed=0,
                engine=dict(ENGINE), prompts=[], max_new=[])
    with pytest.raises(RuntimeError, match="MoE"):
        mesh_mod.spawn(serve_rank, 1, 2, backend="gloo", device="cpu",
                       timeout_s=SPAWN_TIMEOUT_S, args=([case],),
                       verbose=False)
