"""The port's sharded train step (``repro_torch.training.sharded``) on
gloo ranks on the CPU, against the JAX package's single-device
``make_train_step`` on the whole batch, from the same weights (the JAX
package's, through ``repro_torch.interop``) and the same
``DataPipeline`` batches, f32 compute. These configs have no MoE, so
the function does not depend on the mesh and JAX's single-device step
is the oracle (its step under an ``Auto``-axis mesh computes the same;
the explicit-axis meshes of jax 0.9's ``make_mesh`` fail,
``tests/test_sharding.py``). The MoE and recurrent configs are held to
JAX's mesh step in ``tests/test_torch_sharded_training_moe.py`` and
``tests/test_torch_sharded_training_recurrent.py``.

* Reduced yi-9b (q heads split, its one KV head replicated: the MQA
  path) at meshes 2x1, 1x2 and 2x2 in "fsdp" mode and 2x2 "tp_only", 3
  steps; at 2x2 also with 2 microbatches and with int8 gradient
  compression (the error state gathered too, and a planted fault, each
  leaf's int8 amax taken on the rank's own slice, which the compressed
  run's check must catch); at 1x2 reduced
  chameleon-34b (its q / k norms inside the split heads) and an MLA +
  dense-FFN plan. Loss, nll, lr and grad_norm within 1e-5 relative
  after every step; every parameter and both moments, assembled from
  the ranks' slices, within 2e-5 absolute after steps 1 and 3: the
  tolerances of ``tests/test_torch_training.py``'s f32 steps. The
  compressed run is held as that file holds the single process's
  compressed run (a gradient entry within rounding noise of an int8
  boundary lands one quantum apart).
* The training rules ``param_specs`` (both modes), ``batch_spec``,
  ``dp_axes`` and ``cache_specs`` equal the JAX package's
  ``param_pspecs``, ``batch_pspec``, ``dp_axes`` and ``cache_pspecs`` on
  a fake 4x2 mesh and a fake 2x2x2 pod mesh.
* Elastic restore: the 2x2 run's state saved whole after step 2 resumes
  at 1x2 and in one process, and step 3 equals the uninterrupted run's;
  the counterpart of ``tests/test_checkpoint.py::
  test_elastic_replacement_onto_shardings``.
* An encoder-decoder config (cross-attention blocks) is refused by the
  serving plan and split by the training plan (its sharded training:
  ``tests/test_torch_sharded_training_encdec.py``); a rank that raises
  (an MoE whose experts do not divide over the model ranks) fails the
  spawn, and nothing hangs.

One spawn a world size (4, then 2) runs every case of its meshes while
the JAX side runs in the parent.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core.nmweight import MaskedNMWeight as JaxMasked
from repro.core.nmweight import NMWeight as JaxNMWeight
from repro.data.pipeline import DataPipeline as JaxPipeline
from repro.data.pipeline import PipelineConfig as JaxPipelineConfig
from repro.models import common as jcommon
from repro.models.transformer import LM as JaxLM
from repro.optim.optimizer import AdamWConfig as JaxAdamW
from repro.optim.optimizer import adamw_init as jax_adamw_init
from repro.parallel.sharding import batch_pspec, cache_pspecs, param_pspecs
from repro.parallel.sharding import dp_axes as jax_dp_axes
from repro.quant import QNMWeight as JaxQNMWeight
from repro.quant import quantize_tree as jax_quantize_tree
from repro.training import train_loop as jtrain
from repro_torch.configs import get_reduced
from repro_torch.interop import lm_from_jax
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.sharded import train_rank
from repro_torch.models.transformer import LM
from repro_torch.optim.optimizer import AdamWConfig
from repro_torch.parallel.sharding import (
    batch_spec,
    cache_specs,
    dp_axes,
    param_specs,
)
from repro_torch.training.checkpoint import Checkpointer, Region
from repro_torch.training.train_loop import (
    TrainConfig,
    init_train_state,
    make_train_step,
)

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
STEPS = 3
PIPE = dict(seq_len=16, global_batch=4)
SPAWN_TIMEOUT_S = 120
METRIC_RTOL, STATE_ATOL = 1e-5, 2e-5


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
    if isinstance(tree, JaxMasked):
        return {"w": np.asarray(tree.w), "n": tree.nm.n, "m": tree.nm.m,
                "axis": tree.axis}
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    return np.asarray(tree)


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


def _cfgs(kind):
    """(JAX config, port config) of a case."""
    if kind == "yi":
        return jax_reduced("yi-9b"), get_reduced("yi-9b")
    if kind == "chameleon":
        return jax_reduced("chameleon-34b"), get_reduced("chameleon-34b")
    if kind == "mla":  # deepseek's MLA with its dense-FFN first block
        j, t = jax_reduced("deepseek-v2-236b"), get_reduced(
            "deepseek-v2-236b")
        return (dataclasses.replace(j, plan=((j.plan[0][0], 2),)),
                dataclasses.replace(t, plan=((t.plan[0][0], 2),)))
    raise KeyError(kind)


def _named(cfg, tree) -> dict:
    """A JAX tree (params or a moment) by the port's parameter names."""
    return {n: p.detach().numpy() for n, p in
            lm_from_jax(cfg, tree, device="cpu").named_parameters()}


def _jax_run(kind, steps=STEPS, **tkw):
    """JAX's single-device steps on the whole batch: each step's metrics
    and the state after it ({"params" | "m" | "v": {name: array}}), and
    the initial numpy weights and the batches."""
    jcfg, tcfg = _cfgs(kind)
    jcommon.set_compute_dtype(jnp.float32)
    try:
        jlm = JaxLM(jcfg)
        params = jax.jit(jlm.init)(jax.random.PRNGKey(0))
        tree = numpy_tree(params)
        step = jax.jit(jtrain.make_train_step(jlm, jtrain.TrainConfig(
            opt=JaxAdamW(**OPT), remat="none", **tkw)))
        opt = jax_adamw_init(params)
        comp = tkw.get("grad_compression", False)
        err = jtrain.init_compress_state(params) if comp else None
        pipe = JaxPipeline(JaxPipelineConfig(vocab_size=jcfg.vocab_size,
                                             **PIPE))
        batches = [pipe.next() for _ in range(steps)]
        metrics, states = [], []
        for b in batches:
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            if comp:
                params, opt, err, m = step(params, opt, jb, err)
            else:
                params, opt, m = step(params, opt, jb)
            metrics.append({k: float(v) for k, v in m.items()})
            st = {"params": _named(tcfg, numpy_tree(params))}
            for part in ("m", "v"):
                t = numpy_tree(opt[part])
                _fill_idx(t, numpy_tree(params))
                st[part] = _named(tcfg, t)
            if comp:
                t = numpy_tree(err)
                _fill_idx(t, numpy_tree(params))
                st["err"] = _named(tcfg, t)
            states.append(st)
        return {"tree": tree, "batches": batches, "metrics": metrics,
                "states": states, "cfg": tcfg}
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)


def _port_err(ref) -> dict:
    """The error state of the port's single-process compressed run on
    the same weights and batches."""
    tc = TrainConfig(opt=AdamWConfig(**OPT), remat="none",
                     grad_compression=True)
    lm = lm_from_jax(ref["cfg"], ref["tree"], device="cpu")
    step = make_train_step(lm, tc)
    lm, opt, err = init_train_state(lm, tc)
    for b in ref["batches"]:
        lm, opt, err, _ = step(lm, opt, b, err)
    return {n: t.numpy() for n, t in err.items()}


def _train_rank_then_planted(mesh, cases, planted):
    """``train_rank`` on ``cases``, then on ``planted`` with a planted
    fault: each leaf's int8 amax taken on the rank's own slice, not over
    the ranks (``ServeMesh.all_max`` the identity; the rank's process
    ends with this call)."""
    out = train_rank(mesh, cases)
    mesh_mod.ServeMesh.all_max = lambda self, x, name: x
    return out + train_rank(mesh, planted)


def _case(ref, mesh, *, mode="fsdp", state=(1, STEPS), **kw):
    tkw = {k: kw.pop(k) for k in ("microbatches", "grad_compression")
           if k in kw}
    return dict(cfg=ref["cfg"], tree=ref["tree"], compute="f32", mode=mode,
                policy="auto",
                tcfg=TrainConfig(opt=AdamWConfig(**OPT), remat="none",
                                 **tkw),
                batches=ref["batches"], mesh=mesh, state=state, **kw)


@pytest.fixture(scope="module")
def refs():
    return {"yi": _jax_run("yi"),
            "yi_mb2": _jax_run("yi", microbatches=2),
            "yi_comp": _jax_run("yi", grad_compression=True),
            "chameleon": _jax_run("chameleon", steps=2),
            "mla": _jax_run("mla", steps=2)}


@pytest.fixture(scope="module")
def runs(refs, tmp_path_factory):
    """Every sharded case: the world-4 spawn (2x2), then the world-2
    spawn (2x1, 1x2 and the resume from the 2x2 checkpoint)."""
    ckpt = str(tmp_path_factory.mktemp("sharded_ckpt"))
    four = {"fsdp": _case(refs["yi"], (2, 2), save=(ckpt, 2)),
            "tp_only": _case(refs["yi"], (2, 2), mode="tp_only"),
            "mb2": _case(refs["yi_mb2"], (2, 2), microbatches=2),
            "comp": _case(refs["yi_comp"], (2, 2), grad_compression=True)}
    planted = _case(refs["yi_comp"], (2, 2), grad_compression=True)
    got = mesh_mod.spawn(_train_rank_then_planted, 2, 2, backend="gloo",
                         device="cpu", timeout_s=SPAWN_TIMEOUT_S,
                         verbose=False, args=(list(four.values()),
                                              [planted]))
    out = {(2, 2, k): [r[i] for r in got]
           for i, k in enumerate(list(four) + ["comp_rank_amax"])}
    two = {(2, 1, "fsdp"): _case(refs["yi"], (2, 1)),
           (1, 2, "fsdp"): _case(refs["yi"], (1, 2)),
           (1, 2, "chameleon"): _case(refs["chameleon"], (1, 2), state=(2,)),
           (1, 2, "mla"): _case(refs["mla"], (1, 2), state=(2,)),
           (1, 2, "resume"): _case(refs["yi"], (1, 2), resume=(ckpt, 2),
                                   state=(STEPS,))}
    got = mesh_mod.spawn(train_rank, 1, 2, backend="gloo", device="cpu",
                         timeout_s=SPAWN_TIMEOUT_S, verbose=False,
                         args=(list(two.values()),))
    out.update({k: [r[i] for r in got] for i, k in enumerate(two)})
    return out, ckpt


def _assemble(ranks, part, step=STEPS) -> dict:
    """{name: the whole array} after ``step`` from the ranks' slices;
    every element covered, replicated copies equal."""
    out, seen = {}, {}
    for r in ranks:
        for name, (arr, region) in r["states"][step][part].items():
            if name not in out:
                out[name] = np.zeros(region.shape, np.float32)
                seen[name] = np.zeros(region.shape, bool)
            prev = out[name][region.index]
            held = seen[name][region.index]
            np.testing.assert_array_equal(prev[held], arr[held],
                                          err_msg=f"{part} {name}")
            out[name][region.index] = arr
            seen[name][region.index] = True
    for name, s in seen.items():
        assert s.all(), f"{part} {name}: not every element is held"
    return out


def _check_metrics(ranks, ref, rtol=METRIC_RTOL, first=0):
    for r in ranks:
        assert len(r["metrics"]) == len(ref["metrics"]) - first
        for got, want in zip(r["metrics"], ref["metrics"][first:]):
            for key in ("loss", "nll", "lr", "grad_norm"):
                np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                           atol=1e-7, err_msg=key)


def _check_state(ranks, want, step=STEPS, parts=("params", "m", "v"),
                 atol=STATE_ATOL):
    for part in parts:
        got = _assemble(ranks, part, step)
        assert set(got) == set(want[part])
        for name, arr in got.items():
            np.testing.assert_allclose(arr, want[part][name], rtol=0,
                                       atol=atol, err_msg=f"{part} {name}")


MESH_IDS = {(2, 1): "2x1", (1, 2): "1x2", (2, 2): "2x2"}


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("mesh", list(MESH_IDS), ids=list(MESH_IDS.values()))
def test_fsdp_steps_match_jax_whole_batch_step(runs, refs, mesh, steps):
    ranks = runs[0][mesh + ("fsdp",)]
    _check_metrics([dict(r, metrics=r["metrics"][:steps]) for r in ranks],
                   dict(refs["yi"], metrics=refs["yi"]["metrics"][:steps]))
    _check_state(ranks, refs["yi"]["states"][steps - 1], steps)
    # one nm_matmul dispatch a compressed Linear a step (the plain
    # version on the CPU), nothing else
    for r in ranks:
        n = r["linears"] * STEPS
        assert r["dispatches"] == {("nm_matmul", "nm_spmm", "cpu"): n}


def test_fsdp_splits_storage_over_data(runs):
    """At 2x2 fsdp a rank holds a quarter of each split projection
    (model x data), half of the embedding and head (data only); in
    tp_only the data ranks hold the same whole shard."""
    fsdp = runs[0][(2, 2, "fsdp")][0]["states"][STEPS]["params"]
    tp = runs[0][(2, 2, "tp_only")][0]["states"][STEPS]["params"]
    arr, region = fsdp["layers.0.mixer.wq.vals"]
    assert arr.size * 4 == int(np.prod(region.shape))
    arr, region = fsdp["embed.table"]
    assert arr.size * 2 == int(np.prod(region.shape))
    arr, region = tp["embed.table"]
    assert arr.size == int(np.prod(region.shape))
    a = runs[0][(2, 2, "tp_only")]
    for name in tp:
        np.testing.assert_array_equal(
            a[0]["states"][STEPS]["params"][name][0],
            a[2]["states"][STEPS]["params"][name][0])


def test_tp_only_steps_match_jax(runs, refs):
    ranks = runs[0][(2, 2, "tp_only")]
    _check_metrics(ranks, refs["yi"])
    _check_state(ranks, refs["yi"]["states"][-1])


def test_microbatches_match_jax(runs, refs):
    ranks = runs[0][(2, 2, "mb2")]
    _check_metrics(ranks, refs["yi_mb2"])
    _check_state(ranks, refs["yi_mb2"]["states"][-1])
    for r in ranks:  # two forwards a step
        assert r["dispatches"] == {("nm_matmul", "nm_spmm", "cpu"):
                                   r["linears"] * STEPS * 2}


# the compressed run's limits (see test_grad_compression_matches_jax):
# relative in norm, the updates from the initial weights for the params
COMP_RTOL = {"params": 0.25, "m": 0.06, "v": 0.06, "err": 0.06}


def _compressed_distances(ranks, ref) -> dict:
    """{part: the largest relative distance in norm of a tensor} of the
    ranks' compressed run after the last step: params (their updates),
    m and v from JAX's, err from the port's single process's."""
    want = dict(ref["states"][-1], err=_port_err(ref))
    init = _named(ref["cfg"], ref["tree"])
    out = {}
    for part in COMP_RTOL:
        got = _assemble(ranks, part)
        assert set(got) == set(want[part])
        out[part] = 0.0
        for name, arr in got.items():
            a, b = arr, want[part][name]
            if part == "params":
                a, b = a - init[name], b - init[name]
            out[part] = max(out[part], float(
                np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)))
    return out


def test_grad_compression_matches_jax(runs, refs):
    """As tests/test_torch_training.py holds the single process's
    compressed steps: int8 rounding puts an entry within rounding noise
    of a boundary one quantum (max|g| / 127 of its tensor) apart, so the
    loss to 1e-4, grad_norm to 1e-3, the moments to 6% in norm and the
    updates from the initial weights to 0.25 in norm. The error state is
    the residual below a quantum, which one such flip moves by a whole
    quantum: the port's single process and JAX's lie 4% apart in norm
    after one step and 17-105% after three, so the ranks' error state is
    held to the port's single process on the same batches, within the
    moments' 6% in norm (a summation order of its own flips entries
    too)."""
    ranks = runs[0][(2, 2, "comp")]
    ref = refs["yi_comp"]
    for r in ranks:
        for got, want in zip(r["metrics"], ref["metrics"]):
            for key, rtol in (("loss", 1e-4), ("nll", 1e-4), ("lr", 1e-6),
                              ("grad_norm", 1e-3)):
                np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                           atol=1e-7, err_msg=key)
    dist = _compressed_distances(ranks, ref)
    for part, tol in COMP_RTOL.items():
        assert dist[part] < tol, (part, dist)


def test_grad_compression_check_catches_a_per_rank_amax(runs, refs):
    """The planted fault that only a sharded run can have: each leaf's
    int8 amax taken on the rank's own slice, not over the ranks. Its
    error state lies over 100% in norm from the port's single process
    (a rank whose slice holds a smaller amax quantizes on a finer grid),
    far beyond the compressed run's 6%, while its moments and updates
    stay inside their limits: the error state is what catches it."""
    dist = _compressed_distances(runs[0][(2, 2, "comp_rank_amax")],
                                 refs["yi_comp"])
    assert dist["err"] > COMP_RTOL["err"], dist


@pytest.mark.parametrize("kind", ["chameleon", "mla"])
def test_other_attention_configs_match_jax(runs, refs, kind):
    """chameleon's q / k norms act inside the rank's heads (their
    gradients summed over "model"); MLA's latent and rope key enter the
    heads replicated."""
    ranks = runs[0][(1, 2, kind)]
    _check_metrics(ranks, refs[kind])
    _check_state(ranks, refs[kind]["states"][-1], 2)


def test_resume_at_1x2_from_the_2x2_checkpoint(runs, refs):
    """The 2x2 fsdp run's state saved whole after step 2 restores at 1x2
    (each rank loading its regions) and its step 3 equals the
    uninterrupted 2x2 run's and JAX's."""
    out, ckpt = runs
    ranks = out[(1, 2, "resume")]
    _check_metrics(ranks, refs["yi"], first=2)
    unbroken = out[(2, 2, "fsdp")][0]["metrics"][2]
    for r in ranks:
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(r["metrics"][0][key], unbroken[key],
                                       rtol=METRIC_RTOL)
    _check_state(ranks, refs["yi"]["states"][-1])
    assert Checkpointer(ckpt).list_steps() == [2]


def test_the_sharded_checkpoint_restores_in_one_process(runs, refs):
    """Format 3, the whole arrays: one process restores the 2x2 state of
    step 2 into an ordinary model and its step 3 equals JAX's."""
    _, ckpt = runs
    ref = refs["yi"]
    tc = TrainConfig(opt=AdamWConfig(**OPT), remat="none")
    lm = LM.init(ref["cfg"], seed=1, dtype=torch.float32, device="cpu")
    _, opt = init_train_state(lm, tc)
    state, meta = Checkpointer(ckpt).restore({"params": lm, "opt": opt})
    assert meta["format"] == 3 and meta["step"] == 2
    np.testing.assert_allclose(
        lm.embed.table.detach().numpy(),
        ref["states"][1]["params"]["embed.table"], rtol=0, atol=STATE_ATOL)
    lm, opt, m = make_train_step(lm, tc)(lm, state["opt"],
                                         ref["batches"][2])
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), ref["metrics"][2][key],
                                   rtol=METRIC_RTOL)
    for name, p in lm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref["states"][2]["params"][name],
                                   rtol=0, atol=STATE_ATOL, err_msg=name)


def test_elastic_restore_onto_regions(tmp_path):
    """The port's counterpart of tests/test_checkpoint.py::
    test_elastic_replacement_onto_shardings: a leaf restored under a
    region holds that region of the saved array; a whole region gives it
    back whole; a region of another whole shape is refused."""
    ck = Checkpointer(str(tmp_path))
    w = torch.arange(16.0).reshape(4, 4)
    ck.save(1, {"w": w, "b": torch.arange(6, dtype=torch.bfloat16)})
    got, _ = ck.restore({"w": torch.zeros(4, 2), "b": torch.zeros(
        3, dtype=torch.bfloat16)}, shardings={
        "w": Region((4, 4), (slice(None), slice(2, 4))),
        "b": Region((6,), (slice(3, 6),))})
    assert torch.equal(got["w"], w[:, 2:])
    assert torch.equal(got["b"], torch.arange(3, 6, dtype=torch.bfloat16))
    got, _ = ck.restore({"w": torch.zeros(4, 4), "b": torch.zeros(6)},
                        shardings={"w": Region((4, 4), (slice(None),) * 2)})
    assert torch.equal(got["w"], w)
    with pytest.raises(ValueError, match="whole shape"):
        ck.restore({"w": torch.zeros(2, 4), "b": torch.zeros(6)},
                   shardings={"w": Region((8, 4), (slice(0, 2),
                                                   slice(None)))})


# ---------------------------------------------------------------------------
# the rule functions against the JAX package's
# ---------------------------------------------------------------------------


class _Mesh42:
    axis_names = ("data", "model")

    class devices:  # noqa: D106
        shape = (4, 2)
        size = 8


class _Pod222:
    axis_names = ("pod", "data", "model")

    class devices:  # noqa: D106
        shape = (2, 2, 2)
        size = 8


MESHES = {"4x2": _Mesh42, "pod2x2x2": _Pod222}
RULE_ARCHS = ("yi-9b", "deepseek-v2-lite-16b", "rwkv6-3b", "jamba-v0.1-52b",
              "whisper-medium")


def _shape(mesh):
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _norm(spec) -> tuple:
    """A spec with each one-name tuple as the name: the same sharding
    (newer JAX normalizes P(("data",)) to P("data"))."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _jax_param_specs(jcfg, mesh, mode, quantize):
    """{port tensor name: JAX spec (padded to the leaf's rank, the layer
    stack axis dropped; an expert's with its E entry dropped)}."""
    lm = JaxLM(jcfg)

    def init():
        p = lm.init(jax.random.PRNGKey(0))
        return jax_quantize_tree(p) if quantize else p

    params = jax.eval_shape(init)
    specs = param_pspecs(params, mesh, mode)
    is_node = (JaxNMWeight, JaxQNMWeight, JaxMasked)
    leaves = jax.tree_util.tree_flatten_with_path(
        params, is_leaf=lambda x: isinstance(x, is_node))[0]
    sleaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(
            x, is_node + (jax.sharding.PartitionSpec,)))[0]
    by_path = {jax.tree_util.keystr(p): s for p, s in sleaves}
    out = {}
    for group_key, port_key, plan in (("groups", "layers", jcfg.plan),
                                      ("enc_groups", "enc_layers",
                                       jcfg.encoder_plan)):
        index, first = {}, 0
        for g, (entry, rep) in enumerate(plan or ()):
            size = len(entry) if isinstance(entry, tuple) else 1
            for r in range(rep):
                for j in range(size):
                    index[(g, j, r)] = first + r * size + j
            first += rep * size
        for path, leaf in leaves:
            keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
            if keys[0] != group_key:
                continue
            spec = by_path[jax.tree_util.keystr(path)]
            for name, arr, sp in _parts(leaf, spec):
                full = tuple(sp) + (None,) * (arr.ndim - len(tuple(sp)))
                within = [str(k) for k in keys[3:]]
                rep = plan[keys[1]][1]
                tail = full[1:] if rep > 1 else full
                for r in range(rep):
                    layer = index[(keys[1], keys[2], r)]
                    if "experts" in within:
                        e_at = within.index("experts")
                        n_exp = arr.shape[1 if rep > 1 else 0]
                        for e in range(n_exp):
                            w = within[:e_at + 1] + [str(e)] + \
                                within[e_at + 1:]
                            out[_key(port_key, layer, w, name)] = tail[1:]
                    else:
                        out[_key(port_key, layer, within, name)] = tail
    top = {"embed": "embed", "enc_embed": "enc_embed", "lm_head": "lm_head",
           "final_norm": "final_norm", "enc_final_norm": "enc_final_norm"}
    for path, leaf in leaves:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] in ("groups", "enc_groups"):
            continue
        spec = by_path[jax.tree_util.keystr(path)]
        for name, arr, sp in _parts(leaf, spec):
            full = tuple(sp) + (None,) * (arr.ndim - len(tuple(sp)))
            if keys[0] in ("pos", "enc_pos"):
                out[f"{keys[0]}.table"] = full
            elif keys[-1] == "embedding":
                out[f"{top[keys[0]]}.table"] = full
            else:
                tail = [str(k) for k in keys]
                out[".".join(tail + ([name] if name else []))] = full
    return out


def _key(port_key, layer, within, name):
    return ".".join([port_key, str(layer)] + within + ([name] if name
                                                       else []))


def _parts(leaf, spec):
    if isinstance(leaf, (JaxNMWeight, JaxQNMWeight)):
        yield "vals", leaf.vals, spec.vals
        yield "idx", leaf.idx, spec.idx
        if isinstance(leaf, JaxQNMWeight):
            yield "scales", leaf.scales, spec.scales
    elif isinstance(leaf, JaxMasked):
        yield "w", leaf.w, spec.w
    else:
        yield None, leaf, spec


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", ["fsdp", "tp_only"])
@pytest.mark.parametrize("arch,quantize", [(a, None) for a in RULE_ARCHS]
                         + [("yi-9b", "int8")],
                         ids=list(RULE_ARCHS) + ["yi-9b-int8"])
def test_param_specs_match_param_pspecs(arch, quantize, mode, mesh):
    jspecs = _jax_param_specs(jax_reduced(arch), MESHES[mesh], mode,
                              quantize)
    lm = LM.init(get_reduced(arch), seed=0, dtype=torch.float32,
                 device="cpu", quantize=quantize)
    tspecs = param_specs(lm, _shape(MESHES[mesh]), mode)
    assert set(tspecs) == set(jspecs), sorted(set(tspecs) ^ set(jspecs))
    for name, spec in jspecs.items():
        assert tspecs[name] == spec, (name, tspecs[name], spec)
    flat = [a for s in tspecs.values() for a in s if a]
    assert ("data" in flat) == (mode == "fsdp")
    assert "model" in flat


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_and_dp_axes_match(mesh):
    m = MESHES[mesh]
    assert dp_axes(_shape(m)) == jax_dp_axes(m)
    for b in (1, 2, 3, 4, 6, 8, 16):
        for rank in (2, 3):
            assert batch_spec(b, _shape(m), rank) == _norm(
                batch_pspec(b, m, rank)), (b, rank)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v2-lite-16b",
                                  "jamba-v0.1-52b", "rwkv6-3b"])
def test_cache_specs_match_cache_pspecs(arch, mesh):
    m = MESHES[mesh]
    axes = dp_axes(_shape(m))
    jcfg, tcfg = jax_reduced(arch), get_reduced(arch)
    jlm = JaxLM(jcfg)
    caches = jax.eval_shape(lambda: jlm.init_cache(8, 64,
                                                   dtype=jnp.bfloat16))
    jspecs = cache_pspecs(caches, m, batch_axes=axes)
    lm = LM.init(tcfg, seed=0, dtype=torch.float32, device="cpu")
    tspecs = cache_specs(lm.init_cache(8, 64), _shape(m), batch_axes=axes)
    layer = 0
    for g, (entry, rep) in enumerate(jcfg.plan):
        size = len(entry) if isinstance(entry, tuple) else 1
        for r in range(rep):
            for j in range(size):
                want = jspecs[g][j]
                got = tspecs[layer]
                assert set(got) == set(want), (layer, got, want)
                for k, sp in want.items():
                    arr = caches[g][j][k]
                    full = tuple(sp) + (None,) * (arr.ndim - len(sp))
                    assert got[k] == _norm(full[1:] if rep > 1 else full), (
                        layer, k, got[k], full)
                layer += 1
    assert tspecs[0][next(iter(tspecs[0]))][0] is not None


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_encoder_decoder_configs_raise():
    """Cross-attention blocks (whisper-medium) are refused by the serving
    plan, as JAX's ``serve_tp_plan`` refuses them, and split by the
    training plan: the encoder's, the decoder's and the cross blocks'
    heads and FFNs (``tests/test_torch_sharded_training_encdec.py``);
    one rank's sharded train step builds on the whole model."""
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.parallel.sharding import serve_tp_plan, train_tp_plan
    from repro_torch.training.sharded import make_sharded_train_step

    cfg = get_reduced("whisper-medium")
    for tp in (1, 2, 4):
        with pytest.raises(NotImplementedError, match="cross_attn"):
            serve_tp_plan(cfg, tp)
    plan = train_tp_plan(cfg, 2)
    assert (plan.shard_attn, plan.shard_kv, plan.shard_ffn) == (True,) * 3
    assert "enc_out" in plan.train_tags
    lm = LM.init(cfg, seed=0, dtype=torch.float32, device="cpu")
    mesh = make_serve_mesh(backend="gloo", device="cpu")
    make_sharded_train_step(lm, TrainConfig(), mesh)


def _odd_experts(cfg, n):
    """``cfg`` with every MoE block's experts ``n``."""
    def fix(blk):
        if hasattr(blk.mlp, "n_experts"):
            return dataclasses.replace(blk, mlp=dataclasses.replace(
                blk.mlp, n_experts=n))
        return blk

    return dataclasses.replace(cfg, plan=tuple((fix(e), r)
                                               for e, r in cfg.plan))


def test_a_rank_that_raises_fails_the_spawn():
    """An MoE of 7 experts does not split over 2 model ranks: the
    training plan raises on each rank, and the spawn fails."""
    case = dict(cfg=_odd_experts(get_reduced("deepseek-v2-lite-16b"), 7),
                seed=0, tcfg=TrainConfig(), batches=[], mesh=(1, 2))
    with pytest.raises(RuntimeError, match="NotImplementedError"):
        mesh_mod.spawn(train_rank, 1, 2, backend="gloo", device="cpu",
                       timeout_s=SPAWN_TIMEOUT_S, verbose=False,
                       args=([case],))
