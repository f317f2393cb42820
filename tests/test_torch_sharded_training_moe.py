"""The port's sharded train step (``repro_torch.training.sharded``) on an
MoE config, reduced deepseek-v2-lite-16b (MLA + MoE with shared experts,
its first layer a dense FFN), on gloo ranks on the CPU, from the JAX
package's weights (``repro_torch.interop``) and ``DataPipeline``
batches, f32 compute, 3 steps:

* at 1x2 and 1x4 against JAX's single-device ``make_train_step`` on the
  whole batch (equal there: one data shard);
* at 2x2 fsdp and 2x2 tp_only, at the config's capacity factor and at
  1.0, against JAX's step jitted under an ``Auto``-axis (2, 2)
  ``data x model`` mesh on a forced 8-device host (run in one
  subprocess: the device count is fixed when jax starts). There the MoE
  takes its expert-parallel ``shard_map`` path, whose capacity and aux
  are per data shard, so the single-device step is no oracle, which
  the test shows too (and JAX's explicit-axis meshes, jax 0.9's default,
  fail: ``with_sharding_constraint`` asserts there);
* the port's shard-wise single process (``launch.sharded.
  make_shardwise_train_step``, the card's 2x2 oracle) against the same
  JAX mesh step;
* a planted fault: the aux's gradient on every model rank while the
  router's gradient is summed over "model" (counting the aux tp times),
  which the check must catch;
* each rank holds its heads, its FFN slice and E / model experts;
* the 2x2 fsdp state saved whole after step 2: its leaves are a single
  process's (names, order, values), it resumes at 1x2 and in one process.

Tolerances: loss, nll, aux, lr and grad_norm within 1e-5 relative;
every parameter and both moments, assembled from the ranks' slices,
within 2e-5 absolute after steps 1 and 3, except a parameter entry in
AdamW's eps regime at step 1 (the reference's |gradient| there under 10
eps). Its step-1 update is lr * g / (|g| + eps), whose slope
lr * eps / (|g| + eps)^2 turns a gradient that is mostly cancellation,
and so differs between two summation orders around zero (1.5e-10
against 1.7e-12 on the two sides), into a move that differs by a part
of lr. At most EPS_ENTRIES such entries of a check may lie beyond 2e-5,
and none beyond EPS_ATOL, half of step 1's move lr / warmup: an update
missing or of the wrong sign there fails. (The runs here put at most 9
entries beyond 2e-5, at most 1.27e-4 of the 2.5e-4, jamba's at 1x2;
the step-1 distances stay as they are after step 3.)

One spawn a world size (4, then 2) runs every case, while the JAX side
runs in the parent and its mesh step in the subprocess. The shared
machinery serves ``tests/test_torch_sharded_training_recurrent.py`` too.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.data.pipeline import DataPipeline as JaxPipeline
from repro.data.pipeline import PipelineConfig as JaxPipelineConfig
from repro.models import common as jcommon
from repro.models.transformer import LM as JaxLM
from repro.optim.optimizer import AdamWConfig as JaxAdamW
from repro.optim.optimizer import adamw_init as jax_adamw_init
from repro.training import train_loop as jtrain
from repro_torch.configs import get_reduced
from repro_torch.interop import lm_from_jax
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.sharded import make_shardwise_train_step, train_rank
from repro_torch.optim.optimizer import AdamWConfig
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.sharded import ShardedTrainStep
from repro_torch.training.train_loop import (
    TrainConfig,
    init_train_state,
    make_train_step,
)
from test_torch_sharded_training import _assemble as assemble
from test_torch_sharded_training import _fill_idx, _named, numpy_tree

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
STEPS = 3
PIPE = dict(seq_len=16, global_batch=4)
SPAWN_TIMEOUT_S = 150
JAX_MESH_TIMEOUT_S = 240
METRIC_RTOL, STATE_ATOL = 1e-5, 2e-5
EPS_REGIME = 10 * AdamWConfig().eps  # |g| at step 1 (module docstring)
EPS_ATOL = OPT["lr"] / OPT["warmup_steps"] / 2  # half of step 1's move
EPS_ENTRIES = 16  # such entries a check may hold beyond STATE_ATOL
METRICS = ("loss", "nll", "aux", "lr", "grad_norm")
ARCH = "deepseek-v2-lite-16b"
CFS = (None, 1.0)  # the config's capacity factor, and 1.0
CF_IDS = ("cf_config", "cf_1.0")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny CPU ops: idle threads
    would spin beside the suite's other workers and the ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# shared machinery (tests/test_torch_sharded_training_recurrent.py too)
# ---------------------------------------------------------------------------


def with_capacity(cfg, cf):
    """``cfg`` (either package's) with every MoE block's capacity factor
    ``cf`` (None: as it is)."""
    if cf is None:
        return cfg

    def fix(blk):
        if hasattr(blk.mlp, "capacity_factor"):
            return dataclasses.replace(blk, mlp=dataclasses.replace(
                blk.mlp, capacity_factor=cf))
        return blk

    return dataclasses.replace(cfg, plan=tuple(
        (tuple(fix(b) for b in e) if isinstance(e, tuple) else fix(e), r)
        for e, r in cfg.plan))


def cfgs(arch, cf=None):
    return (with_capacity(jax_reduced(arch), cf),
            with_capacity(get_reduced(arch), cf))


def port_states(tcfg, params, opt) -> dict:
    """{"params" | "m" | "v": {port name: array}} of a JAX state."""
    p = numpy_tree(params)
    st = {"params": _named(tcfg, p)}
    for part in ("m", "v"):
        t = numpy_tree(opt[part])
        _fill_idx(t, p)
        st[part] = _named(tcfg, t)
    return st


def batches_of(vocab, steps=STEPS):
    pipe = JaxPipeline(JaxPipelineConfig(vocab_size=vocab, **PIPE))
    return [pipe.next() for _ in range(steps)]


def _jax_step(jlm):
    return jtrain.make_train_step(jlm, jtrain.TrainConfig(
        opt=JaxAdamW(**OPT), remat="none"))


def jax_start(arch, cf=None) -> dict:
    """The start of JAX's single-device run: the initial weights (``init``,
    JAX's, ``tree``, numpy), the batches and the port's config at the
    capacity factor ``cf`` (which changes neither weights nor batches)."""
    jcfg, tcfg = cfgs(arch, cf)
    jcommon.set_compute_dtype(jnp.float32)
    try:
        params = jax.jit(JaxLM(jcfg).init)(jax.random.PRNGKey(0))
        return {"init": params, "tree": numpy_tree(params),
                "batches": batches_of(jcfg.vocab_size), "cfg": tcfg}
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)


def jax_single(start, arch, cf=None) -> dict:
    """JAX's single-device steps on the whole batch from ``start``
    (:func:`jax_start`) at the capacity factor ``cf``: ``start`` with each
    step's metrics and the state after it."""
    jcfg, tcfg = cfgs(arch, cf)
    jcommon.set_compute_dtype(jnp.float32)
    try:
        params = start["init"]
        step = jax.jit(_jax_step(JaxLM(jcfg)))
        opt = jax_adamw_init(params)
        metrics, states = [], []
        for b in start["batches"]:
            params, opt, m = step(params, opt,
                                  {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
            states.append(port_states(tcfg, params, opt))
        return dict(start, metrics=metrics, states=states, cfg=tcfg)
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)


def jax_mesh_main(jobs_path: str, out_path: str) -> None:
    """The subprocess's work (its XLA_FLAGS force 8 host devices): each
    job (arch, capacity factor) runs STEPS steps of JAX's
    ``make_train_step`` jitted under an Auto-axis (2, 2) ``data x model``
    mesh, params and moments placed by ``param_pspecs`` (fsdp) in and
    out; writes each job's initial weights, metrics and states (numpy
    trees)."""
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.launch.specs import _named as named_shardings
    from repro.parallel.sharding import batch_pspec, param_pspecs

    with open(jobs_path, "rb") as f:
        jobs = pickle.load(f)
    jcommon.set_compute_dtype(jnp.float32)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out, inits = [], {}  # one init jit an arch: cf leaves the weights
    for arch, cf in jobs:
        jcfg, _ = cfgs(arch, cf)
        jlm = JaxLM(jcfg)
        if arch not in inits:
            inits[arch] = jax.jit(jlm.init)(jax.random.PRNGKey(0))
        params = inits[arch]
        tree = numpy_tree(params)
        opt = jax_adamw_init(params)
        p_sh = named_shardings(mesh, param_pspecs(params, mesh, "fsdp"))
        o_sh = {"step": NamedSharding(mesh, P()),
                "m": named_shardings(mesh, param_pspecs(opt["m"], mesh,
                                                        "fsdp")),
                "v": named_shardings(mesh, param_pspecs(opt["v"], mesh,
                                                        "fsdp"))}
        tok = NamedSharding(mesh, batch_pspec(PIPE["global_batch"], mesh))
        step = jax.jit(_jax_step(jlm), in_shardings=(
            p_sh, o_sh, {"tokens": tok, "labels": tok}),
            out_shardings=(p_sh, o_sh, None))
        metrics, states = [], []
        with compat.set_mesh(mesh):
            params, opt = jax.device_put(params, p_sh), jax.device_put(
                opt, o_sh)
            for b in batches_of(jcfg.vocab_size):
                params, opt, m = step(params, opt, {
                    k: jnp.asarray(v) for k, v in b.items()})
                metrics.append({k: float(v) for k, v in m.items()})
                states.append({"params": numpy_tree(params),
                               "m": numpy_tree(opt["m"]),
                               "v": numpy_tree(opt["v"])})
        out.append({"tree": tree, "metrics": metrics, "states": states})
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


class JaxMesh:
    """JAX's Auto-mesh steps of ``jobs`` [(arch, capacity factor)], run
    in a subprocess started at once; :meth:`results` waits for it."""

    def __init__(self, jobs, tmp):
        self.jobs = list(jobs)
        self.jobs_path = os.path.join(tmp, "jax_mesh_jobs.pkl")
        self.out_path = os.path.join(tmp, "jax_mesh_out.pkl")
        with open(self.jobs_path, "wb") as f:
            pickle.dump(self.jobs, f)
        here = os.path.dirname(os.path.abspath(__file__))
        src = os.path.join(os.path.dirname(here), "src")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   PYTHONPATH=os.pathsep.join(
                       [src, here, os.environ.get("PYTHONPATH", "")]))
        code = ("import sys, test_torch_sharded_training_moe as t; "
                "t.jax_mesh_main(sys.argv[1], sys.argv[2])")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code, self.jobs_path, self.out_path],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    def results(self) -> dict:
        try:
            log, _ = self.proc.communicate(timeout=JAX_MESH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            raise
        assert self.proc.returncode == 0, log.decode()[-4000:]
        with open(self.out_path, "rb") as f:
            raw = pickle.load(f)
        out = {}
        for (arch, cf), r in zip(self.jobs, raw):
            tcfg = cfgs(arch, cf)[1]
            states = []
            for st in r["states"]:
                named = {"params": _named(tcfg, st["params"])}
                for part in ("m", "v"):
                    _fill_idx(st[part], st["params"])
                    named[part] = _named(tcfg, st[part])
                states.append(named)
            out[(arch, cf)] = {"tree": r["tree"], "metrics": r["metrics"],
                               "states": states, "cfg": tcfg}
        return out


def case(ref, mesh, *, mode="fsdp", state=(1, STEPS), **kw):
    """A ``train_rank`` case on the weights and batches of ``ref``."""
    return dict(cfg=ref["cfg"], tree=ref["tree"], compute="f32", mode=mode,
                policy="auto", tcfg=TrainConfig(opt=AdamWConfig(**OPT),
                                                remat="none"),
                batches=ref["batches"], mesh=mesh, state=state, **kw)


def train_rank_then_planted(mesh, cases, planted):
    """``train_rank`` on ``cases``, then on ``planted`` with a planted
    fault: the aux's gradient taken on every model rank (its share not
    zeroed off model rank 0) while the router's gradient is still summed
    over "model", so the aux's part of it is counted tp times (the
    rank's process ends with this call)."""
    out = train_rank(mesh, cases)
    ShardedTrainStep._aux_weight = (
        lambda self, split: 1.0 / self.mesh.data if split else 1.0)
    return out + train_rank(mesh, planted)


def metric_distance(got: list, want: list, first: int = 0) -> float:
    """The largest relative distance of a metric over the steps."""
    assert len(got) == len(want) - first
    return max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
               for g, w in zip(got, want[first:]) for k in METRICS)


def check_metrics(ranks, want: list, first: int = 0) -> None:
    for r in ranks:
        assert len(r["metrics"]) == len(want) - first
        for got, w in zip(r["metrics"], want[first:]):
            for key in METRICS:
                np.testing.assert_allclose(got[key], w[key],
                                           rtol=METRIC_RTOL, atol=1e-7,
                                           err_msg=key)


def state_distance(got: dict, want: dict, v1: dict) -> dict:
    """{part: the largest |difference| beyond what it is held to} (<= 0
    when within): parameters to STATE_ATOL, an entry in AdamW's eps
    regime at step 1 (the reference's sqrt(v-hat) = |g| there, from
    ``v1``, under EPS_REGIME) to EPS_ATOL; both moments to STATE_ATOL;
    "eps_entries": the eps regime's entries beyond STATE_ATOL less
    EPS_ENTRIES."""
    out = {}
    eps_over = 0
    for part in ("params", "m", "v"):
        assert set(got[part]) == set(want[part]), \
            sorted(set(got[part]) ^ set(want[part]))
        worst = -np.inf
        for name, a in got[part].items():
            d = np.abs(a - want[part][name])
            tol = np.full(d.shape, STATE_ATOL)
            if part == "params":
                bc2 = 1 - AdamWConfig().b2
                eps = np.sqrt(v1[name] / bc2) < EPS_REGIME
                tol[eps] = EPS_ATOL
                eps_over += int((d[eps] > STATE_ATOL).sum())
            worst = max(worst, float((d - tol).max()))
        out[part] = worst
    out["eps_entries"] = eps_over - EPS_ENTRIES
    return out


def check_state(ranks, ref, step=STEPS) -> None:
    got = {part: assemble(ranks, part, step) for part in ("params", "m",
                                                          "v")}
    dist = state_distance(got, ref["states"][step - 1],
                          ref["states"][0]["v"])
    assert all(d <= 0 for d in dist.values()), dist


def restore_one_process(ref, ckpt, data: int):
    """The 2x2 checkpoint of step 2 restored into one process's model,
    and its step 3: the shard-wise step over ``data`` shards (the
    whole-batch step at 1). Returns (manifest, metrics, the model)."""
    from repro_torch.models.transformer import LM

    tc = TrainConfig(opt=AdamWConfig(**OPT), remat="none")
    lm = LM.init(ref["cfg"], seed=1, dtype=torch.float32, device="cpu")
    _, opt = init_train_state(lm, tc)
    state, meta = Checkpointer(ckpt).restore({"params": lm, "opt": opt},
                                             step=2)
    step = (make_shardwise_train_step(lm, tc, data) if data > 1
            else make_train_step(lm, tc))
    lm, _, m = step(lm, state["opt"], ref["batches"][2])
    return meta, {k: float(v) for k, v in m.items()}, lm


def check_held(ranks, model: int, names, experts: dict) -> None:
    """Each rank of a ``model``-way split holds a 1 / model slice of each
    tensor of ``names`` (half of that again where fsdp splits it over 2
    data ranks) and, of each MoE module of ``experts`` {name: experts in
    all}, its own E / model experts, by global id."""
    for r in ranks:
        params = r["states"][STEPS]["params"]
        data = r["mesh"][0]
        for name in names:
            arr, region = params[name]
            whole = int(np.prod(region.shape))
            assert arr.size * model in (whole, whole // data), name
        for moe, n in experts.items():
            ids = {int(k[len(moe) + 9:].split(".")[0]) for k in params
                   if k.startswith(f"{moe}.experts.")}
            per = n // model
            first = r["coords"][1] * per
            assert ids == set(range(first, first + per)), (moe, ids)


def check_checkpoint(ref, ckpt, unbroken) -> None:
    """The sharded checkpoint's leaves are a single process's: the same
    paths in the same order, dtypes and weight metadata; restored in one
    process they are the uninterrupted run's step-2 state, bit for
    bit."""
    from repro_torch.models.transformer import LM

    tc = TrainConfig(opt=AdamWConfig(**OPT), remat="none")
    lm = lm_from_jax(ref["cfg"], ref["tree"], device="cpu")
    _, opt = init_train_state(lm, tc)
    single = os.path.join(ckpt, "single")
    Checkpointer(single).save(2, {"params": lm, "opt": opt})
    sharded, _ = Checkpointer(ckpt)._load(2)
    one, _ = Checkpointer(single)._load(2)
    for key in ("leaves", "dtypes"):
        assert sharded[key] == one[key], key
    # the kernel policy is an execution preference (restore ignores it)
    assert {p: {k: v for k, v in w.items() if k != "policy"}
            for p, w in sharded["weights"].items()} == {
        p: {k: v for k, v in w.items() if k != "policy"}
        for p, w in one["weights"].items()}
    got = LM.init(ref["cfg"], seed=1, dtype=torch.float32, device="cpu")
    _, opt = init_train_state(got, tc)
    state, _ = Checkpointer(ckpt).restore({"params": got, "opt": opt},
                                          step=2)
    tensors = {"params": dict(got.named_parameters()),
               "m": state["opt"]["m"], "v": state["opt"]["v"]}
    for part, ts in tensors.items():
        want = assemble(unbroken, part, 2)
        assert set(ts) == set(want)
        for name, t in ts.items():
            np.testing.assert_array_equal(t.detach().numpy(), want[name],
                                          err_msg=f"{part} {name}")


def check_one_process_resume(ref, ckpt, unbroken, data: int) -> None:
    """One process restores the 2x2 checkpoint of step 2 and its step 3
    (shard-wise over ``data`` data shards, an MoE's oracle; the whole
    batch's at 1) equals the uninterrupted 2x2 run's step 3 and state."""
    meta, m, lm = restore_one_process(ref, ckpt, data)
    assert meta["format"] == 3 and meta["step"] == 2
    for key in METRICS:
        np.testing.assert_allclose(m[key], unbroken[0]["metrics"][2][key],
                                   rtol=METRIC_RTOL, atol=1e-7, err_msg=key)
    got = {"params": {n: p.detach().numpy() for n, p in
                      lm.named_parameters()}}
    want = {"params": assemble(unbroken, "params")}
    dist = state_distance(dict(got, m=want["params"], v=want["params"]),
                          dict(want, m=want["params"], v=want["params"]),
                          assemble(unbroken, "v", 1))
    assert dist["params"] <= 0 and dist["eps_entries"] <= 0, dist


def check_1x2_resume(ref, ckpt, ranks) -> None:
    """The 2x2 state of step 2 restored at 1x2: its step 3 (one data
    shard) equals one process's whole-batch step 3 from the same
    checkpoint."""
    _, want, _ = restore_one_process(ref, ckpt, 1)
    for r in ranks:
        assert len(r["metrics"]) == 1
        for key in METRICS:
            np.testing.assert_allclose(r["metrics"][0][key], want[key],
                                       rtol=METRIC_RTOL, atol=1e-7,
                                       err_msg=key)


# ---------------------------------------------------------------------------
# reduced deepseek-v2-lite-16b
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Everything the tests read, made once: JAX's mesh steps at both
    capacity factors start in their subprocess; the world-4 spawn (2x2
    fsdp / tp_only at both capacity factors, 1x4, the planted fault)
    runs while JAX's single-device steps are taken (both capacity
    factors); then the world-2 spawn (1x2, the resume at 1x2 from the
    2x2 checkpoint); then JAX's mesh steps are read and the shard-wise
    single process runs."""
    jmesh = JaxMesh([(ARCH, cf) for cf in CFS],
                    str(tmp_path_factory.mktemp("jax_mesh_moe")))
    start = jax_start(ARCH)
    starts = {cf: dict(start, cfg=cfgs(ARCH, cf)[1]) for cf in CFS}
    ckpt = str(tmp_path_factory.mktemp("sharded_moe_ckpt"))
    four = {}
    for cf in CFS:
        four[("fsdp", cf)] = case(starts[cf], (2, 2), **(
            dict(save=(ckpt, 2), state=(1, 2, STEPS)) if cf is None
            else {}))
        four[("tp_only", cf)] = case(starts[cf], (2, 2), mode="tp_only")
    four["1x4"] = case(start, (1, 4))
    planted = case(start, (2, 2), state=(1,))
    ranks = mesh_mod.start(train_rank_then_planted, 2, 2, backend="gloo",
                           device="cpu", timeout_s=SPAWN_TIMEOUT_S,
                           verbose=False, args=(list(four.values()),
                                                [planted]))
    try:
        single = {cf: jax_single(start, ARCH, cf) for cf in CFS}
    finally:
        got = ranks.join()
    out = {k: [r[i] for r in got]
           for i, k in enumerate(list(four) + ["planted"])}
    two = {"1x2": case(start, (1, 2)),
           "resume": case(start, (1, 2), resume=(ckpt, 2),
                          state=(STEPS,))}
    got = mesh_mod.spawn(train_rank, 1, 2, backend="gloo", device="cpu",
                         timeout_s=SPAWN_TIMEOUT_S, verbose=False,
                         args=(list(two.values()),))
    out.update({k: [r[i] for r in got] for i, k in enumerate(two)})
    mesh = jmesh.results()
    shardwise = {}
    for cf in CFS:
        assert all(np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(mesh[(ARCH, cf)]["tree"]),
            jax.tree.leaves(single[cf]["tree"])))
        shardwise[cf] = _shardwise(single[cf])
    return single, out, mesh, shardwise, ckpt


@pytest.fixture(scope="module")
def refs(world):
    """(JAX's single-device steps by capacity factor,)."""
    return world[:1]


@pytest.fixture(scope="module")
def runs(world):
    """(the ranks' results by case, JAX's mesh steps by (arch, capacity
    factor), the shard-wise single process's by capacity factor, the 2x2
    checkpoint's directory)."""
    return world[1:]


def _shardwise(ref) -> dict:
    """The shard-wise single process over 2 data shards: metrics and the
    state after each step, as the references hold them."""
    tc = TrainConfig(opt=AdamWConfig(**OPT), remat="none")
    lm = lm_from_jax(ref["cfg"], ref["tree"], device="cpu")
    lm, opt = init_train_state(lm, tc)
    step = make_shardwise_train_step(lm, tc, 2)
    metrics, states = [], []
    for b in ref["batches"]:
        lm, opt, m = step(lm, opt, b)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append({"params": {n: p.detach().numpy().copy() for n, p in
                                  lm.named_parameters()},
                       "m": {n: t.numpy().copy() for n, t in
                             opt["m"].items()},
                       "v": {n: t.numpy().copy() for n, t in
                             opt["v"].items()}})
    return {"metrics": metrics, "states": states}


def _mesh_ref(runs_, cf):
    return runs_[1][(ARCH, cf)]


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_one_data_shard_matches_jax_single_device(runs, refs, mesh, steps):
    ranks = runs[0][mesh]
    ref = refs[0][None]
    check_metrics([dict(r, metrics=r["metrics"][:steps]) for r in ranks],
                  ref["metrics"][:steps])
    check_state(ranks, ref, steps)
    for r in ranks:  # one nm_matmul a compressed Linear a forward
        n = r["linears"] * STEPS
        assert r["dispatches"] == {("nm_matmul", "nm_spmm", "cpu"): n}


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("cf", CFS, ids=CF_IDS)
@pytest.mark.parametrize("mode", ["fsdp", "tp_only"])
def test_2x2_matches_jax_auto_mesh_step(runs, mode, cf, steps):
    ranks = runs[0][(mode, cf)]
    ref = _mesh_ref(runs, cf)
    check_metrics([dict(r, metrics=r["metrics"][:steps]) for r in ranks],
                  ref["metrics"][:steps])
    check_state(ranks, ref, steps)
    assert ranks[0]["metrics"][0]["aux"] > 0


@pytest.mark.parametrize("cf", CFS, ids=CF_IDS)
def test_single_device_step_is_no_oracle_at_2x2(runs, refs, cf):
    """JAX's whole-batch step lies beyond the tolerances from the port's
    2x2 run (per-shard aux, and at 1.0 per-shard drops)."""
    ranks = runs[0][("fsdp", cf)]
    single = refs[0][cf]
    assert metric_distance(ranks[0]["metrics"], single["metrics"]) \
        > 10 * METRIC_RTOL
    got = {part: assemble(ranks, part) for part in ("params", "m", "v")}
    dist = state_distance(got, single["states"][-1],
                          single["states"][0]["v"])
    assert max(dist.values()) > 0, dist


def test_planted_router_sum_fails_the_check(runs):
    """The aux's gradient on every model rank with the router summed over
    "model": the state check of step 1 fails (the router's gradient and
    every upstream one carry the aux's part twice), where the unplanted
    run's passes."""
    ref = _mesh_ref(runs, None)
    check_state(runs[0][("fsdp", None)], ref, 1)
    with pytest.raises(AssertionError):
        check_state(runs[0]["planted"], ref, 1)


@pytest.mark.parametrize("cf", CFS, ids=CF_IDS)
def test_shardwise_reference_matches_jax_auto_mesh(runs, cf):
    """The card's 2x2 oracle: one process running each data shard's rows
    on its own equals JAX's mesh step."""
    sw, ref = runs[2][cf], _mesh_ref(runs, cf)
    assert metric_distance(sw["metrics"], ref["metrics"]) <= METRIC_RTOL
    for step in (1, STEPS):
        dist = state_distance(sw["states"][step - 1],
                              ref["states"][step - 1],
                              ref["states"][0]["v"])
        assert all(d <= 0 for d in dist.values()), (step, dist)


def test_ranks_hold_their_heads_and_experts(runs):
    """At 1x4 each rank holds a quarter of the MLA heads' projections and
    of the FFNs (dense and shared) and 2 of the 8 experts of each MoE
    layer; at 2x2 fsdp half of them (and half of that again where fsdp
    splits a tensor over "data")."""
    names = ("layers.0.mixer.wq.vals", "layers.0.mixer.w_uk",
             "layers.0.mlp.w_up.vals", "layers.1.mlp.shared.w_down.vals")
    experts = {"layers.1.mlp": 8, "layers.2.mlp": 8}
    check_held(runs[0]["1x4"], 4, names, experts)
    check_held(runs[0][("fsdp", None)], 2, names, experts)


def test_checkpoint_holds_the_single_process_leaves(runs, refs):
    check_checkpoint(refs[0][None], runs[3], runs[0][("fsdp", None)])


def test_resume_at_1x2_from_the_2x2_checkpoint(runs, refs):
    check_1x2_resume(refs[0][None], runs[3], runs[0]["resume"])


def test_restore_in_one_process_continues_the_2x2_run(runs, refs):
    check_one_process_resume(refs[0][None], runs[3],
                             runs[0][("fsdp", None)], 2)
