"""The port's sharded train step (``repro_torch.training.sharded``) on the
recurrent configs: reduced rwkv6-3b (RWKV-6 time and channel mix) and
reduced jamba-v0.1-52b (one period: Mamba, GQA, MoE and FFN blocks), on
gloo ranks on the CPU, from the JAX package's weights and
``DataPipeline`` batches, f32 compute, 3 steps, with the machinery and
tolerances of ``tests/test_torch_sharded_training_moe.py``:

* rwkv at 1x2, 1x4, 2x2 fsdp and 2x2 tp_only against JAX's
  single-device ``make_train_step`` on the whole batch (no MoE: the
  mesh changes nothing of the function);
* jamba at 1x2 and 1x4 against the same, and at 2x2 fsdp and tp_only,
  at the config's capacity factor and at 1.0, against JAX's step under
  an Auto-axis (2, 2) mesh (subprocess); its shard-wise single process
  against that too;
* each rank holds its slice of RWKV's heads and channel mix, of Mamba's
  ``d_inner`` (``w_in`` as its x and z slices) and its experts;
* each config's 2x2 fsdp state saved whole after step 2 holds a single
  process's leaves and resumes at 1x2 and in one process;
* the training plan (``train_tp_plan``) of every config, full and
  reduced, at tp 1, 2 and 4, and its slicing: the ranks' pieces give
  back the whole model bit for bit, and ``init_sharded`` (a layer at a
  time, the MoE made with a rank's experts only) equals slicing the
  whole model.

One spawn a world size (4, then 2) runs every case.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.configs.base import MambaConfig, MoEConfig, RWKVConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import ServeMesh
from repro_torch.launch.sharded import train_rank
from repro_torch.models.transformer import LM
from repro_torch.parallel.sharding import (
    ServeTPPlan,
    init_sharded,
    serve_tp_plan,
    shard_lm_,
    train_tp_plan,
)
from repro_torch.training.sharded import train_layout
from test_torch_sharded_training_moe import (
    CF_IDS,
    CFS,
    SPAWN_TIMEOUT_S,
    STEPS,
    JaxMesh,
    _shardwise,
    case,
    cfgs,
    check_1x2_resume,
    check_checkpoint,
    check_held,
    check_metrics,
    check_one_process_resume,
    check_state,
    jax_single,
    jax_start,
    metric_distance,
    state_distance,
)

RWKV, JAMBA = "rwkv6-3b", "jamba-v0.1-52b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny CPU ops: idle threads
    would spin beside the suite's other workers and the ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Everything the tests read, made once: jamba's Auto-mesh steps at
    both capacity factors start in their subprocess; the world-4 spawn
    runs while JAX's single-device steps of both configs are taken
    (jamba's at its config's capacity: its 2x2 cases at 1.0 take the
    same weights and batches, which the capacity factor changes
    neither); then the world-2 spawn; then JAX's mesh steps are read and
    jamba's shard-wise single process runs."""
    jmesh = JaxMesh([(JAMBA, cf) for cf in CFS],
                    str(tmp_path_factory.mktemp("jax_mesh_recurrent")))
    rwkv, jamba = jax_start(RWKV), jax_start(JAMBA)
    ckpt = {a: str(tmp_path_factory.mktemp(f"sharded_{a}_ckpt"))
            for a in (RWKV, JAMBA)}
    four = {(RWKV, "fsdp"): case(rwkv, (2, 2), save=(ckpt[RWKV], 2),
                                 state=(1, 2, STEPS)),
            (RWKV, "tp_only"): case(rwkv, (2, 2), mode="tp_only"),
            (RWKV, "1x4"): case(rwkv, (1, 4)),
            (JAMBA, "1x4"): case(jamba, (1, 4))}
    for cf in CFS:
        at = dict(jamba, cfg=cfgs(JAMBA, cf)[1])
        extra = (dict(save=(ckpt[JAMBA], 2), state=(1, 2, STEPS))
                 if cf is None else {})
        four[(JAMBA, "fsdp", cf)] = case(at, (2, 2), **extra)
        four[(JAMBA, "tp_only", cf)] = case(at, (2, 2), mode="tp_only")
    ranks = mesh_mod.start(train_rank, 2, 2, backend="gloo", device="cpu",
                           timeout_s=SPAWN_TIMEOUT_S, verbose=False,
                           args=(list(four.values()),))
    try:
        single = {RWKV: jax_single(rwkv, RWKV),
                  (JAMBA, None): jax_single(jamba, JAMBA)}
    finally:
        got = ranks.join()
    out = {k: [r[i] for r in got] for i, k in enumerate(four)}
    two = {(RWKV, "1x2"): case(rwkv, (1, 2)),
           (RWKV, "resume"): case(rwkv, (1, 2), resume=(ckpt[RWKV], 2),
                                  state=(STEPS,)),
           (JAMBA, "1x2"): case(jamba, (1, 2)),
           (JAMBA, "resume"): case(jamba, (1, 2), resume=(ckpt[JAMBA], 2),
                                   state=(STEPS,))}
    got = mesh_mod.spawn(train_rank, 1, 2, backend="gloo", device="cpu",
                         timeout_s=SPAWN_TIMEOUT_S, verbose=False,
                         args=(list(two.values()),))
    out.update({k: [r[i] for r in got] for i, k in enumerate(two)})
    mesh = jmesh.results()
    return single, out, mesh, _shardwise(jamba), ckpt


@pytest.fixture(scope="module")
def refs(world):
    """(JAX's single-device steps: rwkv's, jamba's at its capacity,)."""
    return world[:1]


@pytest.fixture(scope="module")
def runs(world):
    """(the ranks' results by case, jamba's mesh steps by (arch,
    capacity factor), its shard-wise single process's, the 2x2
    checkpoints' directories by arch)."""
    return world[1:]


# ---------------------------------------------------------------------------
# rwkv6-3b
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("key", ["1x2", "1x4", "fsdp", "tp_only"])
def test_rwkv_matches_jax_single_device(runs, refs, key, steps):
    ranks = runs[0][(RWKV, key)]
    ref = refs[0][RWKV]
    check_metrics([dict(r, metrics=r["metrics"][:steps]) for r in ranks],
                  ref["metrics"][:steps])
    check_state(ranks, ref, steps)
    for r in ranks:  # one nm_matmul a compressed Linear a forward
        assert r["dispatches"] == {("nm_matmul", "nm_spmm", "cpu"):
                                   r["linears"] * STEPS}


# ---------------------------------------------------------------------------
# jamba-v0.1-52b
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("key", ["1x2", "1x4"])
def test_jamba_one_data_shard_matches_jax_single_device(runs, refs, key,
                                                        steps):
    ranks = runs[0][(JAMBA, key)]
    ref = refs[0][(JAMBA, None)]
    check_metrics([dict(r, metrics=r["metrics"][:steps]) for r in ranks],
                  ref["metrics"][:steps])
    check_state(ranks, ref, steps)


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("cf", CFS, ids=CF_IDS)
@pytest.mark.parametrize("mode", ["fsdp", "tp_only"])
def test_jamba_2x2_matches_jax_auto_mesh_step(runs, mode, cf, steps):
    ranks = runs[0][(JAMBA, mode, cf)]
    ref = runs[1][(JAMBA, cf)]
    check_metrics([dict(r, metrics=r["metrics"][:steps]) for r in ranks],
                  ref["metrics"][:steps])
    check_state(ranks, ref, steps)


def test_jamba_single_device_step_is_no_oracle_at_2x2(runs, refs):
    ranks = runs[0][(JAMBA, "fsdp", None)]
    assert metric_distance(ranks[0]["metrics"],
                           refs[0][(JAMBA, None)]["metrics"]) > 1e-4


def test_jamba_shardwise_reference_matches_jax_auto_mesh(runs):
    sw, ref = runs[2], runs[1][(JAMBA, None)]
    assert metric_distance(sw["metrics"], ref["metrics"]) <= 1e-5
    for step in (1, STEPS):
        dist = state_distance(sw["states"][step - 1],
                              ref["states"][step - 1],
                              ref["states"][0]["v"])
        assert all(d <= 0 for d in dist.values()), (step, dist)


# ---------------------------------------------------------------------------
# what a rank holds; the checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,key,model", [
    (RWKV, "1x4", 4), (RWKV, "fsdp", 2), (JAMBA, "1x4", 4),
    (JAMBA, ("fsdp", None), 2)], ids=["rwkv-1x4", "rwkv-2x2", "jamba-1x4",
                                      "jamba-2x2"])
def test_ranks_hold_their_slices_and_experts(runs, arch, key, model):
    """RWKV: the rank's heads (r / k / v / g columns, bonus, decay) and its
    channel-mix slice; jamba: its slice of Mamba's d_inner (w_in, w_x,
    conv, a_log), of the FFN and its E / model experts."""
    key = (arch,) + (key if isinstance(key, tuple) else (key,))
    if arch == RWKV:
        names = ("layers.0.mixer.w_r.vals", "layers.0.mixer.bonus",
                 "layers.0.mixer.decay_lora_b", "layers.0.mixer.w_o.vals",
                 "layers.0.mixer.w_cm_k.vals")
        experts = {}
    else:
        names = ("layers.0.mixer.w_in.vals", "layers.0.mixer.w_x.vals",
                 "layers.0.mixer.conv_w", "layers.0.mixer.a_log",
                 "layers.0.mlp.w_up.vals")
        experts = {"layers.1.mlp": 4, "layers.3.mlp": 4}
    check_held(runs[0][key], model, names, experts)


def test_mamba_w_in_holds_the_x_and_z_slices(runs, refs):
    """A rank's w_in is its slice of the x half beside its slice of the
    z half: the regions it fills are two blocks."""
    for r in runs[0][(JAMBA, "1x4")]:
        arr, region = r["states"][STEPS]["params"]["layers.0.mixer.w_in.vals"]
        cols = np.asarray(region.index[1])
        half, width = region.shape[1] // 2, arr.shape[1] // 2
        m = r["coords"][1]
        np.testing.assert_array_equal(
            cols, np.r_[m * width:(m + 1) * width,
                        half + m * width:half + (m + 1) * width])


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_checkpoint_holds_the_single_process_leaves(runs, refs, arch):
    ref = refs[0][RWKV] if arch == RWKV else refs[0][(JAMBA, None)]
    unbroken = runs[0][(RWKV, "fsdp") if arch == RWKV
                       else (JAMBA, "fsdp", None)]
    check_checkpoint(ref, runs[3][arch], unbroken)


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_resume_at_1x2_from_the_2x2_checkpoint(runs, refs, arch):
    ref = refs[0][RWKV] if arch == RWKV else refs[0][(JAMBA, None)]
    check_1x2_resume(ref, runs[3][arch], runs[0][(arch, "resume")])
    if arch == RWKV:  # no MoE: the 1x2 step 3 is the uninterrupted run's
        check_metrics(runs[0][(arch, "resume")], ref["metrics"], first=2)


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_restore_in_one_process_continues_the_2x2_run(runs, refs, arch):
    ref = refs[0][RWKV] if arch == RWKV else refs[0][(JAMBA, None)]
    unbroken = runs[0][(RWKV, "fsdp") if arch == RWKV
                       else (JAMBA, "fsdp", None)]
    check_one_process_resume(ref, runs[3][arch], unbroken, 2)


# ---------------------------------------------------------------------------
# the training plan and its slicing (no processes)
# ---------------------------------------------------------------------------


def _outcome(fn, cfg, tp):
    try:
        p = fn(cfg, tp)
    except (NotImplementedError, ValueError) as e:
        return type(e).__name__, str(e).split(":")[0]
    return p


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_tp_plan(arch, tp, full):
    """Attention and dense FFNs split as the serving plan splits them
    (the port's, equal to JAX's); an MoE goes expert-parallel wherever
    its experts divide (at tp 1 too); Mamba's d_inner and RWKV's heads
    where they divide; an encoder-decoder's encoder, decoder and cross
    blocks as attention and FFNs, with "enc_out" where the KV heads
    split."""
    cfg = (get_config if full else get_reduced)(arch)
    plan = _outcome(train_tp_plan, cfg, tp)
    blocks = cfg.blocks()
    if any(b.cross_attn for b in blocks):
        assert isinstance(plan, ServeTPPlan), plan
        split = tp > 1  # whisper's heads and FFN width divide at 2 and 4
        assert (plan.tp, plan.shard_attn, plan.shard_kv, plan.shard_ffn,
                plan.shard_ssm, plan.shard_moe) == (tp, split, split, split,
                                                    False, False)
        assert plan.train_tags == ({"attn_in", "attn_out", "kv_in",
                                    "enc_out", "ffn_in", "ffn_down"}
                                   if split else set())
        return
    if cfg.encoder_plan is None and all(
            not isinstance(b.mixer, (MambaConfig, RWKVConfig))
            and not isinstance(b.mlp, MoEConfig) for b in blocks):
        serve = _outcome(serve_tp_plan, cfg, tp)
        if isinstance(serve, tuple):  # blocks that disagree: both raise
            assert plan == serve
        else:
            assert (plan.tp, plan.shard_attn, plan.shard_kv,
                    plan.shard_ffn) == (serve.tp, serve.shard_attn,
                                        serve.shard_kv, serve.shard_ffn)
            assert not (plan.shard_ssm or plan.shard_moe)
            assert plan.train_tags == serve.train_tags
        return
    assert isinstance(plan, ServeTPPlan), plan
    moes = [b.mlp for b in blocks if isinstance(b.mlp, MoEConfig)]
    assert plan.shard_moe == bool(moes)
    assert all(m.n_experts % tp == 0 for m in moes)
    for b in blocks:
        if isinstance(b.mixer, MambaConfig):
            assert plan.shard_ssm == (
                tp > 1 and b.mixer.expand * cfg.d_model % tp == 0)
        if isinstance(b.mixer, RWKVConfig):
            assert plan.shard_attn == (
                tp > 1 and cfg.d_model // b.mixer.head_dim % tp == 0)
    assert ("moe_out" in plan.reduce_tags) == plan.shard_moe
    assert ({"ssm_x", "ssm_out"} <= plan.reduce_tags) == plan.shard_ssm


def _whole(parts, tp) -> dict:
    """The whole state dict from ``tp`` ranks' shards (their layouts'
    regions and global names)."""
    out = {}
    for r, lm in enumerate(parts):
        layout = lm.train_layout
        for name, t in lm.state_dict().items():
            region = layout.region(name, tuple(t.shape))
            g = layout.global_name(name)
            if g not in out:
                out[g] = torch.zeros(region.shape, dtype=t.dtype)
            out[g][tuple(torch.as_tensor(i) if isinstance(i, np.ndarray)
                         else i for i in region.index)] = t
    return out


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", RWKV, JAMBA])
def test_train_plan_shards_give_back_the_whole_model(arch, tp):
    """The ranks' shards under the training plan, placed by their
    layouts' regions and global expert names, are the whole model bit for
    bit; ``init_sharded`` (a layer at a time, an MoE made with the rank's
    experts only) equals slicing the whole model."""
    cfg = get_reduced(arch)
    plan = train_tp_plan(cfg, tp)
    whole = LM.init(cfg, seed=0, dtype=torch.float32, device="cpu")
    parts = []
    for r in range(tp):
        mesh = ServeMesh(1, tp, r, "gloo", torch.device("cpu"))
        lm = copy.deepcopy(whole)
        shard_lm_(lm, plan, mesh)
        lm.train_layout = train_layout(lm, mesh, "tp_only")
        made = init_sharded(cfg, mesh, plan=plan, seed=0,
                            dtype=torch.float32)
        assert made.tp_split == lm.tp_split
        assert made.tp_blocks == lm.tp_blocks
        mine, theirs = made.state_dict(), lm.state_dict()
        assert list(mine) == list(theirs)
        for name, t in mine.items():
            assert torch.equal(t, theirs[name]), name
        parts.append(lm)
    got = _whole(parts, tp)
    want = whole.state_dict()
    assert set(got) == set(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
