"""The port's sharded train step (``repro_torch.training.sharded``) on the
encoder-decoder: reduced whisper-medium (2 encoder + 2 decoder layers,
d_model 64, 4 / 4 heads, 24 frames; every decoder block cross-attends to
the encoder's output), on gloo ranks on the CPU, from the JAX package's
weights (``repro_torch.interop``) and ``DataPipeline`` batches with
random frames (``enc_input``, numpy from a seed), f32 compute, 3 steps,
with the machinery of ``tests/test_torch_sharded_training_moe.py``:

* at 2x1, 1x2 and 2x2 fsdp against JAX's single-device
  ``make_train_step`` on the whole batch (no MoE: the mesh changes
  nothing of the function): loss, nll, aux, lr and grad_norm within 1e-5
  relative after every step, every parameter and both moments (the
  encoder's, the cross blocks' and ``enc_pos`` too), assembled from the
  ranks' slices, within 2e-5 absolute after steps 1 and 3: the f32
  tolerances of ``tests/test_torch_training.py``, but for a parameter
  entry in AdamW's eps regime at step 1, held as the moe file holds it
  (at most 16 entries a check beyond 2e-5, none beyond 2.5e-4: a
  gradient under 10 eps is mostly cancellation, and its last bits
  differ between two summation orders; here one entry of the encoder's
  ``w_down``, 3.3e-5 at 2x1). The 2x1 and 2x2 runs split the frames'
  rows over "data" with the tokens';
* each rank holds its slice of the encoder's heads and FFN and of the
  cross-attention's heads; fsdp splits ``enc_pos`` over "data";
* the 2x2 state saved whole after step 2 holds a single process's
  leaves, resumes at 1x2 and in one process;
* ``init_sharded`` (the encoder's layers a layer at a time too) equals
  slicing the whole model under the training plan (whisper's plan:
  ``tests/test_torch_sharded_training_recurrent.py::test_train_tp_plan``),
  and the ranks' pieces give it back bit for bit.

One spawn a world size (4, then 2) runs every case, the world-4 one
while JAX's steps run in the parent.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import ServeMesh
from repro_torch.launch.sharded import train_rank, with_frames
from repro_torch.models.transformer import LM
from repro_torch.parallel.sharding import (
    init_sharded,
    shard_lm_,
    train_tp_plan,
)
from repro_torch.training.sharded import train_layout
from test_torch_sharded_training_recurrent import _whole
from test_torch_sharded_training_moe import (
    SPAWN_TIMEOUT_S,
    STEPS,
    case,
    check_1x2_resume,
    check_checkpoint,
    check_held,
    check_metrics,
    check_one_process_resume,
    check_state,
    jax_single,
    jax_start,
)

WHISPER = "whisper-medium"
FRAMES_SEED = 0
MESHES = {(2, 1): "2x1", (1, 2): "1x2", (2, 2): "2x2"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny CPU ops: idle threads
    would spin beside the suite's other workers and the ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def framed(start: dict) -> dict:
    """``start`` (``jax_start``) with random frames (B, encoder_seq,
    d_model) from FRAMES_SEED in every batch (``launch.sharded.
    with_frames``, as chip_smoke's phase 36 makes them)."""
    return dict(start, batches=with_frames(start["batches"], start["cfg"],
                                           FRAMES_SEED))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Everything the tests read, made once: the world-4 spawn (2x2 fsdp,
    saved after step 2) runs while JAX's single-device steps are taken;
    then the world-2 spawn (2x1, 1x2, the resume at 1x2 from the 2x2
    checkpoint)."""
    start = framed(jax_start(WHISPER))
    ckpt = str(tmp_path_factory.mktemp("sharded_whisper_ckpt"))
    four = {(2, 2): case(start, (2, 2), save=(ckpt, 2),
                         state=(1, 2, STEPS))}
    ranks = mesh_mod.start(train_rank, 2, 2, backend="gloo", device="cpu",
                           timeout_s=SPAWN_TIMEOUT_S, verbose=False,
                           args=(list(four.values()),))
    try:
        ref = jax_single(start, WHISPER)
    finally:
        got = ranks.join()
    out = {k: [r[i] for r in got] for i, k in enumerate(four)}
    two = {(2, 1): case(start, (2, 1)), (1, 2): case(start, (1, 2)),
           "resume": case(start, (1, 2), resume=(ckpt, 2), state=(STEPS,))}
    got = mesh_mod.spawn(train_rank, 1, 2, backend="gloo", device="cpu",
                         timeout_s=SPAWN_TIMEOUT_S, verbose=False,
                         args=(list(two.values()),))
    out.update({k: [r[i] for r in got] for i, k in enumerate(two)})
    return ref, out, ckpt


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES.values()))
def test_sharded_steps_match_jax_whole_batch_step(world, mesh, steps):
    ref, runs, _ = world
    ranks = runs[mesh]
    check_metrics([dict(r, metrics=r["metrics"][:steps]) for r in ranks],
                  ref["metrics"][:steps])
    check_state(ranks, ref, steps)
    for r in ranks:  # one nm_matmul a compressed Linear a forward: 2 x 6
        # in the encoder, 2 x 10 in the decoder (self, cross, FFN)
        assert r["linears"] == 32
        assert r["dispatches"] == {("nm_matmul", "nm_spmm", "cpu"):
                                   r["linears"] * STEPS}


def test_ranks_hold_their_encoder_and_cross_slices(world):
    """At 1x2 each rank holds half of the encoder's and the cross
    blocks' head projections and of the FFNs (half of that again where
    fsdp splits a tensor over 2 data ranks at 2x2); fsdp splits the
    encoder's position table over "data"."""
    _, runs, _ = world
    names = ("enc_layers.0.mixer.wq.vals", "enc_layers.1.mixer.wo.vals",
             "enc_layers.0.mlp.w_up.vals", "enc_layers.1.mlp.w_down.vals",
             "layers.0.cross.wq.vals", "layers.0.cross.wk.vals",
             "layers.1.cross.wv.vals", "layers.1.cross.wo.vals")
    check_held(runs[(1, 2)], 2, names, {})
    check_held(runs[(2, 2)], 2, names, {})
    for r in runs[(2, 2)]:
        arr, region = r["states"][STEPS]["params"]["enc_pos.table"]
        assert arr.size * 2 == int(np.prod(region.shape))


def test_checkpoint_holds_the_single_process_leaves(world):
    ref, runs, ckpt = world
    check_checkpoint(ref, ckpt, runs[(2, 2)])


def test_resume_at_1x2_from_the_2x2_checkpoint(world):
    """The 2x2 state of step 2 restored at 1x2: its step 3 equals one
    process's from the same checkpoint, JAX's step 3 and the
    uninterrupted run's state."""
    ref, runs, ckpt = world
    ranks = runs["resume"]
    check_1x2_resume(ref, ckpt, ranks)
    check_metrics(ranks, ref["metrics"], first=2)
    check_state(ranks, ref)


def test_restore_in_one_process_continues_the_2x2_run(world):
    ref, runs, ckpt = world
    check_one_process_resume(ref, ckpt, runs[(2, 2)], 1)


# ---------------------------------------------------------------------------
# the plan and the slicing (no processes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_init_sharded_equals_slicing_the_whole_model(tp):
    """Each rank's ``init_sharded`` (decoder and encoder layers made and
    sliced one at a time) equals ``shard_lm_`` of the whole model, the
    encoder included, with the local head counts in every attention
    module; the ranks' pieces give back the whole model bit for bit."""
    cfg = get_reduced(WHISPER)
    plan = train_tp_plan(cfg, tp)
    whole = LM.init(cfg, seed=0, dtype=torch.float32, device="cpu")
    parts = []
    for r in range(tp):
        mesh = ServeMesh(1, tp, r, "gloo", torch.device("cpu"))
        lm = copy.deepcopy(whole)
        shard_lm_(lm, plan, mesh)
        made = init_sharded(cfg, mesh, plan=plan, seed=0,
                            dtype=torch.float32)
        assert made.tp_split == lm.tp_split
        assert any(k.startswith("enc_layers.1.") for k in lm.tp_split)
        assert "layers.0.cross.wo.vals" in lm.tp_split
        for m in (made, lm):
            heads = {mod.cfg.q_heads for layer in list(m.layers)
                     + list(m.enc_layers)
                     for mod in (layer.mixer, layer.cross) if mod}
            assert heads == {4 // tp}
            assert m.cfg.encoder_blocks()[0].mixer.kv_heads == 4 // tp
        mine, theirs = made.state_dict(), lm.state_dict()
        assert list(mine) == list(theirs)
        for name, t in mine.items():
            assert torch.equal(t, theirs[name]), name
        lm.train_layout = train_layout(lm, mesh, "tp_only")
        parts.append(lm)
    got = _whole(parts, tp)
    want = whole.state_dict()
    assert set(got) == set(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
