"""The port's tensor-parallel serving plan and slicing
(``repro_torch.parallel.sharding``) against the JAX package's
(``repro.parallel.sharding``), on the CPU, without processes:

* ``serve_tp_plan`` of every config both packages have (full and
  reduced) at tp 1, 2, 3, 4 and 8: the same plan, or the same exception
  type with the same first clause of its message;
* the rule map (``serve_param_specs``) equal to ``serve_param_pspecs`` on
  ``jax.eval_shape(lm.init)`` with a fake (2, 4) mesh, as
  ``tests/test_serving_sharded.py`` builds it: reduced yi-9b, the mixed
  2:4 / 1:4 override, int8 (scales on the out axis), kv heads split, and
  an MLA + dense-FFN plan (w_uk / w_uv on heads);
* a row split off an N:M group boundary raises in both;
* the shards of the reduced model concatenated give back the whole
  weights bit for bit, and ``init_sharded`` (a layer at a time) equals
  slicing the whole model.
"""
import copy
import dataclasses

import jax
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.configs.base import SparsityConfig as JaxSparsityConfig
from repro.core.nmweight import NMWeight as JaxNMWeight
from repro.core.sparsity import NMConfig as JaxNMConfig
from repro.models.transformer import LM as JaxLM
from repro.parallel.sharding import serve_param_pspecs
from repro.parallel.sharding import serve_tp_plan as jax_plan
from repro.quant import QNMWeight as JaxQNMWeight
from repro.quant import quantize_tree as jax_quantize_tree
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.configs.base import SparsityConfig
from repro_torch.core.sparsity import NMConfig
from repro_torch.launch.mesh import ServeMesh
from repro_torch.models.transformer import LM
from repro_torch.parallel.sharding import (
    ServeTPPlan,
    init_sharded,
    serve_local_cfg,
    serve_param_specs,
    serve_tp_plan,
    shard_lm_,
)

TPS = (1, 2, 3, 4, 8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny CPU ops: idle threads
    would spin beside the suite's other workers and the ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _outcome(fn, cfg, tp):
    """The plan as a tuple, or (exception type, first clause)."""
    try:
        p = fn(cfg, tp)
    except (NotImplementedError, ValueError) as e:
        return type(e).__name__, str(e).split(":")[0]
    return (p.tp, p.shard_attn, p.shard_kv, p.shard_ffn,
            tuple(sorted(p.reduce_tags)))


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tp_plan_matches_jax(arch, tp, full):
    jcfg = (jax_config if full else jax_reduced)(arch)
    tcfg = (get_config if full else get_reduced)(arch)
    assert _outcome(serve_tp_plan, tcfg, tp) == _outcome(jax_plan, jcfg, tp)


class _FakeMesh:
    axis_names = ("data", "model")

    class devices:  # noqa: D106
        shape = (2, 4)
        size = 8


def _both_cfgs(kind):
    """(JAX config, port config) of a rule-map case."""
    j, t = jax_reduced("yi-9b"), get_reduced("yi-9b")
    if kind == "mixed":
        j = dataclasses.replace(j, sparsity=JaxSparsityConfig(
            nm=JaxNMConfig(2, 4), mode="compressed",
            targets=("ffn", "attn_proj"),
            nm_overrides=(("attn_proj", JaxNMConfig(1, 4)),)))
        t = dataclasses.replace(t, sparsity=SparsityConfig(
            nm=NMConfig(2, 4), mode="compressed",
            targets=("ffn", "attn_proj"),
            nm_overrides=(("attn_proj", NMConfig(1, 4)),)))
    elif kind == "kvsharded":
        j, t = (dataclasses.replace(c, plan=tuple(
            (dataclasses.replace(b, mixer=dataclasses.replace(
                b.mixer, kv_heads=4)), rep) for b, rep in c.plan))
            for c in (j, t))
    elif kind == "mla":
        j, t = jax_reduced("deepseek-v2-236b"), get_reduced(
            "deepseek-v2-236b")
        j = dataclasses.replace(j, plan=((j.plan[0][0], 2),))
        t = dataclasses.replace(t, plan=((t.plan[0][0], 2),))
    return j, t


def _jax_specs(jcfg, plan, quantize):
    """{(layer, name within the layer): spec tail} of the JAX package's
    serve_param_pspecs, and the non-layer entries' specs."""
    lm = JaxLM(jcfg)

    def init():
        p = lm.init(jax.random.PRNGKey(0))
        return jax_quantize_tree(p) if quantize else p

    params = jax.eval_shape(init)
    specs = serve_param_pspecs(params, _FakeMesh, plan)
    leaves = jax.tree_util.tree_flatten_with_path(
        params, is_leaf=lambda x: isinstance(x, (JaxNMWeight,
                                                 JaxQNMWeight)))[0]
    spec_leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, (JaxNMWeight, JaxQNMWeight,
                                                jax.sharding.PartitionSpec)
                                            ))[0]
    by_path = {jax.tree_util.keystr(p): s for p, s in spec_leaves}
    # layer index of (group, position in the period, repeat)
    index, first = {}, 0
    for g, (entry, rep) in enumerate(jcfg.plan):
        size = len(entry) if isinstance(entry, tuple) else 1
        for r in range(rep):
            for j in range(size):
                index[(g, j, r)] = first + r * size + j
        first += rep * size
    out, other = {}, {}
    for path, leaf in leaves:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        spec = by_path[jax.tree_util.keystr(path)]
        if isinstance(leaf, (JaxNMWeight, JaxQNMWeight)):
            parts = {"vals": (leaf.vals, spec.vals), "idx": (leaf.idx,
                                                             spec.idx)}
            if isinstance(leaf, JaxQNMWeight):
                parts["scales"] = (leaf.scales, spec.scales)
        else:
            parts = {None: (leaf, spec)}
        for name, (arr, sp) in parts.items():
            full = tuple(sp) + (None,) * (arr.ndim - len(tuple(sp)))
            within = ".".join(str(k) for k in keys[3:] if k is not None)
            if name:
                within = f"{within}.{name}"
            if keys[0] != "groups":
                other[".".join(map(str, keys)) + (f".{name}" if name
                                                  else "")] = full
                continue
            # a group's leaves are stacked on a leading repeat axis
            for r in range(jcfg.plan[keys[1]][1]):
                out[(index[(keys[1], keys[2], r)], within)] = full[1:]
    return out, other


def _port_specs(tcfg, plan, quantize):
    lm = LM.init(tcfg, seed=0, dtype=torch.float32, device="cpu",
                 quantize=quantize)
    specs = serve_param_specs(lm, plan)
    out, other = {}, {}
    for name, spec in specs.items():
        if name.startswith("layers."):
            _, i, within = name.split(".", 2)
            out[(int(i), within)] = spec
        else:
            other[name] = spec
    return lm, out, other


@pytest.mark.parametrize("kind,quantize", [
    ("yi", None), ("mixed", None), ("yi", "int8"), ("kvsharded", None),
    ("mla", None)], ids=["float24", "mixednm", "int8", "kvsharded",
                         "mla-dense"])
def test_rule_map_matches_serve_param_pspecs(kind, quantize):
    jcfg, tcfg = _both_cfgs(kind)
    jplan, tplan = jax_plan(jcfg, 4), serve_tp_plan(tcfg, 4)
    assert (tplan.shard_attn, tplan.shard_kv, tplan.shard_ffn) == (
        jplan.shard_attn, jplan.shard_kv, jplan.shard_ffn)
    jspecs, _ = _jax_specs(jcfg, jplan, quantize)
    lm, tspecs, tother = _port_specs(tcfg, tplan, quantize)
    assert set(tspecs) == set(jspecs), sorted(set(tspecs) ^ set(jspecs))
    for key, spec in jspecs.items():
        assert tspecs[key] == spec, (key, tspecs[key], spec)
    # the head, embedding and final norm stay whole in both
    assert all(set(s) == {None} for s in tother.values()), tother
    split = {k[1] for k, s in tspecs.items() if "model" in s}
    if kind == "mla":
        assert {"mixer.w_uk", "mixer.w_uv", "mixer.wq_b.vals",
                "mixer.wo.vals"} <= split
        assert tspecs[(0, "mixer.w_uk")] == ("model", None, None)
    if quantize:
        assert tspecs[(0, "mixer.wq.scales")] == ("model",)
        assert tspecs[(0, "mixer.wo.scales")] == (None,)


def test_misaligned_row_split_raises_in_both():
    jcfg, tcfg = jax_reduced("yi-9b"), get_reduced("yi-9b")
    jplan = dataclasses.replace(jax_plan(jcfg, 4), tp=64)
    lm = JaxLM(jcfg)
    params = jax.eval_shape(lambda: lm.init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="group boundaries"):
        serve_param_pspecs(params, _FakeMesh, jplan)
    tplan = dataclasses.replace(serve_tp_plan(tcfg, 4), tp=64)
    tlm = LM.init(tcfg, seed=0, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="group boundaries"):
        serve_param_specs(tlm, tplan)
    with pytest.raises(ValueError, match="group boundaries"):
        shard_lm_(tlm, tplan, _mesh(0, 64))


def _mesh(rank, model, data=1):
    return ServeMesh(data, model, rank, "gloo", torch.device("cpu"))


def _shards(cfg, tp, quantize=None):
    whole = LM.init(cfg, seed=0, dtype=torch.float32, device="cpu",
                    quantize=quantize)
    plan = serve_tp_plan(cfg, tp)
    parts = []
    for r in range(tp):
        lm = copy.deepcopy(whole)
        shard_lm_(lm, plan, _mesh(r, tp))
        parts.append(lm)
    return whole, plan, parts


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind,quantize", [
    ("yi", None), ("yi", "int8"), ("kvsharded", None), ("mla", None)],
    ids=["float24", "int8", "kvsharded", "mla-dense"])
def test_shards_concatenate_to_the_whole_weights(kind, quantize, tp):
    _, cfg = _both_cfgs(kind)
    whole, plan, parts = _shards(cfg, tp, quantize)
    specs = serve_param_specs(whole, plan)
    tensors = dict(whole.named_parameters())
    tensors.update(dict(whole.named_buffers()))
    local = [dict(list(p.named_parameters()) + list(p.named_buffers()))
             for p in parts]
    assert set(specs) == set(tensors)
    n_split = 0
    for name, spec in specs.items():
        if "model" in spec:
            dim = spec.index("model")
            got = torch.cat([lp[name] for lp in local], dim)
            n_split += 1
        else:
            got = local[0][name]
            assert all(torch.equal(lp[name], got) for lp in local), name
        assert got.dtype == tensors[name].dtype
        assert torch.equal(got, tensors[name]), name
    assert n_split > 0
    # the local view: head counts divided as serve_local_cfg says
    lcfg = serve_local_cfg(cfg, plan)
    assert parts[0].cfg == lcfg
    assert parts[0].layers[0].mixer.cfg == lcfg.blocks()[0].mixer
    assert parts[0].tp_plan == plan


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_init_sharded_equals_slicing_the_whole_model(quantize):
    cfg = get_reduced("yi-9b")
    whole, plan, parts = _shards(cfg, 2, quantize)
    for r in range(2):
        lm = init_sharded(cfg, _mesh(r, 2), seed=0, dtype=torch.float32,
                          quantize=quantize)
        a = dict(list(lm.named_parameters()) + list(lm.named_buffers()))
        b = dict(list(parts[r].named_parameters())
                 + list(parts[r].named_buffers()))
        assert set(a) == set(b)
        for name in a:
            assert torch.equal(a[name], b[name]), name
        assert lm.cfg == parts[r].cfg and lm.tp_plan == plan


def test_sharded_model_refuses_a_second_slicing_and_a_wrong_mesh():
    cfg = get_reduced("yi-9b")
    lm = LM.init(cfg, seed=0, dtype=torch.float32, device="cpu")
    plan = serve_tp_plan(cfg, 2)
    with pytest.raises(ValueError, match="model ranks"):
        shard_lm_(lm, plan, _mesh(0, 4))
    shard_lm_(lm, plan, _mesh(0, 2))
    with pytest.raises(ValueError, match="already sharded"):
        shard_lm_(lm, plan, _mesh(0, 2))


def test_a_shard_runs_only_under_its_reduce_tags():
    """A sliced model's row-parallel outputs are partial sums: outside
    ``tp_serving`` with its plan's tags the forward raises; a plan that
    splits nothing (tp 1) runs anywhere."""
    from repro_torch.models.cache import CacheView
    from repro_torch.parallel.hints import tp_serving

    cfg = get_reduced("yi-9b")
    lm = LM.init(cfg, seed=0, dtype=torch.float32, device="cpu")
    plan = serve_tp_plan(cfg, 2)
    mesh = _mesh(0, 2)
    shard_lm_(lm, plan, mesh)
    toks = torch.zeros((1, 4), dtype=torch.long)
    with torch.inference_mode():
        with pytest.raises(RuntimeError, match="partial sums"):
            lm(toks, view=CacheView.train())
        with tp_serving(mesh, {"attn_out"}), pytest.raises(RuntimeError):
            lm(toks, view=CacheView.train())
    one = LM.init(cfg, seed=0, dtype=torch.float32, device="cpu")
    shard_lm_(one, serve_tp_plan(cfg, 1), _mesh(0, 1))
    with torch.inference_mode():
        one(toks, view=CacheView.train())


def test_serve_mesh_coordinates_are_row_major():
    got = [ServeMesh(2, 4, r, "gloo", torch.device("cpu")).coords
           for r in range(8)]
    assert got == [(r // 4, r % 4) for r in range(8)]
    m = ServeMesh(2, 4, 6, "gloo", torch.device("cpu"))
    assert (m.axis_size("data"), m.axis_size("model"), m.world) == (2, 4, 8)
    assert (m.axis_index("data"), m.axis_index("model")) == (1, 2)
    with pytest.raises(KeyError):
        m.axis_size("pod")
    assert ServeTPPlan(2, True, False, True).reduce_tags == frozenset(
        {"attn_out", "ffn_down"})


def test_spawned_mesh_groups_sum_over_their_axes():
    """Four gloo ranks on the CPU at 2x2: each rank's coordinates are
    row-major and each axis's sum of (rank + 1) runs over its group."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.sharded import ping

    got = mesh_mod.spawn(ping, 2, 2, backend="gloo", device="cpu",
                         timeout_s=120, verbose=False)
    assert [g["coords"] for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [g["data"] for g in got] == [4.0, 6.0, 4.0, 6.0]  # 1+3, 2+4
    assert [g["model"] for g in got] == [3.0, 3.0, 7.0, 7.0]  # 1+2, 3+4
    assert all(g["world"] == 10.0 for g in got)
