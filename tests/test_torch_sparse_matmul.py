"""The paper-facing layer of the PyTorch port (Algorithms 1-3, the
traffic accounting and the vector-core cost model) against the JAX
package's, on the CPU.

Algorithms 1-3 take the same inputs in both packages and agree at the
JAX tests' tolerance (rtol 1e-5, atol 1e-4: f32 sums in another order).
The traffic reports and the model's cycle counts are plain Python
arithmetic in both, so they must be equal. The paper's Fig. 4/5/6 bands
(tests/test_paper_repro.py) are checked on the port's model and the
port's GEMM tables.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.cnn_specs import inceptionv3_gemms
from repro import api as japi
from repro.core import cost_model as jcost
from repro.core import sparse_matmul as jsm
from repro_torch.configs import get_cnn_config
from repro_torch.core import cost_model as tcost
from repro_torch.core import sparse_matmul as tsm
from repro_torch.core.sparsity import NMConfig
from repro_torch.models.conv import cnn_layer_gemms

F32 = dict(rtol=1e-5, atol=1e-4)
PATTERNS = [(1, 4), (2, 4), (1, 2)]


def _operands(rows, k, nc, nm, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((rows, k)).astype(np.float32)
    jw = japi.sparsify(jnp.asarray(a), japi.NMConfig(*nm), axis=1)
    b = rng.standard_normal((k, nc)).astype(np.float32)
    dense = np.array(japi.densify(jw))
    return jw, dense, b


@pytest.mark.parametrize("nm", PATTERNS, ids=lambda p: "%d:%d" % p)
@pytest.mark.parametrize("l_rows", [16, 32])
def test_algorithms_agree_with_jax(nm, l_rows):
    jw, dense, b = _operands(24, 128, 96, nm, seed=0)
    cfg = NMConfig(*nm)
    tv, ti = torch.from_numpy(np.array(jw.vals)), torch.from_numpy(
        np.array(jw.idx))
    tb, td = torch.from_numpy(b), torch.from_numpy(dense)
    jb = jnp.asarray(b)
    c1 = tsm.rowwise_dense_matmul(td, tb).numpy()
    c2 = tsm.rowwise_spmm(tv, ti, tb, cfg).numpy()
    c3 = tsm.indexmac_spmm(tv, ti, tb, cfg, l_rows=l_rows).numpy()
    j1 = np.asarray(jsm.rowwise_dense_matmul(jnp.asarray(dense), jb))
    j2 = np.asarray(jsm.rowwise_spmm(jw.vals, jw.idx, jb, jw.nm))
    j3 = np.asarray(jsm.indexmac_spmm(jw.vals, jw.idx, jb, jw.nm,
                                      l_rows=l_rows))
    for got, want in ((c1, j1), (c2, j2), (c3, j3), (c2, c1), (c3, c1)):
        np.testing.assert_allclose(got, want, **F32)


def test_indexmac_spmm_rejects_what_jax_rejects():
    cfg = NMConfig(2, 4)
    v = torch.zeros(2, 16)
    i = torch.zeros(2, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of M"):
        tsm.indexmac_spmm(v, i, torch.zeros(32, 4), cfg, l_rows=10)
    with pytest.raises(ValueError, match="not divisible"):
        tsm.indexmac_spmm(v, i, torch.zeros(32, 4), cfg, l_rows=24)


def _all_layers():
    return [g for cnn in ("resnet50", "densenet121")
            for g in cnn_layer_gemms(get_cnn_config(cnn))]


@pytest.mark.parametrize("nm", PATTERNS, ids=lambda p: "%d:%d" % p)
def test_traffic_and_cycles_equal_jax(nm):
    """Every ResNet-50 and DenseNet-121 layer: the same traffic reports
    and cycle counts as the JAX package's model, to the last bit."""
    tc, jc = NMConfig(*nm), japi.NMConfig(*nm)
    tm, jm = tcost.VectorCoreModel(), jcost.VectorCoreModel()
    for _, m, k, n in _all_layers():
        k = -(-k // tc.m) * tc.m
        for tf, jf in ((tsm.rowwise_spmm_traffic, jsm.rowwise_spmm_traffic),
                       (tsm.indexmac_traffic, jsm.indexmac_traffic)):
            t, j = tf(m, k, n, tc), jf(m, k, n, jc)
            assert (t.loads_a, t.loads_b, t.loads_c, t.stores_c, t.total) \
                == (j.loads_a, j.loads_b, j.loads_c, j.stores_c, j.total)
        assert tm.cycles_rowwise(m, k, n, tc) == jm.cycles_rowwise(m, k, n, jc)
        assert tm.cycles_indexmac(m, k, n, tc) == \
            jm.cycles_indexmac(m, k, n, jc)
        assert tm.speedup(m, k, n, tc) == jm.speedup(m, k, n, jc)
        assert tm.memory_reduction(m, k, n, tc) == \
            jm.memory_reduction(m, k, n, jc)
    assert (tcost.VLEN, tcost.L_ROWS) == (jcost.VLEN, jcost.L_ROWS)
    assert tcost.conv_gemm_dims(64, 64, 3, 3, 56, 56) == \
        jcost.conv_gemm_dims(64, 64, 3, 3, 56, 56) == (64, 576, 3136)


def _cnn_tables():
    return {"resnet50": cnn_layer_gemms(get_cnn_config("resnet50")),
            "densenet121": cnn_layer_gemms(get_cnn_config("densenet121")),
            "inceptionv3": inceptionv3_gemms()}


def test_fig5_total_speedups_in_band():
    """Paper Fig. 5 (avg 1.95x at 1:4, 1.88x at 2:4) on the port's model;
    InceptionV3 has no config in either package, so its published layer
    table is taken as data."""
    model = tcost.VectorCoreModel()
    res = {}
    for cnn, layers in _cnn_tables().items():
        for tag, cfg in (("1:4", NMConfig(1, 4)), ("2:4", NMConfig(2, 4))):
            base = sum(model.cycles_rowwise(m, k, n, cfg)
                       for _, m, k, n in layers)
            prop = sum(model.cycles_indexmac(m, k, n, cfg)
                       for _, m, k, n in layers)
            res[(cnn, tag)] = base / prop
            assert 1.6 < res[(cnn, tag)] < 2.2, (cnn, tag, res[(cnn, tag)])
    combined = np.mean(list(res.values()))
    assert abs(combined - 1.915) / 1.915 < 0.05, res


def test_fig6_memory_reduction_in_band():
    res = {}
    for cnn, layers in _cnn_tables().items():
        for tag, cfg in (("1:4", NMConfig(1, 4)), ("2:4", NMConfig(2, 4))):
            base = sum(tsm.rowwise_spmm_traffic(m, k, n, cfg).total
                       for _, m, k, n in layers)
            prop = sum(tsm.indexmac_traffic(m, k, n, cfg).total
                       for _, m, k, n in layers)
            res[(cnn, tag)] = 1 - prop / base
    avg_14 = np.mean([v for (c, t), v in res.items() if t == "1:4"])
    avg_24 = np.mean([v for (c, t), v in res.items() if t == "2:4"])
    assert 0.35 < avg_14 < 0.55, avg_14  # paper: 0.48
    assert 0.55 < avg_24 < 0.75, avg_24  # paper: 0.65
    assert avg_24 > avg_14


@pytest.mark.parametrize("nm,lo,hi", [((1, 4), 1.60, 2.15),
                                      ((2, 4), 1.63, 1.99)],
                         ids=["1:4", "2:4"])
def test_fig4_per_layer_band(nm, lo, hi):
    model = tcost.VectorCoreModel()
    sp = [model.speedup(m, k, n, NMConfig(*nm)) for _, m, k, n in
          cnn_layer_gemms(get_cnn_config("resnet50"))]
    assert min(sp) > lo - 0.15 and max(sp) < hi + 0.15, (min(sp), max(sp))


def test_speedup_monotone_in_stall():
    m, k, n, cfg = 256, 1152, 784, NMConfig(2, 4)
    fast = tcost.VectorCoreModel(stall_indexed=1.0).speedup(m, k, n, cfg)
    slow = tcost.VectorCoreModel(stall_indexed=8.0).speedup(m, k, n, cfg)
    assert slow > fast
