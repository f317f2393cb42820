"""The dry-run's formulas against the JAX package: the shape set and its
skips, ``count_params`` of every config, ``model_flops_for``, the kernel
cost functions' bytes (and the bounds in PERF.md's kernel table), the
roofline report and its table; the registry's meta backend."""
import dataclasses
import functools

import pytest
import torch

from repro import configs as jcfgs
from repro.core import cost_model as jcost
from repro.core.sparsity import NMConfig as JNMConfig
from repro.models.transformer import count_params as jax_count_params
from repro.roofline import analysis as janalysis
from repro.roofline import report as jreport
from repro_torch import configs as tcfgs
from repro_torch.core import cost_model
from repro_torch.core.sparsity import NMConfig
from repro_torch.kernels import registry
from repro_torch.models.transformer import count_params
from repro_torch.roofline import analysis, report

NM = NMConfig(2, 4)


def test_shapes_equal_jax_field_for_field():
    assert list(tcfgs.SHAPES) == list(jcfgs.SHAPES)
    for name, shape in tcfgs.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jcfgs.SHAPES[name])


@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_runnable_shapes_and_skips_equal_jax(arch):
    assert tcfgs.runnable_shapes(arch) == jcfgs.runnable_shapes(arch)
    assert tcfgs.SHAPE_SKIPS[arch] == jcfgs.SHAPE_SKIPS[arch]


def test_only_the_recurrent_archs_run_long_500k():
    assert [a for a in tcfgs.ARCHS if "long_500k" in tcfgs.runnable_shapes(
        a)] == ["rwkv6-3b", "jamba-v0.1-52b"]


@functools.lru_cache(maxsize=None)
def _counts(arch: str, sparse: bool) -> tuple:
    """((total, active) of the port, (total, active) of JAX)."""
    tc = tcfgs.get_config(arch, sparse=sparse)
    jc = jcfgs.get_config(arch, sparse=sparse)
    return ((count_params(tc), count_params(tc, active_only=True)),
            (jax_count_params(jc), jax_count_params(jc, active_only=True)))


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_count_params_equals_jax(arch, sparse):
    """Every config at full size, counted on meta: the whole model and
    the routed experts at top_k, exactly JAX's (eval_shape) counts."""
    port, jax = _counts(arch, sparse)
    assert port == jax
    cfg = tcfgs.get_config(arch, sparse=sparse)
    assert (cfg.param_count(), cfg.active_param_count()) == port


@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_model_flops_equal_jax(arch):
    (total, active), (jtotal, jactive) = _counts(arch, True)
    for name in tcfgs.runnable_shapes(arch):
        got = analysis.model_flops_for(
            tcfgs.get_config(arch), tcfgs.SHAPES[name], active, total)
        want = janalysis.model_flops_for(
            jcfgs.get_config(arch), jcfgs.SHAPES[name], jactive, jtotal)
        assert got == want, name


# the shapes of tests/test_quant.py's and tests/test_conv.py's cost tests
GEMMS = [(16, 4096, 11008), (512, 4096, 11008), (4, 11008, 4096),
         (1, 4096, 512)]
CONVS = [(64, 64, 3, 3, 56, 56), (64, 256, 1, 1, 56, 56),
         (512, 512, 3, 3, 7, 7)]


@pytest.mark.parametrize("m,k,n", GEMMS)
def test_gemm_cost_bytes_equal_jax(m, k, n):
    """Bytes: JAX's stream accounting. Operations: the kept non-zeros'
    (the card does the kept values' work; JAX's MXU the zeros' too)."""
    jnm = JNMConfig(2, 4)
    dense = cost_model.dense_cost(m, k, n)
    assert dense.hbm_bytes == jcost.tpu_dense_cost(m, k, n).hbm_bytes
    assert dense.flops == jcost.tpu_dense_cost(m, k, n).mxu_flops
    for mine, theirs in (
            (cost_model.indexmac_cost(m, k, n, NM),
             jcost.tpu_indexmac_cost(m, k, n, jnm)),
            (cost_model.indexmac_cost(m, k, n, NM, dtype_bytes=4),
             jcost.tpu_indexmac_cost(m, k, n, jnm, dtype_bytes=4)),
            (cost_model.indexmac_q_cost(m, k, n, NM),
             jcost.tpu_indexmac_q_cost(m, k, n, jnm))):
        assert mine.hbm_bytes == theirs.hbm_bytes
        assert mine.flops == theirs.mxu_flops * NM.n / NM.m


@pytest.mark.parametrize("conv", CONVS, ids=str)
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["im2col", "fused"])
def test_conv_cost_bytes_equal_jax(conv, quantized, fused):
    mine = cost_model.conv_cost(*conv, NM, quantized=quantized,
                                fused_im2col=fused)
    theirs = jcost.tpu_conv_cost(*conv, JNMConfig(2, 4),
                                 quantized=quantized, fused_im2col=fused)
    assert mine.hbm_bytes == theirs.hbm_bytes


def test_kernel_costs_give_perf_md_bounds():
    """The bounds of PERF.md's kernel table, rows 1, 3 and 5, as it
    prints them (5 decimals of a ms: 4 significant digits, 3 for row 5):
    yi-9b w_up at M = 512 and at M = 4 (bf16), the gather at s2b1_3x3
    (Mr 64, K 576, Nc 3136) 2:4 with f32 B."""
    rows = {
        1: cost_model.indexmac_cost(512, 4096, 11008, NM),
        3: cost_model.indexmac_cost(4, 4096, 11008, NM),
        5: cost_model.gather_cost(64, 576, 3136, NM, b_bytes=4),
    }
    want = {1: "0.02481", 3: "0.02023", 5: "0.00242"}
    for row, cost in rows.items():
        ms, by = cost.bound_ms()
        assert f"{ms:.5f}" == want[row], row
        assert by == "bytes"


def test_kernel_cost_reads_the_data_nnz_and_the_card_rates():
    full = cost_model.indexmac_q_cost(512, 4096, 11008, NM)
    fewer = cost_model.indexmac_q_cost(512, 4096, 11008, NM,
                                       nnz=2048 * 11008 - 1000)
    assert fewer.flops < full.flops and fewer.hbm_bytes == full.hbm_bytes
    assert full.bound_ms()[1] == "operations"
    assert cost_model.HBM_BYTES_PER_S == 3.35e12
    assert cost_model.PEAK_OPS_PER_S == {torch.bfloat16: 989e12,
                                         torch.float32: 495e12 / 3}
    f32 = cost_model.indexmac_cost(512, 4096, 11008, NM, dtype_bytes=4)
    assert f32.dtype == torch.float32
    assert f32.t_compute() == f32.flops / (495e12 / 3)
    assert cost_model.roofline_ms(3.35e9, 0, torch.bfloat16) == (1.0,
                                                                "bytes")


def _report(mod, **extra):
    return mod.RooflineReport(
        name="c", chips=256, flops_per_chip=2e12, bytes_per_chip=4e10,
        collective_bytes_per_chip=1e9,
        collective_breakdown={"all_reduce": 1e9}, model_flops=3e14,
        memory={"argument_size_in_bytes": 2**30}, **extra)


def test_roofline_report_has_jax_fields_and_terms():
    fields = {f.name for f in dataclasses.fields(janalysis.RooflineReport)}
    assert fields <= {f.name for f in dataclasses.fields(
        analysis.RooflineReport)}
    mine = _report(analysis, collective_axes={"model": (6e8, 450e9),
                                              "data": (4e8, 50e9)})
    theirs = _report(janalysis)
    assert set(theirs.to_json()) <= set(mine.to_json())
    # the formulas are JAX's; only the card's rates differ
    assert mine.t_compute == 2e12 / 989e12
    assert mine.t_memory == 4e10 / 3.35e12
    assert mine.t_collective == 6e8 / 450e9 + 4e8 / 50e9
    assert mine.bottleneck == "memory" and mine.t_bound == mine.t_memory
    assert mine.useful_flops_frac == 3e14 / (2e12 * 256)
    assert mine.roofline_frac == (3e14 / 256 / 989e12) / mine.t_memory
    assert analysis.fmt_row(mine).count("|") == janalysis.fmt_row(
        theirs).count("|")


def test_link_rates_by_node():
    """NVLink for an axis inside one 8-card node, the network across."""
    assert analysis.link_bw({"data": 1, "model": 8}, "model") == 450e9
    assert analysis.link_bw({"data": 2, "model": 4}, "data") == 450e9
    assert analysis.link_bw({"data": 16, "model": 16}, "model") == 50e9
    assert analysis.link_bw({"data": 16, "model": 16}, "data") == 50e9
    assert analysis.link_bw({"data": 2, "model": 8}, "world") == 50e9


def test_report_table_equals_jax():
    rows = []
    for arch in ("yi-9b", "rwkv6-3b"):
        for i, shape in enumerate(tcfgs.runnable_shapes(arch)):
            rows.append(dict(
                arch=arch, shape=shape, mesh="single", sparse=True,
                t_compute=1e-3 * i, t_memory=2e-3, t_collective=3e-4 * i,
                bottleneck="memory", useful_flops_frac=0.5 + 0.01 * i,
                roofline_frac=0.1 * i,
                memory={"argument_size_in_bytes": 2**31 * (i + 1)}))
    assert report.SHAPE_ORDER == jreport.SHAPE_ORDER
    assert report.fmt_table(rows) == jreport.fmt_table(rows)
    assert report.fmt_table(rows, sparse=None) == jreport.fmt_table(
        rows, sparse=None)


def test_meta_backend_serves_meta_tensors_only():
    meta, cpu = torch.device("meta"), torch.device("cpu")
    assert registry.resolve_backend(None, meta) == "meta"
    assert registry.resolve_backend("auto", meta) == "meta"
    assert registry.resolve_backend(None, cpu) == "cpu"
    for other in ("cpu", "cuda"):
        with pytest.raises(registry.KernelForceError):
            registry.resolve_backend(other, meta)
    with pytest.raises(ValueError):
        registry.resolve_backend("meta", cpu)


def test_meta_backend_leaves_cpu_routing_unchanged():
    """A CPU call routes and records as before; a meta call of the same
    weight runs the meta implementation, an empty output of the kernel's
    shape and dtype."""
    from repro_torch.api import sparsify
    from repro_torch.core.nmweight import KernelPolicy
    from repro_torch.kernels.indexmac.ops import explain_dispatch, nm_matmul

    gen = torch.Generator().manual_seed(0)
    w = sparsify(torch.randn(64, 48, generator=gen), NM,
                 kernel_policy=KernelPolicy("auto"))
    x = torch.randn(16, 64, generator=gen)
    registry.clear_history()
    y = nm_matmul(x, w)
    rec = registry.last_dispatch()
    assert rec == explain_dispatch(x.shape, w)
    assert rec.backend == "cpu" and rec.impl in ("nm_spmm_decode",
                                                 "nm_spmm", "reference")
    wm = dataclasses.replace(w, vals=w.vals.to("meta"), idx=w.idx.to("meta"))
    ym = nm_matmul(x.to("meta"), wm)
    assert ym.is_meta and ym.shape == y.shape and ym.dtype == y.dtype
    assert registry.last_dispatch().impl == "meta"
    off = dataclasses.replace(wm, kernel_policy=KernelPolicy("off"))
    nm_matmul(x.to("meta"), off)  # policy off: the reference, on meta
    assert registry.last_dispatch().impl == "reference"


@pytest.mark.parametrize("case", ["f16", "pinned_block"])
def test_meta_backend_refuses_what_the_card_refuses(case):
    """A meta call whose shape, dtype or pinned block has no kernel on
    the card raises as the card's route does, and so never counts as a
    kernel dispatch in a dry-run."""
    from repro_torch.api import sparsify
    from repro_torch.core.nmweight import KernelPolicy
    from repro_torch.kernels.indexmac.ops import explain_dispatch, nm_matmul

    gen = torch.Generator().manual_seed(0)
    dtype = torch.float16 if case == "f16" else torch.float32
    pol = KernelPolicy("auto", block=(7, 7, 7)) if case == "pinned_block" \
        else KernelPolicy("auto")
    w = sparsify(torch.randn(64, 48, generator=gen).to(dtype), NM,
                 kernel_policy=pol)
    x = torch.randn(16, 64, generator=gen).to(dtype)
    assert nm_matmul(x, w).shape == (16, 48)  # the CPU's reference
    assert registry.last_dispatch().impl == "reference"
    with pytest.raises(registry.KernelForceError):
        explain_dispatch(x.shape, w, device="cuda")
    wm = dataclasses.replace(w, vals=w.vals.to("meta"), idx=w.idx.to("meta"))
    with pytest.raises(registry.KernelForceError):
        nm_matmul(x.to("meta"), wm)
