"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``tests/test_obs.py``: zero overhead when off, faithful when
on.

The registry semantics and the Prometheus round-trip, the tracer's ring
buffer and Chrome-trace schema, the env gate (``REPRO_OBS`` unset vs
``0`` vs ``1``), serve token parity and one graph a step kind with
observability on, the per-request ITL accounting, the dispatch counters
and their mirror to ``kernel_dispatch_total``, the paging counters; and
one parity test more: the same requests through the JAX engine and the
port's, both paged with obs on, give equal ``sched_*`` and ``page_*``
counters.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as obs
from repro.configs import get_reduced as jax_reduced
from repro.models import common as jcommon
from repro.models.transformer import LM as JaxLM
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_reduced
from repro_torch.interop import lm_from_jax
from repro_torch.models.transformer import LM
from repro_torch.obs.check import (
    TraceValidationError,
    validate_chrome_trace,
    validate_metrics,
)
from repro_torch.obs.metrics import MetricsRegistry, parse_prometheus
from repro_torch.obs.trace import Tracer
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.scheduler import Scheduler
from test_torch_model import numpy_tree

PAGED = dict(paged=True, prefill_chunk=4, page_size=4, pool_pages=2 * 16)


@pytest.fixture(autouse=True)
def _isolated_obs():
    """Every test starts with obs off and the env decision forgotten."""
    obs.reset_for_tests()
    yield
    obs.reset_for_tests()


@pytest.fixture(scope="module")
def yi():
    cfg = get_reduced("yi-9b")
    return cfg, LM.init(cfg, seed=0, dtype=torch.float32, device="cpu")


def _prompts(cfg, n=4):
    rng = np.random.default_rng(7)
    return [rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
            for _ in range(n)]


def _serve(lm, cfg, **extra):
    eng = ServeEngine(lm, slots=2, max_seq=64, prefill_len=8, **extra)
    for i, p in enumerate(_prompts(cfg)):
        eng.submit(Request(rid=i, prompt=p, max_new=4))
    eng.run()
    return {r.rid: tuple(r.out) for r in eng.finished}, eng


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_metrics_counters_gauges_histograms():
    m = MetricsRegistry()
    m.inc("reqs_total")
    m.inc("reqs_total", 2.0)
    m.inc("reqs_total", kind="paged")
    m.set_gauge("depth", 3)
    m.set_gauge("depth", 5)
    m.observe("lat_seconds", 0.002)
    m.observe("lat_seconds", 100.0)  # beyond the top edge -> +Inf bucket
    assert m.counter_value("reqs_total") == 3.0
    assert m.counter_value("reqs_total", kind="paged") == 1.0
    assert m.counter_value("never_touched") == 0.0
    assert m.gauge_value("depth") == 5.0
    snap = m.snapshot()
    h = snap["histograms"]["lat_seconds"]
    assert h["count"] == 2 and h["sum"] == pytest.approx(100.002)
    assert h["buckets"][-1][0] == "+Inf" and h["buckets"][-1][1] == 2
    json.dumps(snap)  # strict JSON


def test_prometheus_round_trip():
    m = MetricsRegistry()
    m.inc("a_total", 4, op="x", impl="y")
    m.set_gauge("g", 1.5)
    m.observe("h_seconds", 0.03)
    text = m.to_prometheus()
    parsed = parse_prometheus(text)
    assert parsed["types"] == {"a_total": "counter", "g": "gauge",
                               "h_seconds": "histogram"}
    assert parsed["samples"]['a_total{impl="y",op="x"}'] == 4.0
    assert parsed["samples"]["g"] == 1.5
    assert parsed["samples"]["h_seconds_count"] == 1.0
    assert parsed["samples"]['h_seconds_bucket{le="+Inf"}'] == 1.0
    with pytest.raises(ValueError, match="malformed"):
        parse_prometheus("not a metric line at all")
    # the same text as the JAX package's registry renders
    jm = jobs.MetricsRegistry()
    jm.inc("a_total", 4, op="x", impl="y")
    jm.set_gauge("g", 1.5)
    jm.observe("h_seconds", 0.03)
    assert jm.to_prometheus() == text


def test_histogram_edges_conflict_rejected():
    m = MetricsRegistry()
    m.define_histogram("h", (1.0, 2.0))
    m.define_histogram("h", (1.0, 2.0))  # same edges: fine
    with pytest.raises(ValueError, match="different"):
        m.define_histogram("h", (1.0, 3.0))


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def test_tracer_span_emits_matched_pair_even_on_exception(tmp_path):
    t = Tracer()
    with pytest.raises(RuntimeError):
        with t.span("work", step=1):
            raise RuntimeError("boom")
    assert [e["ph"] for e in t.events()] == ["B", "E"]
    path = str(tmp_path / "trace.json")
    t.export_chrome(path)
    assert validate_chrome_trace(path)["sync_spans"] == 1


def test_tracer_ring_buffer_caps_and_counts_drops():
    t = Tracer(capacity=4)
    for i in range(10):
        t.instant("tick", i=i)
    evs = t.events()
    assert len(evs) == 4 and t.dropped == 6
    assert [e["args"]["i"] for e in evs] == [6, 7, 8, 9]  # newest kept


def test_chrome_export_schema_and_async_request_spans(tmp_path):
    t = Tracer()
    t.async_begin("request 0", 0, slot=1)
    t.instant("engine.step", occupied=1)
    t.async_instant("first_token", 0)
    t.async_end("request 0", 0, tokens=4)
    path = str(tmp_path / "trace.json")
    t.export_chrome(path)
    with open(path) as f:
        payload = json.load(f)
    for ev in payload["traceEvents"]:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(ev)
    assert payload["otherData"]["producer"] == "repro_torch.obs"
    stats = validate_chrome_trace(path)
    assert stats == {"events": 4, "sync_spans": 0, "async_spans": 1,
                     "instants": 2}


def test_trace_validation_rejects_malformed(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"name": "x"}]))  # array form, no keys
    with pytest.raises(TraceValidationError, match="JSON-object"):
        validate_chrome_trace(str(bad))
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(TraceValidationError, match="empty"):
        validate_chrome_trace(str(empty))
    unmatched = tmp_path / "unmatched.json"
    unmatched.write_text(json.dumps({"traceEvents": [
        {"name": "w", "ph": "B", "ts": 1, "pid": 1, "tid": 1}]}))
    with pytest.raises(TraceValidationError, match="unmatched"):
        validate_chrome_trace(str(unmatched))
    backwards = tmp_path / "backwards.json"
    backwards.write_text(json.dumps({"traceEvents": [
        {"name": "a", "ph": "i", "ts": 5, "pid": 1, "tid": 1},
        {"name": "b", "ph": "i", "ts": 1, "pid": 1, "tid": 1}]}))
    with pytest.raises(TraceValidationError, match="backwards"):
        validate_chrome_trace(str(backwards))


def test_metrics_validation_requires_subsystems(tmp_path):
    m = MetricsRegistry()
    m.inc("serve_steps_total")
    p = tmp_path / "m.prom"
    p.write_text(m.to_prometheus())
    assert validate_metrics(str(p), require_subsystems=("engine",))
    with pytest.raises(TraceValidationError, match="paging"):
        validate_metrics(str(p), require_subsystems=("engine", "paging"))


# ---------------------------------------------------------------------------
# env gate / global bundle
# ---------------------------------------------------------------------------


def test_env_gate_unset_empty_and_zero_all_mean_off(monkeypatch):
    for value in (None, "", "0"):
        obs.reset_for_tests()
        if value is None:
            monkeypatch.delenv("REPRO_OBS", raising=False)
        else:
            monkeypatch.setenv("REPRO_OBS", value)
        assert obs.get_obs() is None
    obs.reset_for_tests()
    monkeypatch.setenv("REPRO_OBS", "1")
    bundle = obs.get_obs()
    assert bundle is not None
    assert obs.get_obs() is bundle  # cached decision


def test_env_decision_read_once(monkeypatch):
    monkeypatch.delenv("REPRO_OBS", raising=False)
    assert obs.get_obs() is None
    monkeypatch.setenv("REPRO_OBS", "1")
    assert obs.get_obs() is None  # decision already made for this process
    obs.reset_for_tests()
    assert obs.get_obs() is not None


def test_enable_is_idempotent_and_explicit_bundle_wins():
    first = obs.enable()
    assert obs.enable() is first
    mine = obs.Obs.create()
    assert obs.enable(mine) is mine
    assert obs.get_obs() is mine
    obs.disable()
    assert obs.get_obs() is None


# ---------------------------------------------------------------------------
# serving integration
# ---------------------------------------------------------------------------


def test_obs_off_is_noop_and_on_keeps_token_parity(yi, monkeypatch):
    """REPRO_OBS unset and REPRO_OBS=0 give identical token streams;
    turning obs on changes no token and keeps one step shape a kind."""
    cfg, lm = yi
    monkeypatch.delenv("REPRO_OBS", raising=False)
    obs.reset_for_tests()
    toks_unset, _ = _serve(lm, cfg, **PAGED)
    assert obs.get_obs() is None

    monkeypatch.setenv("REPRO_OBS", "0")
    obs.reset_for_tests()
    toks_zero, _ = _serve(lm, cfg, **PAGED)
    assert obs.get_obs() is None
    assert toks_zero == toks_unset

    obs.reset_for_tests()
    bundle = obs.enable()
    toks_on, eng = _serve(lm, cfg, **PAGED)
    assert toks_on == toks_unset
    assert eng.compiled_cache_sizes() == {"prefill": 1, "decode": 1}
    snap = bundle.metrics.snapshot()
    assert snap["counters"]["sched_admissions_total"] >= 4
    assert snap["counters"]["page_allocs_total"] > 0
    assert "serve_itl_seconds" in snap["histograms"]


def test_traced_serve_exports_valid_artifacts(yi, tmp_path):
    """An obs-on paged serve exports a valid Chrome trace with a request
    span per request and a Prometheus file covering the engine, the
    scheduler and the pages."""
    cfg, lm = yi
    bundle = obs.enable(obs.Obs.create())
    _serve(lm, cfg, **PAGED)
    trace = str(tmp_path / "trace.json")
    prom = str(tmp_path / "metrics.prom")
    bundle.tracer.export_chrome(trace)
    with open(prom, "w") as f:
        f.write(bundle.metrics.to_prometheus())
    stats = validate_chrome_trace(trace)
    assert stats["async_spans"] >= 4    # one request span per request
    assert stats["sync_spans"] > 0      # engine.prefill / engine.decode
    assert validate_metrics(
        str(prom), require_subsystems=("engine", "scheduler", "paging"))
    with open(trace) as f:
        evs = json.load(f)["traceEvents"]
    begins = [e for e in evs if e["ph"] == "b"]
    assert all(e["cat"] == "request" and "slot" in e["args"]
               for e in begins)
    assert any(e["ph"] == "n" and e["name"] == "first_token" for e in evs)


def test_obs_check_cli(yi, tmp_path, capsys):
    from repro_torch.obs import check as obscheck

    cfg, lm = yi
    bundle = obs.enable(obs.Obs.create())
    _serve(lm, cfg, **PAGED)
    trace = str(tmp_path / "trace.json")
    prom = str(tmp_path / "metrics.prom")
    bundle.tracer.export_chrome(trace)
    with open(prom, "w") as f:
        f.write(bundle.metrics.to_prometheus())
    rc = obscheck.main([trace, prom,
                        "--require-subsystems", "engine,scheduler,paging"])
    assert rc == 0
    rc = obscheck.main([trace, prom, "--require-subsystems", "autotune"])
    assert rc == 1  # a reference-route serve looks up no launch
    assert "FAIL" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# per-request ITL accounting
# ---------------------------------------------------------------------------


def test_itl_is_per_request_not_global_decode_clock():
    """Two interleaved requests: each request's own cadence is what its
    ITL reports. Driven through the scheduler with made-up times."""
    sched = Scheduler(slots=2, max_seq=32, prefill_len=4)
    for rid in range(2):
        sched.submit(Request(rid=rid,
                             prompt=np.arange(1, 5, dtype=np.int32),
                             max_new=4), now=0.0)
    pf = sched.plan_prefill()
    sched.finish_prefill(pf, np.asarray([10, 20]), now=1.0)
    for t in (2.0, 4.0, 8.0):
        dc = sched.plan_decode()
        sched.finish_decode(dc, np.asarray([11, 21]), now=t)
    assert len(sched.finished) == 2
    for req in sched.finished:
        assert req.t_tokens == [1.0, 2.0, 4.0, 8.0]
        np.testing.assert_allclose(req.itl_s(), [1.0, 2.0, 4.0])


def test_throughput_stats_keys(yi):
    cfg, lm = yi
    _, eng = _serve(lm, cfg)
    st = eng.throughput_stats()
    for key in ("requests", "tokens", "ttft_s", "ttft_p50_s",
                "ttft_p99_s", "itl_p50_s", "itl_p99_s"):
        assert key in st
    assert st["ttft_p50_s"] <= st["ttft_p99_s"]
    assert 0 < st["itl_p50_s"] <= st["itl_p99_s"]


def test_preemption_clears_token_timestamps():
    from repro_torch.serving.paging import PageManager

    pm = PageManager(page_size=4, pages_per_group=16, slots=1, max_seq=32)
    sp = Scheduler(slots=1, max_seq=32, prefill_len=4, paging=pm)
    rq = Request(rid=1, prompt=np.arange(1, 5, dtype=np.int32), max_new=8)
    sp.submit(rq, now=0.0)
    p = sp.plan_prefill()
    sp.finish_prefill(p, np.asarray([10]), now=1.0)
    assert rq.t_tokens == [1.0]
    sp._preempt(0)
    assert rq.t_tokens == [] and rq.out == [] and rq.t_first is None


# ---------------------------------------------------------------------------
# dispatch counters
# ---------------------------------------------------------------------------


def _rec(op, impl, m):
    from repro_torch.kernels import registry

    return registry.DispatchRecord(op=op, impl=impl, shape=(m, 64, 64),
                                   padded=None, block=None, reason="")


def test_dispatch_counts_reset_with_history():
    from repro_torch.kernels import registry

    registry.clear_history()
    registry._record(_rec("nm_matmul_decode", "nm_spmm_decode", 2))
    registry._record(_rec("nm_matmul", "reference", 16))
    counts = registry.dispatch_counts()
    assert counts[("nm_matmul_decode", "nm_spmm_decode", "cpu")] == 1
    assert registry.dispatch_counts("nm_matmul_decode") == {
        ("nm_matmul_decode", "nm_spmm_decode", "cpu"): 1}
    # the backend filter selects the third key component
    assert registry.dispatch_counts(backend="cpu") == counts
    assert registry.dispatch_counts(backend="cuda") == {}
    registry.clear_history()
    assert registry.dispatch_counts() == {}
    assert registry.dispatch_history() == []


def test_dispatch_counts_mirror_to_obs_metric():
    from repro_torch.kernels import registry

    bundle = obs.enable(obs.Obs.create())
    registry._record(_rec("nm_matmul_decode", "nm_spmm_decode", 2))
    assert bundle.metrics.counter_value(
        "kernel_dispatch_total", op="nm_matmul_decode",
        impl="nm_spmm_decode", backend="cpu") == 1.0
    registry.clear_history()


# ---------------------------------------------------------------------------
# paging counters
# ---------------------------------------------------------------------------


def test_page_manager_mirrors_stats_to_metrics():
    from repro_torch.serving.paging import PageManager

    bundle = obs.Obs.create()
    pm = PageManager(page_size=4, pages_per_group=8, slots=2, max_seq=16,
                     obs=bundle)
    gid = pm.alloc(0)
    pm.register_prefix(0, b"k0", gid)
    hit = pm.peek(0, b"k0")
    pm.hit(hit)
    pm.release(gid)
    pm.release(gid)       # refcount 0, stays cached (evictable)
    assert pm.evict_lru(0)
    pm.count_prefix_lookup(3)
    m = bundle.metrics
    assert m.counter_value("page_allocs_total") == pm.stats.allocs == 1
    assert m.counter_value("page_evictions_total") == pm.stats.evictions == 1
    assert m.counter_value("prefix_hit_pages_total") == \
        pm.stats.prefix_hit_pages == 1
    assert m.counter_value("prefix_lookup_pages_total") == \
        pm.stats.prefix_lookup_pages == 3
    assert m.counter_value("page_frees_total") == 0  # evicted, not freed


def test_null_span_allocates_nothing_per_call():
    s = obs.null_span()
    assert s("anything", a=1) is s
    with s("block") as inner:
        assert inner is s
    assert obs.null_span() is s  # module singleton


# ---------------------------------------------------------------------------
# parity with the JAX engine's counters
# ---------------------------------------------------------------------------


def test_sched_and_page_counters_equal_the_jax_engines():
    """The same requests through the JAX engine and the port's, both
    paged (a pool small enough to preempt, prompts sharing a prefix),
    each with its own bundle: equal ``sched_*`` / ``page_*`` /
    ``prefix_*`` counters."""
    jcommon.set_compute_dtype(jnp.float32)
    try:
        jcfg = jax_reduced("yi-9b")
        jlm = JaxLM(jcfg)
        params = jlm.init(jax.random.PRNGKey(0))
        tlm = lm_from_jax(get_reduced("yi-9b"), numpy_tree(params),
                          dtype=torch.float32, device="cpu")
        kw = dict(slots=2, max_seq=32, prefill_len=8, prefill_chunk=4,
                  paged=True, page_size=4, pool_pages=8)
        rng = np.random.default_rng(3)
        prompts = rng.integers(0, jcfg.vocab_size, (5, 8)).astype(np.int32)
        prompts[:, :4] = prompts[0, :4]
        jb, tb = jobs.Obs.create(), obs.Obs.create()
        jeng = JaxServeEngine(jlm, params, obs=jb, **kw)
        teng = ServeEngine(tlm, obs=tb, **kw)
        for i, p in enumerate(prompts):
            jeng.submit(JaxRequest(rid=i, prompt=p, max_new=16))
            teng.submit(Request(rid=i, prompt=p, max_new=16))
        jeng.run()
        teng.run()
    finally:
        jcommon.set_compute_dtype(jnp.bfloat16)

    def counters(bundle):
        return {k: v for k, v in
                bundle.metrics.snapshot()["counters"].items()
                if k.startswith(("sched_", "page_", "prefix_"))}

    want = counters(jb)
    assert want["sched_preemptions_total"] >= 1
    assert want["prefix_hit_pages_total"] >= 1
    assert counters(tb) == want
