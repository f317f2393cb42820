#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result line:

1. card: its name and power limit, as nvidia-smi reports them.
2. build: the four CUDA kernel libraries, compiled by nvcc for sm_90a
   from the sources in this checkout (one nvcc per source, in parallel);
   ptxas's spill report of each.
3. kernels: each kernel against its plain PyTorch version at the GEMM
   shapes of full-width yi-9b (K x N = 4096x4096, 4096x512, 4096x11008,
   11008x4096; M = 512 for prefill, M = 4 for decode with and without
   bias + SiLU; x in bf16 and f32), within the stated tolerance. The
   float kernels take vals in x's dtype, the int8 kernels int8 vals and
   f32 scales from quantize_nm of the same random 2:4 weights. Integer-
   lattice cases per shape must be bit-exact (f32 x for the float
   kernels; f32 and bf16 x for the int8 kernels). Times (CUDA events, L2
   flushed before every launch) of the kernel, its plain version and
   torch.matmul on the decompressed dense weight (for int8: the int8
   weight cast to x's dtype, exact; the matmul alone, without the scale
   multiply); the bound.
4. reference: reduced yi-9b in f32 on the card, with f32 weights and
   then with int8 weights (quantize="int8"): logits through the kernels
   against logits through the reference (prefill and decode).
5. serve: full-width yi-9b (48 layers, random 2:4 weights from seed 0,
   bf16 activations) serves 8 requests through ServeEngine (4 slots,
   prefill 128, 32 new tokens each), first with bf16 weights, then, the
   bf16 model freed, with int8 weights. Launch counts and dispatch counts
   are zeroed just before each serve and read just after; the kernels of
   that path must have launched, the other family's kernels not, and the
   reference must have run zero times.

Then one JSON line naming the kernels, then the result line.
"""
import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SHAPES = {  # projection -> (K, N) of full-width yi-9b
    "wq/wo": (4096, 4096),
    "wk/wv": (4096, 512),
    "w_up/w_gate": (4096, 11008),
    "w_down": (11008, 4096),
}
PREFILL_M, DECODE_M = 512, 4
# stated tolerance (rtol = atol) of kernel vs plain version: both sum in
# f32, in other orders; bf16 outputs round those sums and may differ by
# one bf16 step (2^-7 relative)
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# dense peak rates of one H100 SXM at 700 W: bf16 on the tensor cores,
# f32 on the CUDA cores (what an exact-f32 product may use)
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
SERVE = dict(layers=48, requests=8, slots=4, prefill_len=128, max_new=32)
REPORTED = "w_up/w_gate"  # the shape whose numbers the kernels line carries
KERNELS = ("nm_spmm", "nm_spmm_decode", "nm_spmm_q", "nm_spmm_decode_q")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """Registers per thread of each main kernel in an ``-Xptxas -v``
    report (x type, then rows x columns per thread for the decode
    kernels), and every spill of any entry function."""
    regs, spills, entry = [], [], None
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and m.group(1) != "0":
            spills.append(f"{entry}: {line.strip()}")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            if "finish" not in entry:
                x = "bf16" if "kernelI13__nv_bfloat16" in entry else "f32"
                shape = re.search(r"Li(\d+)ELi(\d+)E", entry)
                label = x + (f" M{shape[1]}xV{shape[2]}" if shape else "")
                regs.append(f"{label}={m.group(1)}")
            entry = None
    return ("registers " + ", ".join(regs) + "; spills: "
            + ("; ".join(spills) if spills else "none"))


def port():
    """The port's modules, imported from ``src`` of this checkout."""
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found next to chip_smoke.py; run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.launch.serve  # noqa: F401  (pulls in the whole path)

    if "jax" in sys.modules or "repro" in sys.modules:
        fail("the port imported jax or the JAX package")


def time_ms(fn, iters: int, flush) -> float:
    """Median ms of one call: L2 flushed before each (``flush`` zeroed),
    CUDA events around the call alone."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound_ms(m, k, n, dtype, vals, bias=False, scales=False):
    """Least time (ms) for the work, and what sets it: the bytes the
    function must move (each input read once, the output written once:
    x, vals + 1 idx byte per kept value, the f32 scales and bias, y) over
    HBM bandwidth, or the multiply-adds this data needs (kept non-zeros
    only) over the dense peak rate of x's type."""
    s = dtype.itemsize
    nbytes = m * k * s + vals.numel() * (vals.element_size() + 1) + m * n * s
    nbytes += 4 * n * (int(bias) + int(scales))
    ops = 2 * m * int((vals != 0).sum())
    peak = PEAK_OPS_PER_S[dtype]
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(dev):
    """Each kernel against its plain version at the served shapes; the
    lattice cases; times. Returns (worst |err| per kernel, the numbers of
    the REPORTED shape per kernel)."""
    from repro_torch.core.nmweight import NMWeight
    from repro_torch.core.sparsity import (
        NMConfig,
        apply_mask,
        compress_nm,
        decompress_nm,
        prune_mask_nm,
    )
    from repro_torch.kernels.indexmac import decode_kernel, kernel
    from repro_torch.quant import quantize_nm

    cfg = NMConfig(2, 4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # 1 GiB: zeroing it evicts the 50 MB L2 and keeps the card busy
    # (~0.3 ms) while the host enqueues the timed launch, so the event
    # pair holds the kernel and not the wrapper's host time
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)

    def weights(k, n, lattice):
        """(vals f32, idx) of random 2:4 weights, and their int8 form
        (vals, idx, scales): quantize_nm of the same weights, or on the
        lattice random int8 values with random scales."""
        if lattice:
            sign = torch.randint(0, 2, (k, n), generator=gen, device=dev)
            w = (torch.randint(1, 5, (k, n), generator=gen, device=dev)
                 * (2 * sign - 1)).float()
        else:
            w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
        vals, idx = compress_nm(apply_mask(w, prune_mask_nm(w, cfg)), cfg)
        if lattice:
            q = torch.randint(-127, 128, vals.shape, generator=gen,
                              device=dev, dtype=torch.int8)
            q = torch.where(vals == 0, torch.zeros_like(q), q)
            sc = torch.rand(n, generator=gen, device=dev) * 0.09 + 0.01
            return (vals, idx), (q, idx, sc)
        qw = quantize_nm(NMWeight(vals, idx, cfg))
        return (vals, idx), (qw.vals, qw.idx, qw.scales)

    def inputs(m, k, n, dtype, lattice):
        if lattice:
            x = torch.randint(-4, 5, (m, k), generator=gen, device=dev)
            b = torch.randint(-8, 9, (n,), generator=gen, device=dev).float()
            return x.to(dtype), b
        x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
        return x, torch.randn(n, generator=gen, device=dev)

    worst = dict.fromkeys(KERNELS, 0.0)
    report = {}
    print("kernel                 x     proj           M  max|err|   "
          "kernel_ms   plain_ms  matmul_ms   bound_ms (by)", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for proj, (k, n) in SHAPES.items():
            (fv, fi), (qv, qi, qs) = weights(k, n, lattice=False)
            fv = fv.to(dtype)
            dense = decompress_nm(fv, fi, cfg)
            dense8 = decompress_nm(qv, qi, cfg).to(dtype)  # exact
            for name, m, act in (
                    ("nm_spmm", PREFILL_M, None),
                    ("nm_spmm_decode", DECODE_M, None),
                    ("nm_spmm_decode", DECODE_M, "silu"),
                    ("nm_spmm_q", PREFILL_M, None),
                    ("nm_spmm_decode_q", DECODE_M, None),
                    ("nm_spmm_decode_q", DECODE_M, "silu")):
                x, b = inputs(m, k, n, dtype, lattice=False)
                b = b if act else None
                quantized = name.endswith("_q")
                w_args = (qv, qi, qs) if quantized else (fv, fi)
                if name.startswith("nm_spmm_decode"):
                    args = (x, *w_args, b, cfg, act)
                    mod = decode_kernel
                else:
                    args = (x, *w_args, cfg)
                    mod = kernel
                run, plain = getattr(mod, name), getattr(mod, name + "_plain")
                got, want = run(*args).float(), plain(*args).float()
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                tol = TOL[dtype]
                if not torch.allclose(got, want, rtol=tol, atol=tol):
                    fail(f"{name} {dtype} {proj} M={m} act={act}: "
                         f"max|kernel - plain| = {err} beyond {tol}")
                worst[name] = max(worst[name], err)
                label = name + ("+bias+silu" if act else "")
                dt = "bf16" if dtype == torch.bfloat16 else "f32"
                line = f"{label:22s} {dt:5s} {proj:11s} {m:4d}  {err:.3e}"
                if dtype == torch.bfloat16:  # the served dtype is timed
                    w_dense = dense8 if quantized else dense
                    ms = time_ms(lambda: run(*args), 20, flush)
                    plain_ms = time_ms(lambda: plain(*args), 5, flush)
                    lib_ms = (None if act else
                              time_ms(lambda: torch.matmul(x, w_dense), 20,
                                      flush))
                    bms, by = bound_ms(m, k, n, dtype, w_args[0],
                                       bias=bool(act), scales=quantized)
                    lib = "-" if lib_ms is None else f"{lib_ms:10.5f}"
                    line += (f" {ms:10.5f} {plain_ms:10.5f} {lib:>10s} "
                             f"{bms:10.5f} ({by})")
                    if proj == REPORTED and not act:
                        report[name] = dict(ms=ms, plain_ms=plain_ms,
                                            bound_ms=bms, bound_by=by,
                                            library_ms=lib_ms)
                print(line, flush=True)
            # integer lattice: every order of the sums is exact
            (fv, fi), (qv, qi, qs) = weights(k, n, lattice=True)
            lattice_cases = [(torch.float32, "float", (fv, fi))]
            lattice_cases += [(dt, "int8", (qv, qi, qs))
                              for dt in (torch.float32, torch.bfloat16)]
            for xdt, fam, w_args in lattice_cases:
                if dtype != xdt:
                    continue
                sfx = "_q" if fam == "int8" else ""
                pk, pp = (getattr(kernel, "nm_spmm" + sfx),
                          getattr(kernel, "nm_spmm" + sfx + "_plain"))
                dk, dp = (getattr(decode_kernel, "nm_spmm_decode" + sfx),
                          getattr(decode_kernel,
                                  "nm_spmm_decode" + sfx + "_plain"))
                x, _ = inputs(PREFILL_M, k, n, xdt, lattice=True)
                same = torch.equal(pk(x, *w_args, cfg), pp(x, *w_args, cfg))
                x, b = inputs(DECODE_M, k, n, xdt, lattice=True)
                same &= torch.equal(dk(x, *w_args, b, cfg, "relu"),
                                    dp(x, *w_args, b, cfg, "relu"))
                dt = "bf16" if xdt == torch.bfloat16 else "f32"
                if not same:
                    fail(f"integer lattice not bit-exact: {fam} kernels, "
                         f"x {dt}, {proj}")
                print(f"lattice {fam} x {dt} {proj}: bit-exact "
                      f"(M={PREFILL_M}; M={DECODE_M} with bias + relu)",
                      flush=True)
    return worst, report


def reference_phase(dev, quantize=None) -> None:
    """Reduced yi-9b in f32 (int8 weights with ``quantize="int8"``):
    logits through the kernels against logits through the reference on
    the same weights (prefill, then decode)."""
    from repro_torch.core.nmweight import KernelPolicy
    from repro_torch.kernels import registry
    from repro_torch.launch.serve import build_model
    from repro_torch.models.cache import CacheView
    from repro_torch.models.common import Linear

    small, lm = build_model("yi-9b", full=False, kernels=True,
                            dtype=torch.float32, seed=1, device=dev,
                            quantize=quantize)
    kinds = ({"nm_spmm_q", "nm_spmm_decode_q"} if quantize
             else {"nm_spmm", "nm_spmm_decode"})
    what_w = "int8" if quantize else "f32"
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    toks = torch.randint(0, small.vocab_size, (2, 16), generator=gen,
                         device=dev)

    def set_policy(mode):
        for mod in lm.modules():
            if isinstance(mod, Linear) and mod.nm is not None:
                mod.kernel_policy = KernelPolicy(mode)

    def two_steps():
        cache = lm.init_cache(2, 32)
        lp, cache = lm(toks, view=CacheView.prefill(), caches=cache)
        nxt = lp[:, -1].argmax(-1, keepdim=True)
        ld, _ = lm(nxt, view=CacheView.decode(torch.tensor([16, 16])),
                   caches=cache)
        return lp, ld

    with torch.inference_mode():
        registry.clear_history()  # the weights' own policy, "auto"
        kp, kd = two_steps()
        counts = registry.dispatch_counts()
        if set(k[1] for k in counts) != kinds:
            fail(f"reference check: the {what_w} kernels did not serve: "
                 f"{counts}")
        set_policy("off")
        rp, rd = two_steps()
    for what, a, b in (("prefill", kp, rp), ("decode", kd, rd)):
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            fail(f"reference check {what}: shape {tuple(a.shape)} or "
                 "non-finite logits")
        err = float((a - b).abs().max())
        if err > 1e-4:
            fail(f"reference check {what_w} {what}: max|kernels - "
                 f"reference| = {err}")
        print(f"reference: reduced yi-9b f32, {what_w} weights, {what} "
              f"logits {tuple(a.shape)} max|kernels - reference| = "
              f"{err:.3e} (tolerance 1e-4)", flush=True)


def serve_phase(dev, *, full=True, layers=SERVE["layers"], quantize=None):
    """Serve SERVE["requests"] requests with bf16 weights, or int8 ones
    with ``quantize="int8"``; returns the launches of each kernel and the
    dispatch counts of that run."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.indexmac import decode_kernel, kernel
    from repro_torch.launch.serve import build_model, serve

    on_card = dev.type == "cuda"
    served = ({"nm_spmm_q", "nm_spmm_decode_q"} if quantize
              else {"nm_spmm", "nm_spmm_decode"})
    weights = "int8" if quantize else "bf16"
    t0 = time.perf_counter()
    cfg, lm = build_model("yi-9b", full=full, layers=layers, kernels=True,
                          dtype=torch.bfloat16, seed=0, device=dev,
                          quantize=quantize)
    if on_card:
        torch.cuda.synchronize()
    print(f"serve: {cfg.name} d_model={cfg.d_model} layers={cfg.n_layers} "
          f"bf16 activations, {weights} weights, made in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    kw = dict(slots=SERVE["slots"], prefill_len=SERVE["prefill_len"],
              max_seq=SERVE["prefill_len"] + SERVE["max_new"])
    serve(lm, requests=1, max_new=2, **kw)  # warm-up: cuBLAS, allocator
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels = {"nm_spmm": kernel.KERNEL, "nm_spmm_q": kernel.KERNEL_Q,
               "nm_spmm_decode": decode_kernel.KERNEL,
               "nm_spmm_decode_q": decode_kernel.KERNEL_Q}
    registry.clear_history()
    for kern in kernels.values():
        kern.launches = 0
    eng, done, dt = serve(lm, requests=SERVE["requests"],
                          max_new=SERVE["max_new"], **kw)
    launches = {name: kern.launches for name, kern in kernels.items()}
    counts = registry.dispatch_counts()
    if len(done) != SERVE["requests"] or any(
            len(r.out) != SERVE["max_new"] for r in done):
        fail(f"serve {weights}: {len(done)} of {SERVE['requests']} "
             "requests finished")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.out):
        fail(f"serve {weights}: a token outside the vocabulary")
    wrong = {k: v for k, v in counts.items() if k[1] not in served}
    idle = [name for name in served if launches[name] == 0]
    stray = {name: v for name, v in launches.items()
             if name not in served and v}
    if wrong or stray or (on_card and idle):
        fail(f"serve {weights}: dispatches outside {sorted(served)}: "
             f"{wrong}; launches {launches}")
    stats = eng.throughput_stats()
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
            if on_card else "not measured")
    print(f"serve {weights}: {stats['requests']} requests, {stats['tokens']} "
          f"tokens in {dt:.4f}s = {stats['tokens'] / dt:.3f} tok/s; TTFT "
          f"mean {stats['ttft_s'] * 1e3:.3f} ms p50 "
          f"{stats['ttft_p50_s'] * 1e3:.3f} ms; ITL p50 "
          f"{stats['itl_p50_s'] * 1e3:.3f} ms p99 "
          f"{stats['itl_p99_s'] * 1e3:.3f} ms; decode steps "
          f"{stats['decode_steps']}; max_memory_allocated {peak}", flush=True)
    print(f"serve {weights}: dispatch counts "
          + ", ".join(f"{op}/{impl}/{be}={v}"
                      for (op, impl, be), v in sorted(counts.items()))
          + f"; launches {launches} (wrapper calls; each decode call runs "
          "its main kernel and its split-K finishing kernel)", flush=True)
    return launches, counts


def family_totals(counts) -> tuple:
    """(prefill, decode) dispatches of a serve, whatever the family."""
    pre = sum(v for k, v in counts.items() if "decode" not in k[0])
    dec = sum(v for k, v in counts.items() if "decode" in k[0])
    return pre, dec


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    port()
    from repro_torch.core.dots import strict_f32
    from repro_torch.kernels import build

    strict_f32()
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    try:
        built = build.build_all()
    except RuntimeError as e:
        fail(str(e))
    print(f"build: {sorted(build.SOURCES)} ready in "
          f"{time.perf_counter() - t0:.1f}s (compiled now: {sorted(built)})",
          flush=True)
    for name, log in sorted(built.items()):
        print(f"build: {name}: {ptxas_summary(log)}", flush=True)

    worst, report = kernel_phase(dev)
    reference_phase(dev)
    reference_phase(dev, quantize="int8")
    launches, counts = serve_phase(dev)
    gc.collect()  # the bf16 model is freed before the int8 one is made
    torch.cuda.empty_cache()
    launches_q, counts_q = serve_phase(dev, quantize="int8")
    if family_totals(counts_q) != family_totals(counts):
        fail(f"serve int8: (prefill, decode) dispatches "
             f"{family_totals(counts_q)} differ from the bf16 serve's "
             f"{family_totals(counts)}")
    launches.update({k: launches_q[k] for k in KERNELS if k.endswith("_q")})

    src = "src/repro_torch/kernels/indexmac/csrc/"
    rows = [
        dict(name="nm_spmm", route="cuda", source=src + "nm_spmm.cu",
             replaces="src/repro/kernels/indexmac/kernel.py:217"),
        dict(name="nm_spmm_decode", route="cuda",
             source=src + "nm_spmm_decode.cu",
             replaces="src/repro/kernels/indexmac/decode_kernel.py:202"),
        dict(name="nm_spmm_q", route="cuda", source=src + "nm_spmm_q.cu",
             replaces="src/repro/kernels/indexmac/kernel.py:155"),
        dict(name="nm_spmm_decode_q", route="cuda",
             source=src + "nm_spmm_decode_q.cu",
             replaces="src/repro/kernels/indexmac/decode_kernel.py:202"),
    ]
    for r in rows:
        r.update(launches=launches[r["name"]], max_abs_err=worst[r["name"]],
                 **report[r["name"]])
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
