"""The decode kernels' launch geometry on the card: the host rule's plan
against the others it could take.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode_plan \\
        [--rows 4] [--shapes wq/wo,wk/wv,w_up/w_gate,w_down] [--scan]

For each full-width yi-9b projection named (random 2:4 weights from seed
0, bf16 x of ``--rows`` rows), times ``nm_spmm_decode`` (bf16 values) and
``nm_spmm_decode_q`` (int8 values, ``quantize_nm`` of the same weights)
at the host rule's launch (``padding.decode_plan``) and at every tile
width and split count around it (the wrappers' ``plan``), each checked
against the plain version; beside them ``torch.matmul`` of x and the
dense bf16 weight. Times are the median of 20 calls, each after a 1 GiB
write that flushes the L2, as ``chip_smoke.py`` times kernels.

``--scan`` instead times both kernels at the host rule's launch and
``torch.matmul`` at N = 11008 and 4096 over K = 1024 .. 8192: the slope
over K is the rate at which a call streams its bytes, the intercept its
fixed cost. Each after the 1 GiB write, which leaves the L2 full of
dirty lines that the call's reads must write back first, and after a
1 GiB read, which leaves it clean. Needs a CUDA device.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.dots import strict_f32
from repro_torch.core.nmweight import NMWeight
from repro_torch.core.sparsity import (
    NMConfig,
    apply_mask,
    compress_nm,
    decompress_nm,
    prune_mask_nm,
)
from repro_torch.kernels.indexmac import decode_kernel as dk
from repro_torch.kernels.padding import (
    DECODE_K_ROWS,
    DECODE_LANES,
    decode_plan,
    decode_vec,
    sm_count,
)
from repro_torch.launch.profile_gather import time_ms
from repro_torch.quant import quantize_nm

SHAPES = {  # projection -> (K, N) of full-width yi-9b
    "wq/wo": (4096, 4096),
    "wk/wv": (4096, 512),
    "w_up/w_gate": (4096, 11008),
    "w_down": (11008, 4096),
}
SPLITS = (4, 6, 8, 12, 16, 17, 24, 32)  # split counts tried, where K allows
SCAN_N, SCAN_K = (11008, 4096), (1024, 2048, 4096, 8192)


def scan(dev, cfg, gen, flush, m: int) -> None:
    """Kernel and torch.matmul times over K at fixed N, after a dirty and
    after a clean L2 flush."""
    words = flush.view(torch.int32)

    def clean_flush():  # a 1 GiB read leaves the L2 clean
        words.sum()

    print("scan: N K MB(bf16 vals+idx) | dirty flush: bf16 int8 matmul | "
          "clean flush: bf16 int8 matmul (ms)", flush=True)
    for n in SCAN_N:
        for k in SCAN_K:
            w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
            vals, idx = compress_nm(apply_mask(w, prune_mask_nm(w, cfg)),
                                    cfg)
            q = quantize_nm(NMWeight(vals, idx, cfg))
            dense = decompress_nm(vals, idx, cfg).bfloat16()
            vb = vals.bfloat16()
            x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
            runs = (lambda: dk.nm_spmm_decode(x, vb, idx, None, cfg),
                    lambda: dk.nm_spmm_decode_q(x, q.vals, idx, q.scales,
                                                None, cfg),
                    lambda: torch.matmul(x, dense))
            cells = []
            for fl in (flush.zero_, clean_flush):
                cells.append(" ".join(f"{time_ms(r, _Flush(fl)):.5f}"
                                      for r in runs))
            print(f"scan: {n} {k} {vb.numel() * 3 / 1e6:.1f} | "
                  + " | ".join(cells), flush=True)
            del w, vals, idx, q, dense, vb


class _Flush:
    """``time_ms``'s flush: ``zero_()`` runs the given flush."""

    def __init__(self, fn):
        self.zero_ = fn


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--scan", action="store_true",
                    help="time over K at fixed N, dirty and clean L2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode_plan needs a CUDA device")
    strict_f32()
    dev = torch.device("cuda")
    cfg = NMConfig(2, 4)
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sms = sm_count(dev.index or 0)
    m = args.rows
    if args.scan:
        print(f"device: {torch.cuda.get_device_name(0)}; {cfg.tag}, bf16 x "
              f"of {m} rows; median of 20", flush=True)
        scan(dev, cfg, gen, flush, m)
        return
    print(f"device: {torch.cuda.get_device_name(0)}; {cfg.tag}, bf16 x of "
          f"{m} rows; ms, median of 20 after an L2 flush; cells are columns "
          f"a CTA x splits (CTAs), * the host rule's", flush=True)
    for name in args.shapes.split(","):
        k, n = SHAPES[name]
        w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
        vals, idx = compress_nm(apply_mask(w, prune_mask_nm(w, cfg)), cfg)
        q = quantize_nm(NMWeight(vals, idx, cfg))
        dense = decompress_nm(vals, idx, cfg).bfloat16()
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        vb = vals.bfloat16()
        mm = time_ms(lambda: torch.matmul(x, dense), flush)
        print(f"{name} (K {k} N {n}): torch.matmul {mm:.5f}", flush=True)
        for label, itemsize, run, plain in (
                ("bf16", 2,
                 lambda p: dk.nm_spmm_decode(x, vb, idx, None, cfg, plan=p),
                 dk.nm_spmm_decode_plain(x, vb, idx, None, cfg, None)),
                ("int8", 1,
                 lambda p: dk.nm_spmm_decode_q(x, q.vals, idx, q.scales, None,
                                               cfg, plan=p),
                 dk.nm_spmm_decode_q_plain(x, q.vals, idx, q.scales, None,
                                           cfg, None))):
            rule = decode_plan(m, k, n, cfg, itemsize, sms)
            want = plain.float()
            for lanes in DECODE_LANES:
                cols = lanes * decode_vec(itemsize)
                cells = []
                for s in SPLITS:
                    per = -(-(k // cfg.m) // s)
                    if per * cfg.m > DECODE_K_ROWS:
                        continue
                    p = decode_plan(m, k, n, cfg, itemsize, sms, cols=cols,
                                    per=per)
                    got = run(p).float()
                    if not torch.allclose(got, want, rtol=1e-2, atol=1e-2):
                        raise SystemExit(f"{name} {label} {cols}x{p.splits}: "
                                         f"max|diff| "
                                         f"{float((got - want).abs().max())}")
                    mark = "*" if p == rule else ""
                    cells.append(f"{cols}x{p.splits}{mark} ({p.ctas}) "
                                 f"{time_ms(lambda: run(p), flush):.5f}")
                print(f"  {label} {cols} columns: " + "; ".join(cells),
                      flush=True)
            print(f"  {label} rule {rule.cols}x{rule.splits} ({rule.ctas} "
                  f"CTAs): {time_ms(lambda: run(rule), flush):.5f}",
                  flush=True)


if __name__ == "__main__":
    main()
