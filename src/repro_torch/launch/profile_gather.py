"""Where the time of the gather kernel goes, on the card: its launch
geometry against the others it could take.

    PYTHONPATH=src python -m repro_torch.launch.profile_gather \\
        [--pattern 2:4] [--layers s2b1_3x3,s4b1_3x3,...] [--dtype f32]

For each ResNet-50 layer GEMM named (batch 1, the paper's orientation
C[C_out, H*W] = A_sp[C_out, K] @ B[K, H*W], random A pruned to the
pattern and random B from seed 0), times the float kernel
(``indexmac_gather``) at the host rule's launch (``padding.gather_plan``)
and at every tile and split depth (K steps a split) around it (the
wrapper's ``plan``), each checked against the plain version; beside them ``torch.matmul`` of the
dense f32 A and B (TF32 off) and a launch of one K step (the first
``k_rows`` rows of K, the same Mr and Nc), the fixed cost that every
call pays. Times are the median of 20 calls, each after a 1 GiB write
that flushes the L2, as ``chip_smoke.py`` times kernels. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import statistics

import torch

from repro_torch.configs import get_cnn_config
from repro_torch.core.dots import strict_f32
from repro_torch.core.sparsity import (
    NMConfig,
    apply_mask,
    compress_nm,
    decompress_nm,
    prune_mask_nm,
)
from repro_torch.kernels.indexmac_gather import kernel as gk
from repro_torch.kernels.padding import GATHER_TILES, gather_plan, sm_count
from repro_torch.models.conv import cnn_layer_gemms

LAYERS = "conv1,s2b1_3x3,s3b1_3x3,s4b1_3x3,s5b1_3x3,s5b1_1x1b,s4b2_1x1a"
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def time_ms(fn, flush, iters: int = 20) -> float:
    """Median ms of one call, the L2 flushed before each."""
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pattern", default="2:4")
    ap.add_argument("--layers", default=LAYERS)
    ap.add_argument("--dtype", choices=list(DTYPES), default="f32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_gather needs a CUDA device")
    strict_f32()
    dev = torch.device("cuda")
    cfg = NMConfig(*map(int, args.pattern.split(":")))
    dtype = DTYPES[args.dtype]
    gemms = {name: (m, k, n) for name, m, k, n in
             cnn_layer_gemms(get_cnn_config("resnet50"))}
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sms = sm_count(dev.index or 0)
    print(f"device: {torch.cuda.get_device_name(0)}; {cfg.tag}, B and vals "
          f"in {args.dtype}; ms, median of 20 after an L2 flush", flush=True)
    for name in args.layers.split(","):
        mr, k, nc = gemms[name]
        k = -(-k // cfg.m) * cfg.m
        a = torch.randn(mr, k, generator=gen, device=dev) * k ** -0.5
        vals, idx = compress_nm(apply_mask(a, prune_mask_nm(a, cfg, axis=1)),
                                cfg, axis=1)
        b = torch.randn(k, nc, generator=gen, device=dev)
        a_dense = decompress_nm(vals, idx, cfg, axis=1)
        vals, b = vals.to(dtype), b.to(dtype)
        want = gk.indexmac_gather_plain(vals, idx, b, cfg).float()
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        plan = gather_plan(mr, k, nc, cfg, dtype, dtype, sms)
        mm = time_ms(lambda: torch.matmul(a_dense, b.float()), flush)
        kc1 = plan.k_rows // cfg.m * cfg.n  # one K step's kept values
        v1, i1 = vals[:, :kc1].contiguous(), idx[:, :kc1].contiguous()
        one = time_ms(lambda: gk.indexmac_gather(v1, i1, b[:plan.k_rows],
                                                 cfg), flush)
        print(f"{name} (Mr {mr} K {k} Nc {nc}): rule tile {plan.tile}, "
              f"{plan.splits} splits of {plan.per} steps, {plan.blocks} "
              f"CTAs; torch.matmul {mm:.5f}; one K step {one:.5f}",
              flush=True)
        for tile in GATHER_TILES:
            cells = []
            for per in sorted({1, 2, 3, 4, 6, 8, 12, plan.per, plan.steps}):
                if per > plan.steps:
                    continue
                p = gather_plan(mr, k, nc, cfg, dtype, dtype, sms,
                                tile=tile, per=per)
                got = gk.indexmac_gather(vals, idx, b, cfg, plan=p).float()
                if not torch.allclose(got, want, rtol=tol, atol=tol):
                    raise SystemExit(f"{name} {tile} per {per}: max|diff| "
                                     f"{float((got - want).abs().max())}")
                mark = "*" if (tile, per) == (plan.tile, plan.per) else ""
                ms = time_ms(lambda: gk.indexmac_gather(vals, idx, b, cfg,
                                                        plan=p), flush)
                cells.append(f"{per}x{p.splits}{mark} {ms:.5f}")
            print(f"  tile {tile}: " + "; ".join(cells), flush=True)


if __name__ == "__main__":
    main()
