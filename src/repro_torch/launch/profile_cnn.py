"""Where the time of a CNN forward goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_cnn \\
        [--arch resnet50|densenet121] [--batch 8] [--iters 4] \\
        [--quantize int8] [--device cuda] [--reduced] [--eager]

Builds the full-width CNN (224x224; ``--reduced`` for the CPU-sized
one) with random 2:4 conv weights from seed 0, f32 or, with
``--quantize int8``, int8 with per-output-channel scales, every
compressed conv on the CUDA kernels (policy "auto"), and times
``--iters`` forwards of one batch twice: with host clocks around each
(ending in a device sync), then under ``torch.profiler`` for the device
time of every kernel. On the card the forward is the CUDA graph of
``SparseCNN.graphed`` (captured at the warm-up, then replayed);
``--eager`` runs ``forward`` eagerly. Prints the forward time, the
device busy time per forward and its share, the kernels and launch calls
per forward, the dispatches of the compressed-GEMM families (a graph's
recorded ones times its replays), and the top operators by device time.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import statistics
import time

import torch

from repro_torch.configs import CNN_ARCHS, get_cnn_config, get_cnn_reduced
from repro_torch.core.dots import strict_f32
from repro_torch.kernels import registry
from repro_torch.launch.profile_decode import ROWS, _device_us
from repro_torch.models.common import resolve_device
from repro_torch.models.conv import SparseCNN


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(CNN_ARCHS), default="resnet50")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--quantize", choices=["int8"], default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU-sized config instead of the full one")
    ap.add_argument("--eager", action="store_true",
                    help="run forward eagerly, not the captured graph")
    args = ap.parse_args()

    strict_f32()
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    cfg = (get_cnn_reduced if args.reduced else get_cnn_config)(args.arch)
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, use_kernel=True))
    model = SparseCNN.init(cfg, seed=0, device=dev, quantize=args.quantize)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn(args.batch, cfg.input_hw, cfg.input_hw, 3, generator=gen,
                    device=dev)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    fwd = model if args.eager else model.graphed
    with torch.inference_mode():
        fwd(x)  # warm-up: cuBLAS, allocator; the capture of the graph
        sync()
        registry.clear_history()
        recs = model.graphs_captured()
        before = [r.replays for r in recs]
        wall = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            logits = fwd(x)
            sync()
            wall.append(time.perf_counter() - t0)
        # what ran: the eager dispatches, and each graph's recorded ones
        # once a replay of this window (the registry does not count those)
        counts = collections.Counter(registry.dispatch_counts())
        for r, b in zip(recs, before):
            for k, v in r.dispatches.items():
                counts[k] += v * (r.replays - b)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.iters):
                fwd(x)
            sync()
    fwd_ms = statistics.median(wall) * 1e3
    avg = prof.key_averages()
    device_ms = sum(_device_us(e) for e in avg) / 1e3 / args.iters
    where = torch.cuda.get_device_name(0) if on_card else "cpu"
    mode = "eager" if args.eager or not on_card else "graphed"
    print(f"{cfg.name} batch {args.batch} at {cfg.input_hw}x{cfg.input_hw}, "
          f"{args.quantize or 'f32'} conv weights on {where}, {mode}: "
          f"logits {tuple(logits.shape)}")
    print(f"forward: {fwd_ms:.4f} ms wall (median of {args.iters}, "
          f"unprofiled) = {args.batch / fwd_ms * 1e3:.3f} images/s; under "
          f"the profiler: device busy {device_ms:.4f} ms/forward = "
          f"{100 * device_ms / fwd_ms:.1f}% of the unprofiled forward")
    launches = sum(e.count for e in avg if e.key == "cudaLaunchKernel")
    graph_launches = sum(e.count for e in avg if e.key == "cudaGraphLaunch")
    kernels = sum(e.count for e in avg if _device_us(e) > 0)
    print(f"kernels run per forward: {kernels / args.iters:.0f}; launch "
          f"calls per forward: cudaLaunchKernel "
          f"{launches / args.iters:.0f}, cudaGraphLaunch "
          f"{graph_launches / args.iters:.0f}; "
          "dispatches per forward: " + ", ".join(
              f"{op}/{impl}/{be}={v // args.iters}"
              for (op, impl, be), v in sorted(counts.items())))
    rows = sorted(avg, key=_device_us, reverse=True)[:ROWS]
    print("top device time per forward (ms):")
    for e in rows:
        if _device_us(e) > 0:
            print(f"  {_device_us(e) / 1e3 / args.iters:9.4f}  "
                  f"x{e.count // args.iters:<5d} {e.key[:90]}")


if __name__ == "__main__":
    main()
