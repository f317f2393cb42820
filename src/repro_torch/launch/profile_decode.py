"""Where the time of a decode step goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        [--layers 48] [--steps 4] [--device cuda] [--quantize int8]

Builds full-width yi-9b (random 2:4 weights, bf16 or, with ``--quantize
int8``, int8 with per-output-channel scales; the CUDA kernels),
fills every slot, and times ``--steps`` decode-only engine steps twice:
once with host clocks around each step (ending in the step's own device
sync), once under ``torch.profiler`` for the device time of every
kernel. Prints the step time, the device busy time per step and its
share of the step, and the top operators by host time and device time.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch.core.dots import strict_f32
from repro_torch.launch.serve import build_model
from repro_torch.serving.engine import Request, ServeEngine

SLOTS, PREFILL_LEN = 4, 128  # chip_smoke.py's serve cell
ROWS = 30  # operators listed per table


def _device_us(evt) -> float:
    """Device time of a kernel (or memcpy/memset) entry; 0 for host ops,
    whose kernels are entries of their own."""
    if "CUDA" not in str(evt.device_type):
        return 0.0
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quantize", choices=["int8"], default=None)
    args = ap.parse_args()

    strict_f32()
    cfg, lm = build_model("yi-9b", full=True, layers=args.layers,
                          kernels=True, dtype=torch.bfloat16,
                          device=args.device, quantize=args.quantize)
    eng = ServeEngine(lm, slots=SLOTS, prefill_len=PREFILL_LEN,
                      max_seq=PREFILL_LEN + 4 * args.steps + 8)
    rng = np.random.default_rng(0)
    for i in range(SLOTS):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, PREFILL_LEN).astype(np.int32),
            max_new=4 * args.steps + 4))
    eng.step()  # prefill every slot + the first decode
    eng.step()  # warm-up decode

    wall = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        eng.step()  # decode only; ends in the step's device sync
        wall.append(time.perf_counter() - t0)
    step_ms = statistics.median(wall) * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU]
    if lm.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            eng.step()
    avg = prof.key_averages()
    device_ms = sum(_device_us(e) for e in avg) / 1e3 / args.steps
    host_ms = sum(e.self_cpu_time_total for e in avg) / 1e3 / args.steps
    where = (torch.cuda.get_device_name(0) if lm.device.type == "cuda"
             else "cpu")
    print(f"{cfg.name} layers={cfg.n_layers} slots={SLOTS} bf16 "
          f"activations, {args.quantize or 'bf16'} weights on {where}")
    print(f"decode step: {step_ms:.3f} ms wall (median of {args.steps}, "
          f"unprofiled); under the profiler: device busy {device_ms:.3f} "
          f"ms/step = {100 * device_ms / step_ms:.1f}% of the unprofiled "
          f"step, host op time {host_ms:.3f} ms/step")
    launch = [e for e in avg if e.key == "cudaLaunchKernel"]
    launches = sum(e.count for e in launch) / args.steps
    launch_ms = sum(e.self_cpu_time_total for e in launch) / 1e3 / args.steps
    finish = sum(e.count for e in avg if _device_us(e) > 0
                 and "nm_spmm_decode_finish" in e.key) / args.steps
    print(f"kernel launches per step: {launches:.0f} (cudaLaunchKernel, "
          f"{launch_ms:.3f} ms of host time); nm_spmm_decode's finishing "
          f"pass: {finish:.0f} ({100 * finish / max(launches, 1):.1f}%)")
    print(avg.table(sort_by="self_cpu_time_total", row_limit=ROWS))
    rows = sorted(avg, key=_device_us, reverse=True)[:ROWS]
    print("top device time per step (ms):")
    for e in rows:
        print(f"  {_device_us(e) / 1e3 / args.steps:9.4f}  x{e.count // args.steps:<5d} "
              f"{e.key[:90]}")


if __name__ == "__main__":
    main()
