"""Where the time of a decode step goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        [--layers 48] [--steps 4] [--device cuda] [--quantize int8] \\
        [--masked]

Builds full-width yi-9b (random 2:4 weights, bf16 or, with ``--quantize
int8``, int8 with per-output-channel scales; the CUDA kernels),
fills every slot, and times ``--steps`` decode-only engine steps twice:
once with host clocks around each step (ending in the step's own device
sync), once under ``torch.profiler`` for the device time of every
kernel. Prints the step time, the device busy time per step and its
share of the step, the decode GEMM kernels' launches and card time per
step (``nm_spmm_decode{,_q}``: one launch a projection call), and the
top operators by host time and device time.

``--masked`` takes chip_smoke.py's masked serve cell instead (every
block with ``MaskSpec("local", block=64, window=192)``, 2 slots, prefill
1024) and first profiles one full prefill the same way.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch.core.dots import strict_f32
from repro_torch.kernels.blocksparse_attn.mask import MaskSpec
from repro_torch.launch.serve import build_model
from repro_torch.models.cache import CacheView
from repro_torch.serving.engine import Request, ServeEngine

SLOTS, PREFILL_LEN = 4, 128  # chip_smoke.py's serve cell
MASKED = (2, 1024, MaskSpec("local", block=64, window=192))  # masked cell
ROWS = 30  # operators listed per table


def _device_us(evt) -> float:
    """Device time of a kernel (or memcpy/memset) entry; 0 for host ops,
    whose kernels are entries of their own."""
    if "CUDA" not in str(evt.device_type):
        return 0.0
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def _top_device(avg, per: int) -> None:
    rows = sorted(avg, key=_device_us, reverse=True)[:ROWS]
    for e in rows:
        print(f"  {_device_us(e) / 1e3 / per:9.4f}  x{e.count // per:<5d} "
              f"{e.key[:90]}")


def _profile_prefill(lm, toks, max_seq: int, acts) -> None:
    """Host clock around one synchronised prefill, then one under the
    profiler: device busy time and the kernels that take it."""
    def prefill():
        with torch.inference_mode():
            lm(toks, view=CacheView.prefill(),
               caches=lm.init_cache(toks.shape[0], max_seq))
        if lm.device.type == "cuda":
            torch.cuda.synchronize()

    prefill()  # warm-up
    t0 = time.perf_counter()
    prefill()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=acts) as prof:
        prefill()
    avg = prof.key_averages()
    device_ms = sum(_device_us(e) for e in avg) / 1e3
    print(f"prefill {tuple(toks.shape)}: {wall_ms:.3f} ms wall "
          f"(unprofiled); under the profiler: device busy {device_ms:.3f} ms"
          f" = {100 * device_ms / wall_ms:.1f}% of the unprofiled prefill")
    print("top device time of the prefill (ms):")
    _top_device(avg, 1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quantize", choices=["int8"], default=None)
    ap.add_argument("--masked", action="store_true",
                    help="the masked serve cell (local mask, 2 slots, "
                         "prefill 1024); profiles one prefill first")
    args = ap.parse_args()

    strict_f32()
    slots, prefill_len, mask = (MASKED if args.masked
                                else (SLOTS, PREFILL_LEN, None))
    cfg, lm = build_model("yi-9b", full=True, layers=args.layers,
                          kernels=True, dtype=torch.bfloat16,
                          device=args.device, quantize=args.quantize,
                          mask=mask)
    max_seq = prefill_len + 4 * args.steps + 8
    acts = [torch.profiler.ProfilerActivity.CPU]
    if lm.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    rng = np.random.default_rng(0)
    if args.masked:
        _profile_prefill(lm, torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (slots, prefill_len)), device=lm.device),
            max_seq, acts)
    eng = ServeEngine(lm, slots=slots, prefill_len=prefill_len,
                      max_seq=max_seq)
    for i in range(slots):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, prefill_len).astype(np.int32),
            max_new=4 * args.steps + 4))
    eng.step()  # prefill every slot + the first decode
    eng.step()  # warm-up decode

    wall = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        eng.step()  # decode only; ends in the step's device sync
        wall.append(time.perf_counter() - t0)
    step_ms = statistics.median(wall) * 1e3

    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            eng.step()
    avg = prof.key_averages()
    device_ms = sum(_device_us(e) for e in avg) / 1e3 / args.steps
    host_ms = sum(e.self_cpu_time_total for e in avg) / 1e3 / args.steps
    where = (torch.cuda.get_device_name(0) if lm.device.type == "cuda"
             else "cpu")
    masked = f", {mask.tag}" if mask is not None else ""
    print(f"{cfg.name} layers={cfg.n_layers} slots={slots} bf16 "
          f"activations, {args.quantize or 'bf16'} weights{masked} on "
          f"{where}")
    print(f"decode step: {step_ms:.3f} ms wall (median of {args.steps}, "
          f"unprofiled); under the profiler: device busy {device_ms:.3f} "
          f"ms/step = {100 * device_ms / step_ms:.1f}% of the unprofiled "
          f"step, host op time {host_ms:.3f} ms/step")
    launch = [e for e in avg if e.key == "cudaLaunchKernel"]
    launches = sum(e.count for e in launch) / args.steps
    launch_ms = sum(e.self_cpu_time_total for e in launch) / 1e3 / args.steps
    decode = [e for e in avg if _device_us(e) > 0
              and "nm_spmm_decode_kernel" in e.key]
    dec_n = sum(e.count for e in decode) / args.steps
    dec_ms = sum(_device_us(e) for e in decode) / 1e3 / args.steps
    print(f"kernel launches per step: {launches:.0f} (cudaLaunchKernel, "
          f"{launch_ms:.3f} ms of host time); the decode GEMM kernels "
          f"(nm_spmm_decode{'_q' if args.quantize else ''}): {dec_n:.0f} "
          f"launches, {dec_ms:.3f} ms of card time per step "
          f"({100 * dec_ms / max(device_ms, 1e-9):.1f}% of device busy)")
    print(avg.table(sort_by="self_cpu_time_total", row_limit=ROWS))
    print("top device time per step (ms):")
    _top_device(avg, args.steps)


if __name__ == "__main__":
    main()
