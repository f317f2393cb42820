"""Serving entry point of the port: a few requests through ``ServeEngine``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --full \\
      --kernels --device cuda

``--full`` serves the full-width config (random weights from seed 0,
made on the device, pruned to 2:4 and compressed layer by layer) instead
of the reduced one; ``--layers L`` cuts the depth to L layers;
``--kernels`` routes every compressed GEMM through the hand-written
kernels (policy "auto"; without it the policy is "off" and the plain
reference runs). ``--quantize int8`` stores the compressed weights as
int8 with per-output-channel scales, quantized from their f32 values as
they are made, and serves them through the int8 kernels:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --dtype f32 --kernels --quantize int8 --prefill-len 8 --max-new 4
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.core.dots import strict_f32
from repro_torch.models.common import resolve_device
from repro_torch.models.transformer import LM
from repro_torch.serving.engine import Request, ServeEngine

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def build_model(arch: str, *, full: bool, layers=None, kernels: bool,
                dtype=torch.bfloat16, seed: int = 0, device="cuda",
                quantize=None):
    """The served config (cut to ``layers`` when given) and its model;
    ``quantize="int8"`` makes its compressed weights int8."""
    cfg = get_config(arch) if full else get_reduced(arch)
    if layers is not None:
        (blk, _), = cfg.plan
        cfg = dataclasses.replace(cfg, plan=((blk, layers),))
    if cfg.sparsity is not None:
        cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
            cfg.sparsity, use_kernel=kernels))
    elif kernels:
        raise SystemExit(f"--kernels: {arch} has no compressed GEMMs")
    return cfg, LM.init(cfg, seed=seed, dtype=dtype, device=device,
                        quantize=quantize)


def serve(lm: LM, *, requests: int, slots: int, prefill_len: int,
          max_new: int, max_seq: int, temperature: float = 0.0,
          seed: int = 0):
    """Serve ``requests`` random prompts; returns (engine, done, seconds)."""
    eng = ServeEngine(lm, slots=slots, max_seq=max_seq,
                      prefill_len=prefill_len, temperature=temperature,
                      seed=seed)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for i in range(requests):
        eng.submit(Request(
            rid=i, prompt=rng.integers(0, lm.cfg.vocab_size,
                                       size=prefill_len).astype(np.int32),
            max_new=max_new))
    done = eng.run()
    return eng, done, time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), default="yi-9b")
    ap.add_argument("--full", action="store_true",
                    help="full-width config instead of the reduced one")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--kernels", action="store_true",
                    help="route compressed GEMMs through the CUDA kernels")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=list(DTYPES), default="bf16")
    ap.add_argument("--quantize", choices=["int8"], default=None,
                    help="int8-quantize the compressed weights at load "
                         "(per-output-channel absmax scales)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prefill-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=None,
                    help="cache length (default prefill-len + max-new)")
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args()

    dev = resolve_device(args.device)
    strict_f32()
    cfg, lm = build_model(args.arch, full=args.full, layers=args.layers,
                          kernels=args.kernels, dtype=DTYPES[args.dtype],
                          device=dev, quantize=args.quantize)
    eng, done, dt = serve(
        lm, requests=args.requests, slots=args.slots,
        prefill_len=args.prefill_len, max_new=args.max_new,
        max_seq=args.max_seq or args.prefill_len + args.max_new,
        temperature=args.temperature)
    stats = eng.throughput_stats()
    toks = stats["tokens"]
    weights = "int8 weights" if args.quantize else f"{args.dtype} weights"
    print(f"{cfg.name} ({cfg.n_layers} layers, {args.dtype} activations, "
          f"{weights}) on {dev}: "
          f"served {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, slots={args.slots}, "
          f"ttft={stats['ttft_s'] * 1e3:.0f}ms, "
          f"itl p50={stats['itl_p50_s'] * 1e3:.1f}ms "
          f"p99={stats['itl_p99_s'] * 1e3:.1f}ms)")
    for r in done[:3]:
        print(f"  rid={r.rid} out[:8]={r.out[:8]}")
    if len(done) != args.requests:
        raise SystemExit(f"only {len(done)} of {args.requests} finished")


if __name__ == "__main__":
    main()
