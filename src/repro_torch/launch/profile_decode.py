"""Where the time of a decode step goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        [--arch yi-9b] [--layers 48] [--steps 4] [--device cuda] \\
        [--quantize int8] [--masked] [--eager]

Builds full-width ``--arch`` (yi-9b, chameleon-34b, codeqwen1.5-7b,
internlm2-20b; gemma3-27b, whose ITL floor counts the tied head's
table; deepseek-v2-lite-16b: MLA and
64 experts a layer; rwkv6-3b: RWKV-6; jamba-v0.1-52b, which fits one
card only cut, ``--layers 8`` one period; whisper-medium is served
through ``make_serve_steps`` and is refused here; its full depth unless
``--layers`` cuts it; random
2:4 weights, bf16 or, with ``--quantize int8``, int8 with
per-output-channel scales; the CUDA kernels),
fills every slot, and times ``--steps`` decode-only engine steps twice:
once with host clocks around each step (ending in the step's own device
sync), once under ``torch.profiler`` for the device time of every
kernel. Prints the step time, the device busy time per step and its
share of the step, the kernels run per step and the host calls that
launched them, the decode GEMM kernels' launches and card time per step
(``nm_spmm_decode{,_q}``: one launch a projection call, also by kernel
instantiation, whose rows tell deepseek's routed experts, at M =
capacity = 8, from the projections at M = slots), and the top operators
by host time and device time.

The engine's steps are captured as CUDA graphs and replayed, as in
serving (the first decode step captures, the warm-up step replays);
``--eager`` runs them eagerly instead. With graphs it also prints the
card time of one decode-graph replay (CUDA events around it alone).

``--paged`` takes the geometry of chip_smoke.py's paged serve cell (4
slots, prefill 128 in chunks of 64, pages of 32 tokens) with a pool
that holds every slot, so no profiled step preempts.

A model with recurrent layers (Mamba, RWKV) first gets one eager
prefill and one eager decode step under the profiler: the card time of
its scans (the ``mamba.scan`` / ``rwkv.wkv`` ranges: the loop over time
of the selective scan and of the WKV recurrence) and their share of the
device busy time; the ITL floor adds the recurrent state the step reads
and writes.

``--masked`` takes chip_smoke.py's masked serve cell instead (every
block with ``MaskSpec("local", block=64, window=192)``, 2 slots, prefill
1024) and first profiles one full prefill the same way (eagerly, the
head at the last position only, as a serving step runs it).
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.core.cost_model import HBM_BYTES_PER_S
from repro_torch.core.dots import strict_f32
from repro_torch.kernels.blocksparse_attn.mask import MaskSpec
from repro_torch.launch.serve import build_model
from repro_torch.models.cache import CacheView
from repro_torch.serving.engine import Request, ServeEngine

SLOTS, PREFILL_LEN = 4, 128  # chip_smoke.py's serve cell
PAGED = dict(prefill_chunk=64, paged=True, page_size=32)  # its paged cell
MASKED = (2, 1024, MaskSpec("local", block=64, window=192))  # masked cell
ROWS = 30  # operators listed per table


def state_bytes(lm, slots: int) -> int:
    """Bytes of the recurrent state (Mamba's conv and ssm, RWKV's wkv and
    token shifts) of ``slots`` slots: what a decode step reads, and
    writes again."""
    from repro_torch.configs.base import AttnConfig

    return sum(t.numel() * t.element_size() for layer in lm.layers
               if not isinstance(layer.block.mixer, AttnConfig)
               for t in layer.empty_cache(slots, 1, lm.dtype,
                                          "meta").values())


def cross_bytes(lm, slots: int) -> int:
    """Bytes of the cross-attention K/V of ``slots`` slots (an
    encoder-decoder's ``cross_k`` / ``cross_v``, encoder_seq frames a
    layer): what a decode step reads besides its weights."""
    from repro_torch.models.attention import cross_empty_cache

    return sum(t.numel() * t.element_size() for layer in lm.layers
               if layer.cross is not None
               for t in cross_empty_cache(slots, lm.cfg.encoder_seq,
                                          layer.block.mixer, lm.dtype,
                                          "meta").values())


def decode_weight_bytes(lm, tokens=None, slots=None) -> int:
    """Bytes of the weights a decode step reads: all but the embedding
    table (of which it reads B rows; a tied head reads all of it), the
    learned position table (B rows), an encoder's weights and the cross
    attention's wk / wv (they run at prefill only). Every expert's
    buffer runs padded,
    routed or not, so the step reads them all; with ``tokens`` (the
    step's), only the experts that many tokens can route to count (at
    most tokens x top_k distinct experts a MoE layer): the floor of a
    step that runs only its routed experts. With ``slots``, the
    recurrent state of that many slots is added twice (read, then
    written), and the cross-attention K/V of that many slots once."""
    from repro_torch.models.moe import MoE

    def tensors(mod):
        return [*mod.named_parameters(), *mod.named_buffers()]

    skip = ("pos.", "enc_") + (() if lm.cfg.tie_embeddings else ("embed.",))
    nbytes = sum(b.numel() * b.element_size()
                 for name, b in tensors(lm) if not name.startswith(skip)
                 and ".cross.wk." not in name and ".cross.wv." not in name)
    if slots:
        nbytes += 2 * state_bytes(lm, slots) + cross_bytes(lm, slots)
    if tokens is None:
        return nbytes
    for layer in lm.layers:
        if isinstance(layer.mlp, MoE):
            sizes = sorted((sum(b.numel() * b.element_size()
                                for _, b in tensors(ex))
                            for ex in layer.mlp.experts), reverse=True)
            unrouted = len(sizes) - min(len(sizes),
                                        tokens * layer.mlp.cfg.top_k)
            nbytes -= sum(sizes[:unrouted])
    return nbytes


SCANS = ("mamba.scan", "rwkv.wkv")  # the recurrent mixers' ranges


def _device_us(evt) -> float:
    """Device time of a kernel (or memcpy/memset) entry; 0 for host ops,
    whose kernels are entries of their own, and for the scans' ranges."""
    if "CUDA" not in str(evt.device_type) or evt.key in SCANS:
        return 0.0
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def scan_device_us(avg) -> float:
    """Card time of the kernels launched inside the scans' ranges (their
    host events' inclusive device time)."""
    return sum(float(getattr(e, "device_time_total",
                             getattr(e, "cuda_time_total", 0.0)))
               for e in avg if e.key in SCANS
               and "CUDA" not in str(e.device_type))


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
               caches=lm.init_cache(toks.shape[0], max_seq), last_only=True)
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


def _profile_scans(lm, toks, max_seq: int, acts) -> None:
    """One eager prefill of ``toks`` and one eager decode step, each
    under the profiler: device busy time, the scans' card time and their
    share of it."""
    caches = lm.init_cache(toks.shape[0], max_seq)
    cl = torch.full((toks.shape[0],), toks.shape[1])

    def prefill():
        return lm(toks, view=CacheView.prefill(), caches=caches,
                  last_only=True)[0]

    def decode():
        return lm(nxt, view=CacheView.decode(cl), caches=caches,
                  last_only=True)[0]

    with torch.inference_mode():
        nxt = prefill()[:, -1].argmax(-1, keepdim=True)  # warm-up
        decode()
        b, s = toks.shape
        for what, fn in ((f"prefill ({b}, {s})", prefill),
                         (f"decode step ({b}, 1)", decode)):
            if lm.device.type == "cuda":
                torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                fn()
                if lm.device.type == "cuda":
                    torch.cuda.synchronize()
            avg = prof.key_averages()
            busy = sum(_device_us(e) for e in avg) / 1e3
            scans = scan_device_us(avg) / 1e3
            print(f"scans, eager {what}: device busy {busy:.3f} ms, the "
                  f"scans' kernels "
                  f"{scans:.3f} ms = {100 * scans / max(busy, 1e-9):.1f}% of "
                  f"it ({', '.join(SCANS)} ranges)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), default="yi-9b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: the config's)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quantize", choices=["int8"], default=None)
    ap.add_argument("--masked", action="store_true",
                    help="the masked serve cell (local mask, 2 slots, "
                         "prefill 1024); profiles one prefill first")
    ap.add_argument("--paged", action="store_true",
                    help="the paged cell's geometry: prefill in chunks "
                         "of 64, pages of 32 tokens")
    ap.add_argument("--eager", action="store_true",
                    help="run the steps eagerly instead of replaying "
                         "captured CUDA graphs")
    args = ap.parse_args()
    if args.arch == "whisper-medium":
        raise SystemExit(
            "whisper-medium is an encoder-decoder, served through "
            "make_serve_steps, not ServeEngine: time its steps with "
            "python -m repro_torch.launch.serve --arch whisper-medium "
            "--full --kernels (chip_smoke.py's whisper serve phase "
            "times each graph's replay)")

    strict_f32()
    slots, prefill_len, mask = (MASKED if args.masked
                                else (SLOTS, PREFILL_LEN, None))
    cfg, lm = build_model(args.arch, full=True, layers=args.layers,
                          kernels=True, dtype=torch.bfloat16,
                          device=args.device, quantize=args.quantize,
                          mask=mask)
    max_seq = prefill_len + 4 * args.steps + 8
    paged = PAGED if args.paged else {}
    if paged:  # whole pages
        max_seq = -(-max_seq // PAGED["page_size"]) * PAGED["page_size"]
    acts = [torch.profiler.ProfilerActivity.CPU]
    if lm.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    rng = np.random.default_rng(0)
    if args.masked:
        _profile_prefill(lm, torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (slots, prefill_len)), device=lm.device),
            max_seq, acts)
    recurrent = state_bytes(lm, slots) > 0
    if recurrent:
        _profile_scans(lm, torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (slots, prefill_len)), device=lm.device),
            max_seq, acts)
    eng = ServeEngine(lm, slots=slots, prefill_len=prefill_len,
                      max_seq=max_seq, graphs=not args.eager, **paged)
    for i in range(slots):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, prefill_len).astype(np.int32),
            max_new=4 * args.steps + 4))
    while eng.queue or any(s.req is not None and s.pos < prefill_len
                           for s in eng.scheduler.slots):
        eng.step()  # prefill every slot; the first decode captures
    eng.step()  # warm-up decode (the first replay)

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
    if paged:
        masked += (f", paged (chunks of {PAGED['prefill_chunk']}, pages of "
                   f"{PAGED['page_size']})")
    how = ("steps captured as CUDA graphs" if eng._decode.graphed
           else "eager steps")
    print(f"{cfg.name} layers={cfg.n_layers} slots={slots} bf16 "
          f"activations, {args.quantize or 'bf16'} weights{masked} on "
          f"{where}, {how}")
    nbytes = decode_weight_bytes(lm, slots=slots)
    state = (f" (with the recurrent state of {slots} slots, "
             f"{state_bytes(lm, slots) / 1e6:.3f} MB, read and written)"
             if recurrent else "")
    print(f"weights a decode step reads: {nbytes / 1e9:.3f} GB{state}, "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s (the ITL floor)")
    routed = decode_weight_bytes(lm, tokens=slots, slots=slots)
    if routed != nbytes:
        print(f"of which the experts {slots} tokens can route to and the "
              f"rest: {routed / 1e9:.3f} GB, "
              f"{routed / HBM_BYTES_PER_S * 1e3:.3f} "
              f"ms (the routed floor)")
    print(f"decode step: {step_ms:.3f} ms wall (median of {args.steps}, "
          f"unprofiled); under the profiler: device busy {device_ms:.3f} "
          f"ms/step = {100 * device_ms / step_ms:.1f}% of the unprofiled "
          f"step, host op time {host_ms:.3f} ms/step")
    if eng._decode.graphs:
        graph, = eng._decode.graphs
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        graph.replay()
        ev[1].record()
        torch.cuda.synchronize()
        rec, = eng.captured()["decode"]
        print(f"decode graph: one replay {ev[0].elapsed_time(ev[1]):.3f} ms "
              f"of card time (CUDA events); it holds "
              f"{sum(rec.launches.values())} launches of the port's kernels "
              f"{rec.launches}")
    kernels = sum(e.count for e in avg if _device_us(e) > 0) / args.steps
    launch = [e for e in avg
              if e.key in ("cudaLaunchKernel", "cudaGraphLaunch")]
    launches = sum(e.count for e in launch) / args.steps
    launch_ms = sum(e.self_cpu_time_total for e in launch) / 1e3 / args.steps
    print(f"kernels run per step (device entries of the profiler): "
          f"{kernels:.0f}")
    decode = [e for e in avg if _device_us(e) > 0
              and "nm_spmm_decode_kernel" in e.key]
    dec_n = sum(e.count for e in decode) / args.steps
    dec_ms = sum(_device_us(e) for e in decode) / 1e3 / args.steps
    print(f"launch calls per step: {launches:.0f} (cudaLaunchKernel and "
          f"cudaGraphLaunch, {launch_ms:.3f} ms of host time); the decode "
          f"GEMM kernels "
          f"(nm_spmm_decode{'_q' if args.quantize else ''}): {dec_n:.0f} "
          f"launches, {dec_ms:.3f} ms of card time per step "
          f"({100 * dec_ms / max(device_ms, 1e-9):.1f}% of device busy)")
    for e in sorted(decode, key=_device_us, reverse=True):
        print(f"  {e.count / args.steps:6.0f} launches, "
              f"{_device_us(e) / 1e3 / args.steps:9.4f} ms: {e.key[:100]}")
    print(avg.table(sort_by="self_cpu_time_total", row_limit=ROWS))
    print("top device time per step (ms):")
    _top_device(avg, args.steps)


if __name__ == "__main__":
    main()
