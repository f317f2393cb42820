"""Serving entry point of the port: a few requests through ``ServeEngine``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --full \\
      --kernels --device cuda

``--arch`` is ``yi-9b``, ``chameleon-34b`` (qk-norm),
``codeqwen1.5-7b`` or ``internlm2-20b`` (GQA), ``gemma3-27b`` (GeGLU,
5 local layers of window 1024 to 1 global, a tied 262,144-row head),
``deepseek-v2-lite-16b`` (MLA and MoE), ``rwkv6-3b`` (RWKV-6,
attention-free), ``jamba-v0.1-52b`` (Mamba and one attention layer a
period of 8, MoE on odd layers) or ``whisper-medium`` (an
encoder-decoder).
``--full`` serves the full-width config (random weights from seed 0,
made on the device, pruned to 2:4 and compressed layer by layer) instead
of the reduced one; ``--layers L`` cuts the depth to the first L layers
(deepseek: layer 0 dense, the rest MoE; jamba: ``--layers 8`` is one
period, all its block kinds);
``--kernels`` routes every compressed GEMM through the hand-written
kernels (policy "auto"; without it the policy is "off" and the plain
reference runs). ``--quantize int8`` stores the compressed weights as
int8 with per-output-channel scales, quantized from their f32 values as
they are made, and serves them through the int8 kernels:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --dtype f32 --kernels --quantize int8 --prefill-len 8 --max-new 4

The recurrent models serve the same way (on the CPU their reduced
configs; on the card ``--full``, jamba cut to ``--layers 8``); they
have no chunked prefill and no paged cache:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch rwkv6-3b --dtype f32 --kernels --prefill-len 8 --max-new 4

``--prefill-chunk C`` prefills prompts C tokens a step; ``--paged``
serves through the paged KV cache (``--page-size`` tokens a page,
``--pool-pages`` pages in all; prompts sharing whole leading pages reuse
them, and decode preempts when the pool runs out):

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --dtype f32 --kernels --prefill-len 8 --prefill-chunk 4 --paged \
      --page-size 4 --pool-pages 12 --max-new 8

An encoder-decoder (whisper-medium) has no ``ServeEngine`` (nor has the
JAX package's): it is served through ``make_serve_steps``
(:func:`serve_encdec`), ``--slots`` prompts of ``--prefill-len`` tokens
with random frames (slots, encoder_seq, d_model) from the seed, one
prefill and ``--max-new - 1`` greedy decode steps; on the card ``--full``
is the whole model (24 + 24 layers):

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch whisper-medium --dtype f32 --kernels --prefill-len 8 \
      --max-new 4

``--trace-out TRACE.JSON`` / ``--metrics-out METRICS.PROM`` turn
observability on (:mod:`repro_torch.obs`) and write a Chrome / Perfetto
trace and a Prometheus text snapshot at the end; ``python -m
repro_torch.obs.check TRACE.JSON METRICS.PROM`` validates them.

On the card each step is captured once as a CUDA graph and replayed.

``--mesh DATAxMODEL`` serves through ``ShardedServeEngine`` on that many
ranks, started by ``launch.mesh.spawn`` with the ``--backend`` given
(``gloo`` on the CPU or for ranks that share one card, ``nccl`` for
ranks on cards of their own): slots split over "data", the projections
over "model" as ``parallel.sharding.serve_tp_plan`` says (printed), each
rank making its shard a layer at a time. Its steps run eagerly. On the
CPU, reduced yi-9b on 2 ranks, then on the card 2 ranks sharing it:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --dtype f32 --kernels --prefill-len 8 --max-new 4 --mesh 1x2 \
      --backend gloo
  PYTHONPATH=src python -m repro_torch.launch.serve --full --kernels \
      --mesh 1x2 --backend gloo
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.configs.base import AttnConfig, Block
from repro_torch.core.dots import strict_f32
from repro_torch.models.common import resolve_device
from repro_torch.models.transformer import LM
from repro_torch.serving.engine import Request, ServeEngine

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def build_model(arch: str, *, full: bool, layers=None, kernels: bool,
                dtype=torch.bfloat16, seed: int = 0, device="cuda",
                quantize=None, mask=None, dense: bool = False):
    """The served config (:func:`served_config`) and its model;
    ``quantize="int8"`` makes its compressed weights int8."""
    cfg = served_config(arch, full=full, layers=layers, kernels=kernels,
                        mask=mask, dense=dense)
    return cfg, LM.init(cfg, seed=seed, dtype=dtype, device=device,
                        quantize=quantize)


def served_config(arch: str, *, full: bool, layers=None, kernels: bool,
                  mask=None, dense: bool = False):
    """The config :func:`build_model` serves: cut to its first ``layers``
    layers when given; ``mask`` (a ``MaskSpec``) on every block's
    attention, with ``window=None`` (prefill then runs the block-sparse
    attention family); ``dense`` makes every weight dense; ``kernels``
    puts the compressed weights on the kernels' policy."""
    get = get_config if full else get_reduced
    cfg = get(arch, sparse=not dense)
    if layers is not None:
        cfg = dataclasses.replace(cfg, plan=cut_plan(cfg.plan, layers))
    if mask is not None:
        cfg = cfg.map_blocks(lambda b: masked(b, mask))
    if cfg.sparsity is not None:
        cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
            cfg.sparsity, use_kernel=kernels))
    elif kernels:
        raise SystemExit(f"--kernels: {arch} has no compressed GEMMs")
    return cfg


def masked(blk: Block, mask) -> Block:
    """``blk`` with ``mask`` on its attention (window dropped); a
    recurrent mixer has no attention to mask and is returned as it is."""
    if not isinstance(blk.mixer, AttnConfig):
        return blk
    return dataclasses.replace(blk, mixer=dataclasses.replace(
        blk.mixer, mask=mask, window=None))


def cut_plan(plan: tuple, layers: int) -> tuple:
    """A plan of the first ``layers`` layers, a period counting its
    blocks: the plan's groups in order, the group where the count is
    reached cut short (to whole periods, then the first blocks of the
    next), the last group repeated further where the plan has fewer
    layers."""
    out, left = [], layers
    for i, (entry, rep) in enumerate(plan):
        if left <= 0:
            break
        last = i == len(plan) - 1
        size = len(entry) if isinstance(entry, tuple) else 1
        whole = left // size if last else min(rep, left // size)
        if whole:
            out.append((entry, whole))
            left -= whole * size
        if 0 < left < size and (last or whole < rep):
            out.append((entry[:left], 1))
            left = 0
    return tuple(out)


def serve(lm: LM, *, requests: int, slots: int, prefill_len: int,
          max_new: int, max_seq: int, temperature: float = 0.0,
          seed: int = 0, shared_prefix: int = 0, **engine_kw):
    """Serve ``requests`` random prompts, the first ``shared_prefix``
    tokens the same in all; ``engine_kw`` go to :class:`ServeEngine`
    (``prefill_chunk``, ``paged``, ``page_size``, ``pool_pages``,
    ``graphs``). Returns (engine, done, seconds)."""
    eng = ServeEngine(lm, slots=slots, max_seq=max_seq,
                      prefill_len=prefill_len, temperature=temperature,
                      seed=seed, **engine_kw)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, lm.cfg.vocab_size,
                           size=(requests, prefill_len)).astype(np.int32)
    prompts[:, :shared_prefix] = prompts[0, :shared_prefix]
    t0 = time.perf_counter()
    for i in range(requests):
        eng.submit(Request(rid=i, prompt=prompts[i], max_new=max_new))
    done = eng.run()
    return eng, done, time.perf_counter() - t0


def encdec_inputs(lm: LM, *, slots: int, prefill_len: int, seed: int = 0):
    """Random prompts (slots, prefill_len) and encoder inputs of every
    slot from ``seed``: frames (slots, encoder_seq, d_model) in the
    model's dtype, or token ids for a token-input encoder; on the
    model's device."""
    cfg = lm.cfg
    gen = torch.Generator(device=lm.device)
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (slots, prefill_len),
                         generator=gen, device=lm.device)
    if cfg.encoder_inputs == "tokens":
        enc = torch.randint(0, cfg.vocab_size, (slots, cfg.encoder_seq),
                            generator=gen, device=lm.device)
    else:
        enc = torch.randn(slots, cfg.encoder_seq, cfg.d_model,
                          generator=gen, device=lm.device).to(lm.dtype)
    return toks, enc


def serve_encdec(lm: LM, tokens: torch.Tensor, enc_input: torch.Tensor, *,
                 max_new: int, steps=None, caches=None, graphs: bool = True):
    """Greedy generation of an encoder-decoder through
    ``make_serve_steps``: one prefill of every slot's prompt ``tokens``
    (B, S) with its ``enc_input``, then ``max_new - 1`` decode steps, in
    ``caches`` (new ones ``S + max_new`` long when None). ``steps`` (a
    (prefill, decode) pair) serve in place of new ones: with the same
    caches they replay the graphs they captured. Returns (streams (B,
    max_new) numpy, prefill seconds, each decode step's seconds, the
    steps), each time up to the sampled ids on the host."""
    from repro_torch.serving.engine import make_serve_steps
    from repro_torch.serving.sampling import make_sampler

    if steps is None:
        steps = make_serve_steps(lm, graphs=graphs,
                                 sampler=make_sampler(0.0))
    prefill, decode = steps
    b, s = tokens.shape
    if caches is None:
        caches = lm.init_cache(b, s + max_new)
    with torch.inference_mode():
        t0 = time.perf_counter()
        ids = prefill(caches, tokens=tokens,
                      enc_input=enc_input).cpu().numpy()
        t_prefill = time.perf_counter() - t0
        out, times = [ids], []
        for i in range(max_new - 1):
            t0 = time.perf_counter()
            ids = decode(caches, tokens=ids[:, None].astype(np.int64),
                         cache_len=np.full((b,), s + i, np.int64)
                         ).cpu().numpy()
            times.append(time.perf_counter() - t0)
            out.append(ids)
    return np.stack(out, 1), t_prefill, times, steps


def parse_mesh(text: str) -> tuple[int, int]:
    """"DATAxMODEL" -> (data, model)."""
    try:
        data, model = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {text!r}: expected DATAxMODEL, as 1x2")
    if data < 1 or model < 1:
        raise SystemExit(f"--mesh {text!r}: both sizes must be positive")
    return data, model


def serve_mesh(args, dev: torch.device) -> None:
    """``--mesh``: the requests served through ``ShardedServeEngine`` on
    every rank (``launch.sharded.serve_rank``); rank 0's numbers."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.sharded import serve_rank
    from repro_torch.parallel.sharding import serve_tp_plan

    data, model = parse_mesh(args.mesh)
    if args.backend is None:
        raise SystemExit("--mesh needs --backend gloo or nccl")
    if args.paged or args.trace_out or args.metrics_out:
        raise SystemExit("--mesh serves the slot cache without obs here")
    get = get_config if args.full else get_reduced
    cfg = get(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, plan=cut_plan(cfg.plan, args.layers))
    if cfg.sparsity is not None:
        cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
            cfg.sparsity, use_kernel=args.kernels))
    plan = serve_tp_plan(cfg, model)
    print(f"{cfg.name}: {plan}, reduce tags {sorted(plan.reduce_tags)}",
          flush=True)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(args.requests, args.prefill_len))
    case = dict(cfg=cfg, dtype=DTYPES[args.dtype], seed=0, shard_init=True,
                quantize=args.quantize, prompts=list(prompts),
                max_new=[args.max_new] * args.requests,
                engine=dict(slots=args.slots, prefill_len=args.prefill_len,
                            max_seq=args.max_seq
                            or args.prefill_len + args.max_new,
                            temperature=args.temperature,
                            prefill_chunk=args.prefill_chunk))
    t0 = time.perf_counter()
    res = mesh_mod.spawn(serve_rank, data, model, backend=args.backend,
                         device=dev.type, timeout_s=3000, args=([case],))
    dt = time.perf_counter() - t0
    first = res[0][0]
    if any(r[0]["streams"] != first["streams"] for r in res):
        raise SystemExit("the ranks' streams differ")
    st = first["stats"]
    peaks = [r[0]["peak"] for r in res]
    print(f"{cfg.name} ({cfg.n_layers} layers) on {data} x {model} ranks "
          f"({args.backend}, {dev.type}): served {st['requests']} "
          f"requests, {st['tokens']} tokens in {first['serve_s']:.2f}s of "
          f"{dt:.2f}s ({st['tokens'] / first['serve_s']:.1f} tok/s, itl "
          f"p50={st['itl_p50_s'] * 1e3:.1f}ms); peak memory a rank "
          f"{[None if p is None else round(p / 2**30, 3) for p in peaks]} "
          f"GiB")
    for rid in sorted(first["streams"])[:3]:
        print(f"  rid={rid} out[:8]={first['streams'][rid][:8]}")
    if st["requests"] != args.requests:
        raise SystemExit(f"only {st['requests']} of {args.requests} "
                         "finished")


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
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prefill prompts in chunks of this many tokens, "
                         "one a step; must divide prefill-len")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged KV cache (page pool, "
                         "block tables, prefix cache, preemption)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens a KV page (paged; default "
                         "$REPRO_KV_PAGE_SIZE, else the prefill chunk)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="pages in the KV pool (paged; default "
                         "$REPRO_KV_POOL_PAGES, else every slot at "
                         "max-seq)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens every prompt shares at its start")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="serve on DATA x MODEL ranks (ShardedServeEngine; "
                         "needs --backend)")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                    help="the ranks' collective backend: gloo on the CPU "
                         "or for ranks sharing one card, nccl for ranks "
                         "on cards of their own")
    ap.add_argument("--trace-out", default=None, metavar="TRACE.JSON",
                    help="enable observability and export a Chrome/"
                         "Perfetto trace here on exit")
    ap.add_argument("--metrics-out", default=None, metavar="METRICS.PROM",
                    help="enable observability and export a Prometheus "
                         "text snapshot here on exit")
    args = ap.parse_args()

    bundle = None
    if args.trace_out or args.metrics_out:
        bundle = obs_mod.enable()

    dev = resolve_device(args.device)
    strict_f32()
    if args.mesh:
        return serve_mesh(args, dev)
    cfg, lm = build_model(args.arch, full=args.full, layers=args.layers,
                          kernels=args.kernels, dtype=DTYPES[args.dtype],
                          device=dev, quantize=args.quantize)
    if cfg.encoder_plan is not None:
        toks, enc = encdec_inputs(lm, slots=args.slots,
                                  prefill_len=args.prefill_len)
        out, t_pre, times, _ = serve_encdec(lm, toks, enc,
                                            max_new=args.max_new)
        itl = statistics.median(times) * 1e3 if times else float("nan")
        print(f"{cfg.name} ({len(lm.enc_layers)} encoder + "
              f"{cfg.n_layers} decoder layers, {args.dtype} activations, "
              f"{args.quantize or args.dtype} weights) on {dev}, served "
              f"through make_serve_steps (ServeEngine has no encoder "
              f"input): {args.slots} slots, prefill {t_pre * 1e3:.1f} ms, "
              f"decode step p50 {itl:.2f} ms; out[:8] of slot 0 "
              f"{out[0, :8].tolist()}")
        return
    eng, done, dt = serve(
        lm, requests=args.requests, slots=args.slots,
        prefill_len=args.prefill_len, max_new=args.max_new,
        max_seq=args.max_seq or args.prefill_len + args.max_new,
        temperature=args.temperature, shared_prefix=args.shared_prefix,
        prefill_chunk=args.prefill_chunk, paged=args.paged,
        page_size=args.page_size, pool_pages=args.pool_pages)
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
    if args.paged:
        print(f"  paged: {stats['preemptions']} preemptions, "
              f"{stats['prefix_hit_pages']} of "
              f"{stats['prefix_lookup_pages']} prompt pages from the prefix "
              f"cache, pool utilization max {stats['page_util_max']:.2f}")
    print(f"  steps captured: {eng.compiled_cache_sizes()}")
    for r in done[:3]:
        print(f"  rid={r.rid} out[:8]={r.out[:8]}")
    if bundle is not None:
        if args.trace_out:
            n = bundle.tracer.export_chrome(args.trace_out)
            print(f"wrote {args.trace_out} ({n} events, "
                  f"{bundle.tracer.dropped} dropped)")
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                f.write(bundle.metrics.to_prometheus())
            print(f"wrote {args.metrics_out}")
    if len(done) != args.requests:
        raise SystemExit(f"only {len(done)} of {args.requests} finished")


if __name__ == "__main__":
    main()
