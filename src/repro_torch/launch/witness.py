"""The f32 witness: a served bf16 model through the kernels, held against
the same weights computed in f32.

    PYTHONPATH=src python -m repro_torch.launch.witness --arch rwkv6-3b \\
        [--layers 8] [--quantize int8] [--seeds 4 5 6] [--c 2.0] \\
        [--slots 4] [--prefill-len 128] [--steps 4] [--reduced] \\
        [--device cuda]

Builds ``--arch`` at full width (``--reduced``: its reduced config; its
full depth unless ``--layers`` cuts it) with random 2:4 weights from
seed 0, bf16 or int8 (``--quantize int8``) values and bf16 activations,
every MoE layer dropless. For each token seed it runs a prefill of
(slots, prefill_len) random tokens and ``--steps`` decode steps on fed
tokens three ways on the same weights: through the kernels (policy
"auto"), through the plain versions in bf16 (policy "off"), and through
the plain versions in f32 (``LM.set_compute_dtype``; strict f32
products: the exact answer here). Every layer also runs the three ways
on the kernel path's input, each way with its own cache. An
encoder-decoder (whisper) prefills with random frames from the same
generator; each encoder layer runs the three ways on the kernel path's
input too, and each decoder layer on the kernel path's input and
encoder output, each way writing and then reading its own cross K/V.

A deep random model in bf16 drifts from its f32 answer through depth
whatever computes its products, and two bf16 paths drift apart as far,
so the kernels are held to the plain bf16 path's own distance from f32,
not to the plain bf16 path: the ratio rms(kernels - f32) / rms(plain
bf16 - f32), of each layer's output and of each call's logits. The
root mean square over the output, not its largest entry: a bf16
output's largest error is a rounding of its largest values, and one
such rounding flipped either way halves or doubles a max-based ratio
(on full-depth whisper such ratios lie between 0.46 and 2.13 about a
median of 1.000, the two paths exchangeable); a kernel a few bf16
steps off moves the root mean square of every output. Prints each
seed's worst ratio over the layers and over the logits; with ``--c``
exits 1 when one exceeds it. ``chip_smoke.py`` holds its served models
to its ``WITNESS_C``.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys

import torch

from repro_torch.core.nmweight import KernelPolicy
from repro_torch.models.cache import CacheView
from repro_torch.models.common import Embedding, Linear
from repro_torch.models.moe import MoE


def _policy(mod, mode: str) -> None:
    for m in mod.modules():
        if isinstance(m, Linear) and m.nm is not None:
            m.kernel_policy = KernelPolicy(mode)


def _compute(mod, dtype) -> None:
    """What ``LM.set_compute_dtype`` does, for any module."""
    for m in mod.modules():
        if isinstance(m, (Linear, Embedding)):
            m.compute_dtype = dtype


def _rms(d: torch.Tensor) -> float:
    """Root mean square of a difference, summed in f64."""
    return float(d.double().square().mean().sqrt())


def ratio(kern: float, base: float) -> float:
    """rms(kernels - f32) over rms(plain bf16 - f32)."""
    if base > 0:
        return kern / base
    return 0.0 if kern == 0 else math.inf


def witness_inputs(lm, *, slots: int, prefill_len: int, steps: int = 4,
                   seed: int = 4):
    """(prompts (slots, prefill_len), fed tokens (steps, slots, 1), the
    encoder's frames or None) from ``seed``, on ``lm``'s device."""
    gen = torch.Generator(device=lm.device)
    gen.manual_seed(seed)
    toks = torch.randint(0, lm.cfg.vocab_size, (slots, prefill_len),
                         generator=gen, device=lm.device)
    feed = torch.randint(0, lm.cfg.vocab_size, (steps, slots, 1),
                         generator=gen, device=lm.device)
    enc = None
    if lm.cfg.encoder_plan is not None:
        enc = torch.randn(slots, lm.cfg.encoder_seq, lm.cfg.d_model,
                          generator=gen, device=lm.device).to(lm.dtype)
    return toks, feed, enc


def witness_calls(lm, toks, feed, enc=None, *, on_call=None) -> list:
    """The logits of a prefill of ``toks`` (B, S) (its last position) and
    of a decode step for each of ``feed``'s (B, 1) tokens, in a new
    cache of S + steps positions: a list of (B, 1, V) f32 tensors.
    ``on_call(i)`` is called before call i (0 the prefill)."""
    b, s = toks.shape
    steps = feed.shape[0]
    cache = lm.init_cache(b, s + steps)
    if on_call:
        on_call(0)
    out = [lm(toks, view=CacheView.prefill(), caches=cache,
              last_only=True, enc_input=enc)[0]]
    for i in range(steps):
        if on_call:
            on_call(i + 1)
        out.append(lm(feed[i], view=CacheView.decode(
            torch.full((b,), s + i)), caches=cache)[0])
    return out


def f32_witness(lm, *, slots: int, prefill_len: int, steps: int = 4,
                seed: int = 4) -> list[tuple[str, str, float, float]]:
    """(kind, where, rms(kernels - f32), rms(plain bf16 - f32)) of every
    layer of every call (kind "layer"), then of every call's logits
    (kind "logits", the prefill's at its last position). ``lm`` is a
    bf16 model under policy "auto", left so. Raises ValueError on a
    non-finite output or a shape that differs from the f32 one."""
    b, s = slots, prefill_len
    toks, feed, enc = witness_inputs(lm, slots=slots,
                                     prefill_len=prefill_len, steps=steps,
                                     seed=seed)
    max_seq = s + steps
    names = ["prefill"] + [f"decode {i + 1}" for i in range(steps)]
    rows, call = [], [names[0]]

    def judge(kind, where, got, plain, ref):
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise ValueError(f"{where}: shape {tuple(got.shape)} (f32 "
                             f"{tuple(ref.shape)}) or non-finite values")
        rows.append((kind, where, _rms(got.float() - ref),
                     _rms(plain.float() - ref)))

    def run():
        return witness_calls(lm, toks, feed, enc,
                             on_call=lambda i: call.__setitem__(0, names[i]))

    caches = {"plain": lm.init_cache(b, max_seq),
              "f32": lm.init_cache(b, max_seq, torch.float32)}
    # layer -> (its name, its index in the caches; None: an encoder layer)
    index = {layer: (f"layer {i}", i) for i, layer in enumerate(lm.layers)}
    index.update({layer: (f"encoder layer {i}", None)
                  for i, layer in enumerate(lm.enc_layers or ())})
    side = {}

    def before(layer, args, kwargs):  # forward, not __call__: no hooks
        i = index[layer][1]

        def cache(way):
            return caches[way][i] if i is not None else None

        _policy(layer, "off")
        plain = layer.forward(*args, **dict(kwargs, cache=cache("plain")))[0]
        _compute(layer, torch.float32)
        ref = layer.forward(args[0].float(), *args[1:],
                            **dict(kwargs, cache=cache("f32")))[0]
        _compute(layer, None)
        _policy(layer, "auto")
        side[layer] = plain, ref

    def after(layer, args, kwargs, out):
        judge("layer", f"{call[0]} {index[layer][0]}", out[0],
              *side.pop(layer))

    hooks = [h for layer in index for h in (
        layer.register_forward_pre_hook(before, with_kwargs=True),
        layer.register_forward_hook(after, with_kwargs=True))]
    try:
        with torch.inference_mode():
            got = run()
    finally:
        for h in hooks:
            h.remove()
    with torch.inference_mode():
        _policy(lm, "off")
        plain = run()
        lm.set_compute_dtype(torch.float32)
        ref = run()
        lm.set_compute_dtype(None)
        _policy(lm, "auto")
    for name, g, p, r in zip(names, got, plain, ref):
        judge("logits", f"{name} logits", g, p, r)
    return rows


def worst(rows) -> dict:
    """kind -> (the worst ratio, "where: kernels' / plain's distance")."""
    out = {}
    for kind, where, kern, base in rows:
        r = ratio(kern, base)
        if kind not in out or r >= out[kind][0]:
            out[kind] = r, f"{where}: {kern:.3e} / {base:.3e}"
    return out


def main(argv=None) -> int:
    from repro_torch.configs import ARCHS
    from repro_torch.core.dots import strict_f32
    from repro_torch.launch.serve import build_model

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCHS, default="rwkv6-3b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--quantize", choices=["int8"], default=None)
    ap.add_argument("--seeds", type=int, nargs="+", default=[4])
    ap.add_argument("--c", type=float, default=None,
                    help="exit 1 when a ratio exceeds it")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prefill-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    strict_f32()
    cfg, lm = build_model(args.arch, full=not args.reduced,
                          layers=args.layers, kernels=True,
                          dtype=torch.bfloat16, seed=0, device=args.device,
                          quantize=args.quantize)
    for layer in lm.layers:
        if isinstance(layer.mlp, MoE):
            moe = layer.mlp.cfg
            layer.mlp.cfg = dataclasses.replace(
                moe, capacity_factor=moe.n_experts / moe.top_k)
    ok = True
    for seed in args.seeds:
        w = worst(f32_witness(lm, slots=args.slots,
                              prefill_len=args.prefill_len,
                              steps=args.steps, seed=seed))
        print(f"{cfg.name} {cfg.n_layers} layers "
              f"{args.quantize or 'bf16'} seed {seed}: rms(kernels - f32) "
              f"/ rms(plain bf16 - f32), worst layer {w['layer'][0]:.3f} "
              f"({w['layer'][1]}), worst logits {w['logits'][0]:.3f} "
              f"({w['logits'][1]})", flush=True)
        ok &= args.c is None or max(r for r, _ in w.values()) <= args.c
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
