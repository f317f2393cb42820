"""Training entry point of the port (counterpart of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu

trains reduced yi-9b (f32 weights, bf16 compute, AdamW, the synthetic
``DataPipeline``) and asserts that the loss dropped. On the card,
full-width yi-9b cut to 8 layers (random 2:4 weights from seed 0, made
on the device):

  PYTHONPATH=src python -m repro_torch.launch.train --full --layers 8 \\
      --steps 30 --batch 8 --seq 256 --warmup 10

``--arch whisper-medium`` trains the encoder-decoder; its batches carry
``enc_input``, zero frames (batch, encoder_seq, d_model), as the JAX
package's ``launch/train.py`` gives them (:func:`with_enc_input`):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch whisper-medium --steps 20 --batch 4 --seq 32

Every forward projection of a compressed weight runs the hand-written
``nm_spmm`` kernel (policy "auto"; on the CPU its plain version); its
backward is the reference composition in f32. ``--ckpt-dir`` saves
``{"params", "opt"}`` and the data cursor every ``--ckpt-every`` steps
(async). ``step_split`` times one step's forward, backward and
optimizer update (CUDA events on the card; ``chip_smoke.py`` prints it).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.core.dots import strict_f32
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.launch.serve import build_model
from repro_torch.models.common import resolve_device
from repro_torch.optim.optimizer import AdamWConfig, adamw_update
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.train_loop import (
    TrainConfig,
    init_train_state,
    make_train_step,
    param_grads,
    to_device,
    trainable,
)


def build_trainer(arch: str, *, full: bool, layers=None, dense=False,
                  device="cuda", tcfg: TrainConfig):
    """(cfg, lm, opt_state, train_step): random weights from seed 0, f32,
    computed in bf16 (the JAX package's training dtypes), the N:M
    projections on the kernels; AdamW state at step 0."""
    dev = resolve_device(device)
    cfg, lm = build_model(arch, full=full, layers=layers, kernels=not dense,
                          dtype=torch.float32, device=dev, dense=dense)
    lm.set_compute_dtype(torch.bfloat16)
    _, opt_state = init_train_state(lm, tcfg)
    return cfg, lm, opt_state, make_train_step(lm, tcfg)


def with_enc_input(batch: dict, cfg, frames=None) -> dict:
    """``batch`` with an encoder-decoder's ``enc_input``: ``frames``, or
    zeros (rows, encoder_seq, d_model) f32 as the JAX package's train
    entry point gives; any other config's batch as it is."""
    if cfg.encoder_plan is None:
        return batch
    if frames is None:
        rows = len(batch["tokens"])
        frames = np.zeros((rows, cfg.encoder_seq, cfg.d_model), np.float32)
    return dict(batch, enc_input=frames)


def _timer(dev):
    """A function returning a point in time: a CUDA event recorded on the
    card, the host clock on the CPU; ``_elapsed_ms(a, b)`` reads two."""
    if dev.type == "cuda":
        def mark():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return mark
    return time.perf_counter


def _elapsed_ms(a, b) -> float:
    if isinstance(a, float):
        return (b - a) * 1e3
    b.synchronize()
    return a.elapsed_time(b)


def step_split(lm, opt_state, batch, tcfg: TrainConfig) -> dict:
    """ms of one step's forward (with the loss), backward and optimizer
    update: the pieces ``make_train_step`` runs (``grads_of`` is the
    forward then ``param_grads``; one microbatch, no compression). The
    step is applied: the model and state move on."""
    mark = _timer(lm.device)
    params = trainable(lm)
    batch = to_device(batch, lm.device)
    t0 = mark()
    loss, _ = lm.loss(batch, remat=tcfg.remat)
    t1 = mark()
    grads = param_grads(loss, params)
    t2 = mark()
    adamw_update(tcfg.opt, params, grads, opt_state)
    t3 = mark()
    return {"forward": _elapsed_ms(t0, t1), "backward": _elapsed_ms(t1, t2),
            "optimizer": _elapsed_ms(t2, t3)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), default="yi-9b")
    ap.add_argument("--full", action="store_true",
                    help="full-width config instead of the reduced one")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "dots",
                                                         "full"])
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    strict_f32()
    dev = resolve_device(args.device)
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                        total_steps=args.steps),
        microbatches=args.microbatches, remat=args.remat)
    cfg, lm, opt_state, step_fn = build_trainer(
        args.arch, full=args.full, layers=args.layers, dense=args.dense,
        device=dev, tcfg=tcfg)
    n_params = sum(p.numel() for p in trainable(lm).values())
    print(f"{cfg.name}: {cfg.n_layers} layers, {n_params} trained params "
          f"(f32), bf16 compute, batch {args.batch} x seq "
          f"{args.seq}, {args.microbatches} microbatch(es), remat "
          f"{args.remat}, on {dev}", flush=True)
    pipe = DataPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch))
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None

    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        lm, opt_state, metrics = step_fn(
            lm, opt_state, with_enc_input(pipe.next(), cfg))
        losses.append(float(metrics["loss"]))
        if not np.isfinite(losses[-1]):
            raise SystemExit(f"step {step + 1}: loss {losses[-1]}")
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            dt = (time.perf_counter() - t0) / (step + 1)
            print(f"step {step + 1:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({dt * 1e3:.1f} ms/step, "
                  f"{args.batch * args.seq / dt:.0f} tokens/s)", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": lm, "opt": opt_state},
                      extra={"data": pipe.state()}, async_=True)
    if ckpt:
        ckpt.wait()
    if dev.type == "cuda":
        print(f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
              " GiB", flush=True)
    k = max(1, min(10, args.steps // 2))
    first, last = np.mean(losses[:k]), np.mean(losses[-k:])
    print(f"first-{k} mean loss {first:.4f} -> last-{k} mean loss "
          f"{last:.4f}", flush=True)
    assert last < first, "loss did not drop"


if __name__ == "__main__":
    main()
