"""End to end with the PyTorch/CUDA port: train a ~100M-param
2:4-sparse LM on the synthetic pipeline, with checkpointing and
fault-tolerant resume, and verify the loss drops.

Run:  PYTHONPATH=src python examples/torch_train_sparse_lm.py \\
          [--steps 200] [--layers 10] [--device cpu]
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import (
    AttnConfig,
    Block,
    FFNConfig,
    ModelConfig,
    SparsityConfig,
)
from repro_torch.core.dots import strict_f32
from repro_torch.core.sparsity import NMConfig
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.models.common import resolve_device
from repro_torch.models.transformer import LM
from repro_torch.optim.optimizer import AdamWConfig, adamw_init
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.fault_tolerance import run_resilient
from repro_torch.training.train_loop import (
    TrainConfig,
    make_train_step,
    trainable,
)


def model_100m(sparse=True, layers=10) -> ModelConfig:
    """~100M params (dense-equivalent): 10L, d=768, untied 32k vocab."""
    attn = AttnConfig(q_heads=12, kv_heads=4, head_dim=64)
    return ModelConfig(
        name="sparse-lm-100m", vocab_size=32_768, d_model=768,
        plan=((Block(attn, FFNConfig(d_ff=3072)), layers),), max_seq=512,
        sparsity=SparsityConfig(nm=NMConfig(2, 4), mode="compressed",
                                use_kernel=True) if sparse else None)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--layers", type=int, default=10,
                    help="depth (the ~100M model has 10 layers)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    strict_f32()

    cfg = model_100m(layers=args.layers)

    def init_state():
        # f32 weights computed in bf16 (the JAX package's training dtypes)
        lm = LM.init(cfg, seed=0, dtype=torch.float32, device=dev)
        lm.set_compute_dtype(torch.bfloat16)
        return {"params": lm, "opt": adamw_init(trainable(lm))}

    first = init_state()
    n = sum(p.numel() for p in trainable(first["params"]).values())
    print(f"model: {n / 1e6:.1f}M float params ({cfg.sparsity.nm.tag}), "
          f"on {dev.type}")

    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=30,
                                       total_steps=args.steps),
                       microbatches=2, remat="none")
    raw_step = make_train_step(first["params"], tcfg)
    losses = []

    def train_step(state, batch):
        lm, opt, m = raw_step(state["params"], state["opt"], batch)
        losses.append(float(m["loss"]))
        return {"params": lm, "opt": opt}, m

    pipe = DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                       seq_len=args.seq,
                                       global_batch=args.batch))
    states = iter([first])

    def fresh():  # the first start reuses the state made above
        return next(states, None) or init_state()

    with tempfile.TemporaryDirectory() as d:
        res = run_resilient(train_step=train_step, init_state=fresh,
                            pipeline=pipe, ckpt=Checkpointer(d),
                            total_steps=args.steps, ckpt_every=100)
    first_l, last_l = np.mean(losses[:20]), np.mean(losses[-20:])
    print(f"steps={res['steps_run']} loss {first_l:.3f} -> {last_l:.3f}")
    if args.steps >= 100:  # short runs (the test's) only check the wiring
        assert last_l < first_l - 0.5, "training did not converge"
    print("train_sparse_lm OK")


if __name__ == "__main__":
    main()
