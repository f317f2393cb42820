"""Serve a small sparse model of the PyTorch/CUDA port with batched
requests through the continuous-batching engine (prefill + per-slot
decode; on the card each step is captured once as a CUDA graph).

Run:  PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.launch.serve import build_model
from repro_torch.models.common import resolve_device
from repro_torch.serving.engine import Request, ServeEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args().device)

    # MLA + MoE, 2:4-compressed, the kernels' policy on
    cfg, lm = build_model("deepseek-v2-lite-16b", full=False, kernels=True,
                          dtype=torch.float32, device=dev)
    eng = ServeEngine(lm, slots=4, max_seq=96, prefill_len=16,
                      temperature=0.0)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(10):
        eng.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, size=16).astype(np.int32),
            max_new=8 + (i % 4)))
    done = eng.run()
    dt = time.time() - t0
    tokens = sum(len(r.out) for r in done)
    assert len(done) == 10 and all(len(r.out) == r.max_new for r in done)
    print(f"served {len(done)} requests / {tokens} tokens in {dt:.1f}s "
          f"({tokens / dt:.1f} tok/s on {dev.type}, 4 slots, MLA cache + "
          "MoE experts)")
    for r in done[:3]:
        print(f"  rid={r.rid}: {list(map(int, r.out))}")
    print("serve_decode OK")


if __name__ == "__main__":
    main()
