"""Quickstart of the PyTorch/CUDA port: the paper's technique end to end.

1. Prune a dense weight matrix to 2:4 structured sparsity (paper Fig. 1b)
   and compress it into a typed `NMWeight`: (values, int8 col_idx) plus
   the N:M config and the kernel policy.
2. Multiply with `repro_torch.api.nm_matmul` (the hand-written nm_spmm
   kernel on the card, its plain version on the CPU) and check it
   against the dense product.
3. Build a sparse transformer LM from a registry config, compute its
   training loss and run one prefill and one decode step.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch import api
from repro_torch.launch.serve import build_model
from repro_torch.models.common import Linear, resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args().device)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32

    # --- 1-2: the kernel on a single GEMM ------------------------------
    nm = api.NMConfig(2, 4)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(512, 256, generator=gen, device=dev)  # dense (K, N)
    sw = api.sparsify(w, nm, kernel_policy="auto")  # typed compressed weight
    print(f"compressed {w.numel()} weights -> {sw.vals.numel()} values "
          f"({sw.nm.tag}, idx in [0,{sw.nm.m}), "
          f"policy={sw.kernel_policy.mode})")

    x = torch.randn(128, 512, generator=gen, device=dev)
    y_kernel = api.nm_matmul(x, sw)  # nm_spmm (its plain version on CPU)
    y_dense = x @ api.densify(sw)
    err = float((y_kernel - y_dense).abs().max())
    print(f"kernel vs dense max err: {err:.2e} (on {dev.type})")
    assert err < 1e-3

    # --- 3: a sparse LM from the registry ------------------------------
    cfg, lm = build_model("yi-9b", full=False, kernels=True,
                          dtype=torch.float32, device=dev)
    n_sparse = sum(1 for m in lm.modules()
                   if isinstance(m, Linear) and m.nm is not None)
    print(f"model carries {n_sparse} NMWeight nodes")
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen,
                           device=dev)
    with torch.no_grad():
        loss, _ = lm.loss({"tokens": tokens, "labels": tokens})
        print(f"sparse-LM train loss: {float(loss):.3f}")
        caches = lm.init_cache(2, 64)
        logits, caches = lm(tokens, view=api.CacheView.prefill(),
                            caches=caches)
        nxt = torch.argmax(logits[:, -1:], dim=-1)
        logits, caches = lm(nxt, view=api.CacheView.decode(
            torch.full((2,), 32)), caches=caches)
    print(f"decode logits: {tuple(logits.shape)} — quickstart OK")


if __name__ == "__main__":
    main()
