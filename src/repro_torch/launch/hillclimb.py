"""Named variants of a dry-run cell and their roofline terms (port of
``repro.launch.hillclimb``): each variant is a (tag, kwargs) pair given
to ``dryrun.run_cell``, and each result is a line of a JSONL log.

    python -m repro_torch.launch.hillclimb --cell dsv2-train
    python -m repro_torch.launch.hillclimb --cell yi-decode --only tp_only

The JAX package's grids, over the knobs the port has: the dense
baseline, tp_only storage, remat, microbatches, the attention chunk
(``ModelConfig.attn_chunk``) and the fp8 cache. Its
``gather_compressed`` variants (an XLA FSDP gather of the compressed
weights) have no counterpart in the port.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import run_cell

CELLS: dict[str, dict] = {
    # the paper's technique at scale (sparse expert weights dominate the
    # bytes) and a memory-bound train cell
    "dsv2-train": {
        "base": dict(arch="deepseek-v2-236b", shape="train_4k",
                     mesh_kind="single", sparse=True, sharding_mode="fsdp",
                     remat="full", microbatches=16),
        "variants": [
            ("paper_dense_baseline", dict(sparse=False)),
            ("remat_dots", dict(remat="dots")),
            ("mb8", dict(microbatches=8)),
            ("chunk2048", dict(attn_chunk=2048)),
        ],
    },
    # memory-bound decode: the technique's direct win (weight bytes)
    "yi-decode": {
        "base": dict(arch="yi-9b", shape="decode_32k", mesh_kind="single",
                     sparse=True, sharding_mode="fsdp"),
        "variants": [
            ("paper_dense_baseline", dict(sparse=False)),
            ("tp_only", dict(sharding_mode="tp_only")),
            ("cache_fp8", dict(cache_dtype="fp8")),
            ("cache_fp8_tp_only", dict(cache_dtype="fp8",
                                       sharding_mode="tp_only")),
        ],
    },
    # a collective- and memory-heavy prefill
    "gemma3-prefill": {
        "base": dict(arch="gemma3-27b", shape="prefill_32k",
                     mesh_kind="single", sparse=True, sharding_mode="fsdp"),
        "variants": [
            ("paper_dense_baseline", dict(sparse=False)),
            ("chunk1024", dict(attn_chunk=1024)),
            ("chunk2048", dict(attn_chunk=2048)),
            ("tp_only", dict(sharding_mode="tp_only")),
        ],
    },
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=list(CELLS))
    ap.add_argument("--only", default=None,
                    help="run a single variant tag (plus base)")
    ap.add_argument("--out", default="experiments/hillclimb")
    ap.add_argument("--skip-base", action="store_true")
    args = ap.parse_args()

    spec = CELLS[args.cell]
    os.makedirs(args.out, exist_ok=True)
    log = os.path.join(args.out, f"{args.cell}.jsonl")

    def record(tag: str, kwargs: dict) -> None:
        base = dict(spec["base"])
        base.update(kwargs)
        res = run_cell(out_dir=None, tag="_" + tag, **base)
        res["variant"] = tag
        with open(log, "a") as f:
            f.write(json.dumps(res) + "\n")

    if not args.skip_base:
        record("base", {})
    for tag, kw in spec["variants"]:
        if args.only and tag != args.only:
            continue
        record(tag, kw)
    print(f"hillclimb log -> {log}")


if __name__ == "__main__":
    main()
