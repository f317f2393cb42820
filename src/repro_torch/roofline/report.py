"""The dry-run's JSON files as roofline tables (port of
``repro.roofline.report``; the JAX package's columns).

    python -m repro_torch.roofline.report --dir DIR [--mesh single|multi]

GiB/dev is the rank's arguments (params, optimizer state, batch,
cache): the port's dry-run has no temp bytes (nothing is compiled), so
the column holds the arguments alone.
"""
from __future__ import annotations

import argparse
import json
import os

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(out_dir: str) -> list[dict]:
    rows = []
    for f in sorted(os.listdir(out_dir)):
        if f.endswith(".json"):
            with open(os.path.join(out_dir, f)) as fh:
                rows.append(json.load(fh))
    return rows


def fmt_table(rows: list[dict], mesh: str = "single",
              sparse: bool | None = True) -> str:
    sel = [r for r in rows if r["mesh"] == mesh
           and (sparse is None or r["sparse"] == sparse)]
    sel.sort(key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])))
    out = ["| arch | shape | t_comp ms | t_mem ms | t_coll ms | bound | "
           "useful FLOPs | roofline frac | GiB/dev (args+temp) |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in sel:
        mem = r.get("memory", {})
        gib = (mem.get("argument_size_in_bytes", 0)
               + mem.get("temp_size_in_bytes", 0)) / 2**30
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute']*1e3:.2f} | "
            f"{r['t_memory']*1e3:.2f} | {r['t_collective']*1e3:.2f} | "
            f"{r['bottleneck'][:4]} | {r['useful_flops_frac']:.3f} | "
            f"{r['roofline_frac']:.3f} | {gib:.1f} |")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    print(fmt_table(load(args.dir), args.mesh))


if __name__ == "__main__":
    main()
