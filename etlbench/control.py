"""Readings of the controls and faults that set the upper end of each
limit, at a configuration's own size, with the reference put in the
program's place (none of this runs in a benchmark run).

    python3 etlbench/control.py --config dlrm_mlperf --seeds 1 2 3

For each seed, against the float32 reference of that seed's data:

- ``tf32``: the reference with TF32 products (the precision below the
  configuration's float32 with TF32 off): ``loss_gap``, ``grad_gap``,
  ``update_gap``;
- ``bf16_dense``: the ETL's dense chain in bfloat16: ``dense_gap``;
- ``half_batch``: each step's loss the mean over the first half of the
  batch's rows: ``loss_gap``, ``grad_gap``, ``update_gap``;
- ``unchanged``: a step that leaves the state as it was reads
  ``update_gap`` 1 and ``grad_gap`` 1 by construction (no run).

One JSON line a seed and control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]


def readings(cfg: dict, traffic: dict, seed: int, device,
             controls=("tf32", "bf16_dense", "half_batch")) -> list:
    import numpy as np
    import torch

    from etlbench import drive, gen, reference, work

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shape, a = work.model_shape(cfg), cfg["assumed"]
    rows = int(a["batch_rows"])
    cards = work.cardinalities(cfg)
    fit = gen.batches(seed, 0, int(traffic["fit_chunks"]), rows, traffic,
                      cards)
    pool = gen.batches(seed, 1, int(traffic["pool_batches"]), rows, traffic,
                       cards)
    table = reference.etl_fit(fit, shape["n_sparse"], int(a["vocab_capacity"]))
    kw = dict(n_dense=shape["n_dense"], n_sparse=shape["n_sparse"],
              dense_padded=shape["dense_padded"],
              sparse_padded=int(a["sparse_padded"]))
    steps = int(traffic.get("setup_steps", 3))
    batches = [reference.etl_apply(pool[i], table, **kw)
               for i in range(steps)]
    base = reference.train_three(shape, a, seed, batches, device)
    out = []
    if "tf32" in controls:
        got = reference.train_three(shape, a, seed, batches, device,
                                    precision="tf32")
        out.append({"control": "tf32", **drive.train_checks(got, base)})
    if "half_batch" in controls:
        half = [{k: v[: rows // 2] for k, v in b.items()} for b in batches]
        got = reference.train_three(shape, a, seed, half, device)
        out.append({"control": "half_batch",
                    **drive.train_checks(got, base)})
    if "bf16_dense" in controls:
        gap = 0.0
        for raw in pool:
            want = reference.etl_apply(raw, table, **kw)["dense"]
            got = reference.etl_apply(raw, table, dense_precision="bfloat16",
                                      **kw)["dense"]
            gap = max(gap, float((np.abs(got.astype(np.float64) - want)
                                  / np.maximum(1.0, np.abs(want))).max()))
        out.append({"control": "bf16_dense", "dense_gap": gap})
    out.append({"control": "base", "losses": base["losses"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", default="train")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    with open(os.path.join(HERE, "configs", f"{args.config}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{args.traffic}.json")) as f:
        traffic = json.load(f)
    for seed in args.seeds:
        for line in readings(cfg, traffic, seed, args.device):
            print(json.dumps({"config": args.config, "seed": seed, **line}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
