"""The benchmark's one command.

    python3 etlbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Everything is found by the names in
``BENCHMARK.json``: the cell's configuration file (its ``file``), its
traffic mix (``etlbench/traffic/<traffic>.json``, whose ``mode`` names
``etlbench/modes/<mode>.py``) and each per-layer metric's reader
(``etlbench/metrics/<metric>.py``).  With ``--trace 0`` the result line
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics.  The last line of standard output is the result; the numbers
compared with the reference close standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, the folder itself leads sys.path: keep its module names
# from shadowing others
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def resolve(bench: dict, cell: str, root: str = ROOT) -> dict:
    """The cell's entry, configuration, traffic mix, end-to-end metrics and
    per-layer metrics (with their reader files), all found by name."""
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise SystemExit(f"unknown workload {cell!r}")
    w = work[cell]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    bench_dir = os.path.join(root, "etlbench")
    with open(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if cell in m.get("workloads", ()) or
                 ("workloads" not in m and m["moves"] in names)]
    readers = {m["name"]: os.path.join(bench_dir, "metrics",
                                       f"{m['name']}.py")
               for m in per_layer}
    for path in readers.values():
        if not os.path.isfile(path):
            raise SystemExit(f"no reader {path}")
    return {"workload": w, "config": cfg, "traffic": traffic, "e2e": e2e,
            "per_layer": per_layer, "readers": readers}


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("etlbench: no src/repro_torch in this checkout", file=sys.stderr)
        return 2
    bench = load_bench()
    cell = resolve(bench, args.workload)
    import torch
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"etlbench: {args.workload} needs {chips} CUDA device(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from etlbench import drive
    readers = {name: drive.load_file_module(path, "etlbench_metric_"
                                            + name.replace(".", "_"))
               for name, path in cell["readers"].items()}
    out = drive.execute(args.workload, cell["config"], cell["traffic"],
                        args.seed, args.seconds, bool(args.trace), "cuda:0",
                        T0, readers)
    bad = forbidden_modules()
    if bad:
        print(f"etlbench: the run loaded {bad}", file=sys.stderr)
        return 3
    units = {m["name"]: m["unit"] for m in cell["e2e"] + cell["per_layer"]}
    want = [m["name"] for m in (cell["per_layer"] if args.trace
                                else cell["e2e"])]
    metrics = {k: {"value": out["metrics"][k], "unit": units[k]}
               for k in want if k in out["metrics"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    summary = out["summary"]
    if args.trace:
        if summary is None or summary["busy_s"] <= 0:
            print("etlbench: the profiler recorded no device time",
                  file=sys.stderr)
            return 4
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = out["checks"]
    print("setup phases: " + ", ".join(f"{n} {s:.3f} s" for n, s in
                                       out["phases"]), file=sys.stderr)
    print("readings: " + json.dumps(out["readings"]), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
