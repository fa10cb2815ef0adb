"""A configuration, a traffic mix and a per-layer metric added as new
files, with new entries in BENCHMARK.json, are found by name: no file
that was there changes."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

from etlbench import drive, run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def digests(root: str) -> dict:
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".json", ".md")):
                p = os.path.join(base, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = \
                        hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "etlbench"),
                    os.path.join(root, "etlbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = digests(root)
    bench_dir = os.path.join(root, "etlbench")
    with open(os.path.join(bench_dir, "configs", "dlrm_kaggle.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "dlrm_new"
    with open(os.path.join(bench_dir, "configs", "dlrm_new.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench_dir, "traffic", "train.json")) as f:
        traffic = json.load(f)
    traffic["pool_batches"] = 6
    with open(os.path.join(bench_dir, "traffic", "train_pool6.json"),
              "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(bench_dir, "metrics", "pool_size.train_pool6.py"),
              "w") as f:
        f.write("def read(run):\n    return float(len(run.pool))\n")
    bench = run.load_bench(root)
    bench["configs"].append({"name": "dlrm_new", "source": "x",
                             "file": "etlbench/configs/dlrm_new.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dlrm_new.train_pool6",
                               "config": "dlrm_new", "traffic": "train_pool6",
                               "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "dlrm_kaggle.train" in m["workloads"]:
            m["workloads"].append("dlrm_new.train_pool6")
    bench["per_layer"].append({"name": "pool_size.train_pool6", "unit": "n",
                               "better": "higher", "source": "program_counter",
                               "layer": "executor",
                               "moves": "train_rows_per_s",
                               "workloads": ["dlrm_new.train_pool6"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    cell = run.resolve(run.load_bench(root), "dlrm_new.train_pool6", root)
    assert cell["config"]["name"] == "dlrm_new"
    assert cell["traffic"]["pool_batches"] == 6
    assert os.path.isfile(os.path.join(bench_dir, "modes",
                                       f"{cell['traffic']['mode']}.py"))
    assert {m["name"] for m in cell["e2e"]} == {
        "train_rows_per_s", "step_gap_p95_ms", "setup_s"}
    assert "pool_size.train_pool6" in cell["readers"]
    reader = drive.load_file_module(cell["readers"]["pool_size.train_pool6"],
                                    "etlbench_test_pool_size")

    class Stub:
        pool = [None] * 6
    assert reader.read(Stub()) == 6.0
    after = digests(root)
    changed = [p for p in before if after[p] != before[p]]
    assert changed == ["BENCHMARK.json"]


def test_every_declared_name_has_its_files():
    bench = run.load_bench(ROOT)
    for w in bench["workloads"]:
        cell = run.resolve(bench, w["name"], ROOT)
        assert os.path.isfile(os.path.join(
            ROOT, "etlbench", "modes", f"{cell['traffic']['mode']}.py"))
        assert cell["per_layer"] and any(
            m["name"] != "setup_s" for m in cell["e2e"])
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "etlbench", "metrics",
                                           f"{m['name']}.py"))
