"""A whole run without the look for a card (on the CPU, through the
kernels' plain versions, at a size a test holds) comes out correct, and
comes out not correct with the timed path broken underneath: a step that
leaves the state unchanged, the loss taken over half of the batch, an
answer altered where the transform produces it.  The controls (the
reference in TF32, the ETL's dense chain in bfloat16) fail a limit too.
The card's own run is the ``cuda`` test at the end."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from etlbench import control, drive, run
from etlbench.conftest import tiny_config, tiny_traffic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def execute(cell: str, seed: int = 5, trace: bool = False) -> dict:
    """A whole run of ``cell`` at the tiny size; a cell that BENCHMARK.json
    does not declare (``dlrm_kaggle.etl`` and ``dlrm_mlperf.online``, left
    out for their spread, with their modes, mixes and readers kept) is
    read as ``<config>.<traffic>``."""
    bench = run.load_bench(ROOT)
    if cell in {w["name"] for w in bench["workloads"]}:
        c = run.resolve(bench, cell, ROOT)
        name, mix = c["workload"]["config"], c["workload"]["traffic"]
        readers = {n: drive.load_file_module(p, "etlbench_t_" + n.replace(
            ".", "_")) for n, p in c["readers"].items()}
    else:
        (name, mix), readers = cell.split("."), {}
    cfg, traffic = tiny_config(name), tiny_traffic(mix)
    return drive.execute(cell, cfg, traffic, seed, 0.3, trace, "cpu",
                         time.perf_counter(), readers)


def failing(out: dict) -> set:
    return {k for k, c in out["checks"].items() if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("cell", ["dlrm_mlperf.train", "dlrm_kaggle.etl",
                                  "dlrm_mlperf.online"])
def test_a_sound_run_is_correct(cell):
    out = execute(cell, seed=2 ** 31 + 77)
    assert out["correct"] and out["attempted"] > 0, out["checks"]
    assert not failing(out)


@pytest.mark.parametrize("cell", ["dlrm_mlperf.train", "dlrm_mlperf.online"])
def test_state_left_unchanged_is_caught(monkeypatch, cell):
    from repro_torch.training import train_loop as tl

    def unchanged(params, grads, state, step, tcfg):
        return torch.zeros(())
    monkeypatch.setattr(tl, "opt_update", unchanged)
    out = execute(cell)
    assert not out["correct"]
    assert {"grad_gap", "update_gap"} <= failing(out)


@pytest.mark.parametrize("cell", ["dlrm_mlperf.train", "dlrm_mlperf.online"])
def test_half_the_batch_is_caught(monkeypatch, cell):
    from repro_torch.models import dlrm

    whole = dlrm.loss_fn

    def half(model, batch):
        n = batch["label"].shape[0] // 2
        return whole(model, {k: v[:n] for k, v in batch.items()})
    monkeypatch.setattr(dlrm, "loss_fn", half)
    out = execute(cell)
    assert not out["correct"] and "loss_gap" in failing(out)


@pytest.mark.parametrize("cell", ["dlrm_mlperf.train", "dlrm_kaggle.etl",
                                  "dlrm_mlperf.online"])
def test_an_altered_answer_is_caught(monkeypatch, cell):
    from repro_torch.core.compiler import CompiledPipeline

    produce = CompiledPipeline.apply_versioned

    def altered(self, raw):
        out, version = produce(self, raw)
        out = dict(out)
        out["sparse"] = out["sparse"].clone()
        out["sparse"][0, 0] += 1
        return out, version
    monkeypatch.setattr(CompiledPipeline, "apply_versioned", altered)
    out = execute(cell)
    assert not out["correct"] and "batch_mismatch" in failing(out)


def test_a_refit_over_part_of_its_window_is_caught(monkeypatch):
    from repro_torch.core.compiler import CompiledPipeline

    whole = CompiledPipeline.fit_incremental

    def newest_only(self, batch_iter):
        return whole(self, iter(list(batch_iter)[-1:]))
    monkeypatch.setattr(CompiledPipeline, "fit_incremental", newest_only)
    out = execute("dlrm_mlperf.online", seed=9)
    assert out["readings"]["refits"] >= 1
    assert not out["correct"] and "refit_mismatch" in failing(out)


def test_controls_fail_a_limit():
    cfg = tiny_config("dlrm_mlperf")
    lines = control.readings(cfg, tiny_traffic("train"), 11, "cpu")
    limits = cfg["limits"]
    by = {line["control"]: line for line in lines}
    for name in ("tf32", "half_batch", "bf16_dense"):
        assert any(by[name][k] > limits[k] for k in by[name]
                   if k in limits), (name, by[name])


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(cuda_device, tmp_path):
    done = subprocess.run(
        [sys.executable, "etlbench/run.py", "--workload", "dlrm_kaggle.train",
         "--seed", "3", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-2000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_tf32_control_fails_on_the_card(cuda_device):
    cfg = tiny_config("dlrm_mlperf")
    cfg["arch_mlp_bot"] = "13-512-256-128"
    cfg["arch_mlp_top"] = "1024-1024-512-256-1"
    cfg["arch_sparse_feature_size"] = 128
    cfg["assumed"]["batch_rows"] = 4096
    lines = control.readings(cfg, tiny_traffic("train"), 11, cuda_device,
                             controls=("tf32",))
    tf32 = lines[0]
    assert any(tf32[k] > cfg["limits"][k] for k in tf32 if k in cfg["limits"])
