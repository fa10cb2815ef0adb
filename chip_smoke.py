#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. device      — require CUDA; the card's name and power limit (nvidia-smi).
2. build       — compile ``src/repro_torch/kernels/csrc/*.cu`` with nvcc
                 for sm_90a, one nvcc per source, all at once (into
                 ``build/repro_torch/``), and load the library.
3. parity      — every kernel against its plain PyTorch version on the card
                 (integers bit-equal, floats rtol 1e-5), with its time (CUDA
                 events, L2 flushed before each launch) beside the plain
                 version's, one PyTorch library call's where one computes
                 the same function, and the bytes/operations bound.  Inputs:
                 one 65536-row synthetic Criteo batch through Pipeline III at
                 vocab 524288 (grouped, optimize="off" and fuse="off" plans)
                 and at vocab 4194304 (its 16 MiB table is HBM-placed, so
                 the sparse output and the fit take the staged kernels).
                 The tables are fitted on the CPU through the plain versions,
                 so no kernel runs before it meets its plain version.
4. main        — EtlJob(Pipeline III, Source.synth("I"), backend="cuda") ->
                 fit (one fit launch per chunk) -> 16 DLRM training steps at
                 DLRMConfig(vocab_size=524289) (1.75 B parameters; one group
                 launch per batch).  The first batch is checked against the
                 numpy oracle.
5. ungrouped   — the same pipeline with optimize="off" on two batches:
                 three output launches per batch.
6. staged_main — the large-vocabulary path: Pipeline III at vocab 4194304
                 -> fit over 4 chunks (fused_stage + vocab_build_chunk per
                 chunk) -> 16 DLRM steps at facebookresearch/dlrm's Criteo
                 Kaggle width (d_emb 16, bottom MLP 13-512-256-64-16, top MLP
                 512-256-1; 1.75 B parameters), each batch one group launch
                 (dense + label) and fused_stage -> vocab_lookup -> packer
                 for sparse.  First batch against the numpy oracle.
7. staged_off  — vocab 524288 with fuse="off" (the stage-at-a-time
                 baseline) on two batches: staged fit bit-equal to the fused
                 fit, outputs against the numpy oracle, and one batch's apply
                 time grouped vs staged.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and last the
``{"ok": true, "device": ...}`` line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
B = 65536                     # rows per batch (paper_pipeline default)
LARGE_VOCAB = 4194304         # 16 MiB table: over the 4 MiB VMEM budget
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM, outside the tensor cores
REPEATS = 20
SOURCES = {"group_dataflow": "dataflow.cu", "output_dataflow": "dataflow.cu",
           "fit_dataflow": "dataflow.cu", "fused_stage": "stage.cu",
           "packer": "stage.cu", "vocab_build_chunk": "vocab.cu",
           "vocab_lookup": "vocab.cu"}
REPLACES = {"group_dataflow": "src/repro/kernels/dataflow.py:367",
            "output_dataflow": "src/repro/kernels/dataflow.py:299",
            "fit_dataflow": "src/repro/kernels/dataflow.py:440",
            "fused_stage": "src/repro/kernels/dataflow.py:93",
            "packer": "src/repro/kernels/dataflow.py:149",
            "vocab_build_chunk": "src/repro/kernels/vocab.py:86",
            "vocab_lookup": "src/repro/kernels/vocab.py:137"}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.pipeline import paper_pipeline
    from repro_torch.data.source import Source
    from repro_torch.kernels import backend
    from repro_torch.kernels import dataflow as df
    from repro_torch.models import dlrm
    from repro_torch.session import EtlJob
    from repro_torch.training.train_loop import (LoopConfig, TrainState,
                                                 make_train_step, train_loop)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = backend.build_library(verbose=True)
    backend.load_library()
    emit({"phase": "build", "library": os.path.relpath(lib_path, HERE),
          "seconds": time.perf_counter() - t0})

    # ---- parity + timing at full size ----------------------------------
    fit_chunks = list(Source.synth("I", rows=4 * B, batch_size=B))
    raw = next(iter(Source.synth("I", rows=B, batch_size=B, seed=11)))
    tmpl = paper_pipeline("III", batch_size=B)
    tmpl_large = paper_pipeline("III", large_vocab=LARGE_VOCAB, batch_size=B)
    states = {}
    for key, t in (("III", tmpl), ("large", tmpl_large)):
        host = t.compile("cuda", device="cpu")  # the plain versions
        host.fit(iter(fit_chunks))
        states[key] = host.state
    grouped = tmpl.compile("cuda")
    solo = tmpl.compile("cuda", optimize="off")
    off = tmpl.compile("cuda", fuse="off")
    large = tmpl_large.compile("cuda")
    for p in (grouped, solo, off):
        p.state = states["III"]
    large.state = states["large"]
    if large.lowering_report()["sparse"]["path"] != "staged":
        raise AssertionError(f"vocab {LARGE_VOCAB}: {large.lowering_report()}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        total = 0.0
        for _ in range(REPEATS):
            flush.zero_()  # launch with a cold 50 MB L2, as after an H2D copy
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            total += e0.elapsed_time(e1)
        return total / REPEATS

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def tensor_bytes(xs) -> int:
        return sum(x.numel() * x.element_size() for x in xs
                   if isinstance(x, torch.Tensor))

    def work(kname, fn, args, got) -> tuple:
        """(bytes, operations) the function needs for these inputs."""
        if kname == "vocab_lookup":  # a gather reads the rows it needs
            ids, table = args[0], args[1]
            hit = ids[(ids >= 0) & (ids < table.numel())]
            n_rows = int(torch.unique(hit).numel())
            nbytes = tensor_bytes([ids] + list(got)) + 4 * n_rows
            return nbytes, ids.numel()
        nbytes = tensor_bytes(list(args) + list(got))
        if kname == "fused_stage":
            prog = fn.program
            per = len(prog.instrs) + prog.hex_width
            return nbytes, got[0].numel() * per
        if kname in ("packer", "vocab_build_chunk"):
            return nbytes, got[0].numel() if kname == "packer" \
                else args[0].numel()
        prog = fn.program  # the tile program of the dataflow kernels
        ops = sum(B * prog.slots[i.dst].width for i in prog.instrs)
        ops += B * sum(prog.out_cols)
        if prog.value_slot >= 0:
            ops += 2 * B * prog.slots[prog.value_slot].width
        return nbytes, ops

    def library_call(kname, args):
        """One PyTorch call that computes the same function, or None."""
        if kname == "vocab_build_chunk":
            vals, cap = args
            if bool(((vals < 0) | (vals >= cap)).any()):
                return None
            idx = vals.long()
            pos = torch.arange(vals.numel(), dtype=torch.int32, device="cuda")
            out = torch.full((cap,), df.ABSENT32, dtype=torch.int32,
                             device="cuda")
            # amin is idempotent: repeating the call recomputes the same table
            return lambda: out.scatter_reduce_(0, idx, pos, "amin")
        if kname == "vocab_lookup":
            ids, table, n = args
            resolved = torch.where(table >= 0, table, n)
            idx = ids.long()
            return lambda: torch.take(resolved, idx)
        return None

    kernels: dict = {}
    launches = []
    for p in (grouped, solo, large, off):
        launches += p.dataflow_launches(raw, "apply")
    for p in (grouped, large, off):
        launches += p.dataflow_launches(raw, "fit")
    for kname, what, fn, args in launches:
        got = as_tuple(fn(*args))
        want = as_tuple(fn.plain(*args))
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{kname}/{what}: {g.dtype}{list(g.shape)}"
                                     f" vs plain {w.dtype}{list(w.shape)}")
            if g.dtype.is_floating_point:
                torch.testing.assert_close(g, w, rtol=1e-5, atol=0,
                                           equal_nan=True)
                both = torch.isfinite(g) & torch.isfinite(w)
                d = (g[both].double() - w[both].double()).abs()
                err = max(err, float(d.max()) if d.numel() else 0.0)
            elif not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"{kname}/{what}: {bad} integer "
                                     "entries differ from the plain version")
        nbytes, ops = work(kname, fn, args, got)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        ms = time_ms(lambda: fn(*args))
        plain_ms = time_ms(lambda: fn.plain(*args))
        lib = library_call(kname, args)
        rec = {"name": kname, "what": list(what) if isinstance(what, tuple)
               else what, "dtype": str(got[0].dtype).replace("torch.", ""),
               "shape": list(got[0].shape), "bytes": nbytes, "ops": ops,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": time_ms(lib) if lib else None,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "gbytes_per_s": nbytes / (ms * 1e-3) / 1e9}
        emit({"phase": "parity", **rec})
        # one entry per kernel: its largest instance on these plans
        if kname not in kernels or rec["bytes"] > kernels[kname]["bytes"]:
            kernels[kname] = rec
    del flush
    for k in df.LAUNCHES:
        if k not in kernels:
            raise AssertionError(f"kernel {k} was never held against its "
                                 "plain version")

    def check_against_oracle(t, state, raw_batch, got: dict, what: str):
        oracle = t.compile("numpy")
        oracle.state = state
        want = oracle(raw_batch)
        for k, w in want.items():
            g = got[k].cpu().numpy()
            if np.issubdtype(w.dtype, np.integer):
                np.testing.assert_array_equal(g, w, err_msg=f"{what}/{k}")
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5,
                                           err_msg=f"{what}/{k}")

    def train_phase(t, cfg, n_batches: int, n_fit: int) -> dict:
        """EtlJob -> fit -> n_batches DLRM steps; launch counts of the fit
        and of the training run, each zeroed just before it."""
        job = EtlJob(t, Source.synth("I", rows=n_batches * B, batch_size=B,
                                     seed=11),
                     backend="cuda",
                     fit_source=Source.synth("I", rows=n_fit * B,
                                             batch_size=B))
        df.reset_launch_counts()
        t0 = time.perf_counter()
        job.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = dict(df.LAUNCHES)
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = dlrm.DLRM(cfg, generator=gen)
        tcfg = TrainConfig(lr=1e-3)
        state = TrainState.create(model, tcfg)
        step = make_train_step(dlrm.loss_fn, tcfg)
        first: dict = {}
        losses: list = []

        def tapped_step(st, batch):
            if not first:
                first.update({k: v.clone() for k, v in batch.items()})
            return step(st, batch)

        torch.cuda.reset_peak_memory_stats()
        df.reset_launch_counts()
        t0 = time.perf_counter()
        with job.batches() as ex:
            state = train_loop(state, tapped_step, ex,
                               LoopConfig(total_steps=n_batches, log_every=1),
                               on_metrics=lambda m: losses.append(m["loss"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        apply_launches = dict(df.LAUNCHES)
        stats = job.stats()
        if not (stats.consumed == n_batches == state.step):
            raise AssertionError(f"delivered {stats.consumed}, steps "
                                 f"{state.step}, want {n_batches}")
        if not all(math.isfinite(x) for x in losses) or len(losses) != n_batches:
            raise AssertionError(f"losses {losses}")
        check_against_oracle(t, job.state, raw, first, "first batch")
        train_s = wall - stats.consumer_wait_s
        out = {"rows": n_batches * B, "steps": state.step,
               "fit_seconds": fit_s, "fit_chunks": n_fit,
               "n_unique": max(job.state.n_unique.values()),
               "params": cfg.param_count(), "wall_seconds": wall,
               "rows_per_s": n_batches * B / wall,
               "trainer_utilization": stats.trainer_utilization(train_s),
               "consumer_wait_s": stats.consumer_wait_s,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "loss_first": losses[0], "loss_last": losses[-1],
               "fit_launches": fit_launches, "launches": apply_launches,
               "stages": stats.stage_breakdown()}
        del state, model, job, first
        torch.cuda.empty_cache()
        return out

    def expect(launches: dict, want: dict, what: str) -> None:
        got = {k: v for k, v in launches.items() if v}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, want {want}")

    # ---- main path: EtlJob -> fit -> DLRM training -----------------------
    n_batches, n_fit = 16, 4
    main = train_phase(tmpl, dlrm.DLRMConfig(vocab_size=524289), n_batches,
                       n_fit)
    expect(main["fit_launches"], {"fit_dataflow": n_fit}, "main fit")
    expect(main["launches"], {"group_dataflow": n_batches}, "main apply")
    emit({"phase": "main", **main})

    # ---- ungrouped path: one output kernel per output --------------------
    job2 = EtlJob(tmpl, Source.synth("I", rows=2 * B, batch_size=B, seed=12),
                  backend="cuda", optimize="off")
    job2.compiled.state = states["III"]
    df.reset_launch_counts()
    with job2.batches() as ex:
        n2 = sum(1 for _ in ex)
    torch.cuda.synchronize()
    solo_launches = dict(df.LAUNCHES)
    if n2 != 2:
        raise AssertionError(f"ungrouped path: {n2} batches")
    expect(solo_launches, {"output_dataflow": 3 * n2}, "ungrouped")
    emit({"phase": "ungrouped", "batches": n2, "launches": solo_launches})

    # ---- staged main path: HBM-placed 4 M-entry vocabulary ---------------
    # facebookresearch/dlrm bench/dlrm_s_criteo_kaggle.sh widths
    cfg_kaggle = dlrm.DLRMConfig(vocab_size=LARGE_VOCAB + 1, d_emb=16,
                                 bot_mlp=(512, 256, 64, 16),
                                 top_mlp=(512, 256, 1))
    staged = train_phase(tmpl_large, cfg_kaggle, n_batches, n_fit)
    expect(staged["fit_launches"], {"fused_stage": n_fit,
                                    "vocab_build_chunk": n_fit},
           "staged_main fit")
    expect(staged["launches"], {k: n_batches for k in (
        "group_dataflow", "fused_stage", "vocab_lookup", "packer")},
        "staged_main apply")
    emit({"phase": "staged_main", **staged})

    # ---- staged_off: every output and the fit stage at a time ------------
    job3 = EtlJob(tmpl, Source.synth("I", rows=2 * B, batch_size=B, seed=12),
                  backend="cuda", fuse="off",
                  fit_source=Source.synth("I", rows=2 * B, batch_size=B))
    df.reset_launch_counts()
    job3.fit()
    torch.cuda.synchronize()
    off_fit = dict(df.LAUNCHES)
    expect(off_fit, {"fused_stage": 2, "vocab_build_chunk": 2},
           "staged_off fit")
    fused_fit = tmpl.compile("cuda")
    fused_fit.fit(iter(Source.synth("I", rows=2 * B, batch_size=B)))
    for vid, t in fused_fit.state.tables.items():
        np.testing.assert_array_equal(job3.state.tables[vid], t,
                                      err_msg="staged fit vs fused fit")
    first3: dict = {}
    df.reset_launch_counts()
    with job3.batches() as ex:
        for batch in ex:
            if not first3:
                first3 = {k: v.clone() for k, v in batch.items()}
    torch.cuda.synchronize()
    off_apply = dict(df.LAUNCHES)
    expect(off_apply, {"fused_stage": 4, "vocab_lookup": 2, "packer": 4},
           "staged_off apply")
    raw3 = next(iter(Source.synth("I", rows=B, batch_size=B, seed=12)))
    check_against_oracle(tmpl, job3.state, raw3, first3, "staged_off")
    staged_p = job3.compiled
    fused_fit.state = staged_p.state
    cols = staged_p._device_columns(raw3)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    apply_ms = {}
    for label, p in (("grouped", fused_fit), ("staged", staged_p),
                     ("staged_again", staged_p), ("grouped_again", fused_fit)):
        tables = p._device_tables(p.state)
        apply_ms[label] = time_ms(lambda: p._apply_fn(tables, cols))
    del flush
    emit({"phase": "staged_off", "batches": 2, "fit_launches": off_fit,
          "launches": off_apply,
          "lowering": {k: v["path"]
                       for k, v in staged_p.lowering_report().items()},
          "apply_ms": apply_ms})

    path_launches = {"group_dataflow": main["launches"]["group_dataflow"],
                     "fit_dataflow": main["fit_launches"]["fit_dataflow"],
                     "output_dataflow": solo_launches["output_dataflow"]}
    for k in ("fused_stage", "vocab_build_chunk", "vocab_lookup", "packer"):
        path_launches[k] = staged["fit_launches"][k] + staged["launches"][k]
    out = []
    for name in REPLACES:
        r = kernels[name]
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/" + SOURCES[name],
                    "replaces": REPLACES[name],
                    "launches": path_launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"kernels": out})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
