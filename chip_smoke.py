#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. device   — require CUDA; the card's name and power limit (nvidia-smi).
2. build    — compile ``src/repro_torch/kernels/csrc/*.cu`` with nvcc for
              sm_90a (into ``build/repro_torch/``) and load it.
3. parity   — Pipeline III (vocab 524288) on one 65536-row synthetic
              Criteo batch with a fitted table: every dataflow kernel
              (group, output, fit) against its plain PyTorch version on the
              card (integers bit-equal, floats rtol 1e-5), and its time
              (CUDA events, L2 flushed before each launch) beside the plain
              version's and the bytes/operations bound.
4. main     — the port's main path at full width: EtlJob(Pipeline III,
              Source.synth("I"), backend="cuda") -> fit -> 16 DLRM training
              steps at DLRMConfig(vocab_size=524289) (1.75 B parameters).
              Launch counts are zeroed before and read after: one fit launch
              per fit chunk, one group launch per delivered batch.  The first
              delivered batch is checked against the numpy oracle.
5. ungrouped — the same pipeline with optimize="off" (each output its own
              kernel) on two batches: three output launches per batch.

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
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM, outside the tensor cores
REPEATS = 20


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
    fit_src = Source.synth("I", rows=4 * B, batch_size=B)
    raw = next(iter(Source.synth("I", rows=B, batch_size=B, seed=11)))
    tmpl = paper_pipeline("III", batch_size=B)
    grouped = tmpl.compile("cuda")
    grouped.fit(iter(fit_src))
    solo = tmpl.compile("cuda", optimize="off")
    solo.state = grouped.state
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

    def plain_of(kname, prog, args):
        if kname == "fit_dataflow":
            return lambda: df.fit_dataflow_plain(prog, args)
        srcs, tbls = args[:prog.n_src], args[prog.n_src:]
        return lambda: df.apply_dataflow_plain(prog, srcs, tbls)

    def op_count(prog, rows) -> int:
        n = sum(rows * prog.slots[i.dst].width for i in prog.instrs)
        n += rows * sum(prog.out_cols)
        if prog.value_slot >= 0:
            n += 2 * rows * prog.slots[prog.value_slot].width
        return n

    src_of = "src/repro_torch/kernels/csrc/dataflow.cu"
    replaces = {"group_dataflow": "src/repro/kernels/dataflow.py:367",
                "output_dataflow": "src/repro/kernels/dataflow.py:299",
                "fit_dataflow": "src/repro/kernels/dataflow.py:440"}
    kernels: dict = {}
    launches = (grouped.dataflow_launches(raw, "apply")
                + solo.dataflow_launches(raw, "apply")
                + grouped.dataflow_launches(raw, "fit"))
    for kname, what, fn, args in launches:
        got = as_tuple(fn(*args))
        want = as_tuple(plain_of(kname, fn.program, args)())
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
        rows = B
        in_bytes = sum(a.numel() * a.element_size() for a in args)
        out_bytes = sum(g.numel() * g.element_size() for g in got)
        ops = op_count(fn.program, rows)
        t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        ms = time_ms(lambda: fn(*args))
        plain_ms = time_ms(plain_of(kname, fn.program, args))
        rec = {"name": kname, "what": list(what) if isinstance(what, tuple)
               else what, "rows": rows, "tile_rows": fn.program.tile_rows(),
               "smem_bytes": fn.program.smem_bytes(fn.program.tile_rows()),
               "bytes": in_bytes + out_bytes, "ops": ops,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "gbytes_per_s": (in_bytes + out_bytes) / (ms * 1e-3) / 1e9}
        emit({"phase": "parity", **rec})
        # one entry per kernel: the largest instance (output_dataflow runs
        # once per output; keep the sparse one, which carries the lookup)
        if kname not in kernels or rec["bytes"] > kernels[kname]["bytes"]:
            kernels[kname] = rec
    del flush
    for k in df.LAUNCHES:
        if k not in kernels:
            raise AssertionError(f"kernel {k} was never held against its "
                                 "plain version")

    # ---- main path: EtlJob -> fit -> DLRM training -----------------------
    n_batches, n_fit = 16, 4
    tmpl = paper_pipeline("III", batch_size=B)
    job = EtlJob(tmpl, Source.synth("I", rows=n_batches * B, batch_size=B,
                                    seed=11),
                 backend="cuda",
                 fit_source=Source.synth("I", rows=n_fit * B, batch_size=B))
    df.reset_launch_counts()
    t0 = time.perf_counter()
    job.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    cfg = dlrm.DLRMConfig(vocab_size=524289)
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
    t0 = time.perf_counter()
    with job.batches() as ex:
        state = train_loop(state, tapped_step, ex,
                           LoopConfig(total_steps=n_batches, log_every=1),
                           on_metrics=lambda m: losses.append(m["loss"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = dict(df.LAUNCHES)
    stats = job.stats()
    if main_launches["fit_dataflow"] != n_fit:
        raise AssertionError(f"fit launches {main_launches} != {n_fit} chunks")
    if not (stats.consumed == n_batches == main_launches["group_dataflow"]
            == state.step):
        raise AssertionError(f"group launches {main_launches}, delivered "
                             f"{stats.consumed}, steps {state.step}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != n_batches:
        raise AssertionError(f"losses {losses}")
    oracle = tmpl.compile("numpy")
    oracle.state = job.state
    want = oracle(raw)
    for k, w in want.items():
        g = first[k].cpu().numpy()
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=k)
    train_s = wall - stats.consumer_wait_s
    emit({"phase": "main", "rows": n_batches * B, "steps": state.step,
          "fit_seconds": fit_s, "fit_chunks": n_fit,
          "n_unique": max(job.state.n_unique.values()),
          "params": cfg.param_count(), "wall_seconds": wall,
          "rows_per_s": n_batches * B / wall,
          "trainer_utilization": stats.trainer_utilization(train_s),
          "consumer_wait_s": stats.consumer_wait_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "loss_first": losses[0], "loss_last": losses[-1],
          "launches": main_launches,
          "stages": stats.stage_breakdown()})
    del state, model, job, first
    torch.cuda.empty_cache()

    # ---- ungrouped path: one output kernel per output --------------------
    job2 = EtlJob(tmpl, Source.synth("I", rows=2 * B, batch_size=B, seed=12),
                  backend="cuda", optimize="off")
    job2.compiled.state = oracle.state
    df.reset_launch_counts()
    with job2.batches() as ex:
        n2 = sum(1 for _ in ex)
    torch.cuda.synchronize()
    solo_launches = dict(df.LAUNCHES)
    if n2 != 2 or solo_launches["output_dataflow"] != 3 * n2:
        raise AssertionError(f"ungrouped path: {n2} batches, {solo_launches}")
    emit({"phase": "ungrouped", "batches": n2, "launches": solo_launches})

    path_launches = {"group_dataflow": main_launches["group_dataflow"],
                     "fit_dataflow": main_launches["fit_dataflow"],
                     "output_dataflow": solo_launches["output_dataflow"]}
    out = []
    for name in ("group_dataflow", "output_dataflow", "fit_dataflow"):
        r = kernels[name]
        out.append({"name": name, "route": "cuda", "source": src_of,
                    "replaces": replaces[name],
                    "launches": path_launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": None})
    emit({"kernels": out})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
