"""Multi-pod dry run: every (arch x shape) cell's step traced on one rank of
a fake 256 / 512-rank world, and the roofline inputs read from it (the
JAX package's ``launch/dryrun.py``).

The reference lowers and compiles each cell on 512 placeholder XLA
devices.  Here each cell gets its own fake default process group
(``torch.testing._internal.distributed.fake_pg``: any world size in one
process, every collective returns at once), the production mesh over it
(``launch.mesh.make_production_mesh``), and one rank's step
(``launch.cells.plan_cell``) run once under a ``FakeTensorMode``: no
parameter, activation or collective buffer is allocated.  The run is
counted two ways at once, in one dispatch mode:

- ``hlo_cost.CostMode``'s counts: flops, transcendentals, the bytes
  eager moves, and the collective inventory (``hlo_analysis``); beside
  them
  ``FlopCounterMode``'s matmul-family total, the cross-check
  (``flop_counter``; the reference's ``xla_cost_analysis``, which counts
  a loop body once as this one does);
- ``torch.distributed._tools.mem_tracker.MemTracker``: the peak of the
  bytes live on the device over the step, ``memory.per_device_bytes``.
  This is an estimate of what PyTorch's caching allocator would hold (live
  tensors, with no fragmentation or rounding), not XLA's buffer
  assignment, so it is not the reference's number.

``memory.argument_size_in_bytes`` is this rank's parameters, optimizer
state, batch and cache, exact from the fake shapes.  Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --arch llama3_405b --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --all \\
        --both-meshes

``--device`` is the fake tensors' device: ``cuda`` (the default) on a
GPU machine, ``cpu`` elsewhere.  Each cell writes
``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``; finished cells
are skipped unless ``--force``.  A failed cell is recorded with its error
and counted.  The dry run refuses to start where a process group is
initialised already, and fails where the fake process group is missing
from this torch build.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import ALL_SHAPES
from repro_torch.configs.registry import canonical
from repro_torch.distributed import hlo_analysis, hlo_cost
from repro_torch.distributed import sharding as shd
from repro_torch.launch.cells import plan_cell, tensor_bytes
from repro_torch.launch.mesh import make_production_mesh

SHAPES = {s.name: s for s in ALL_SHAPES}
OUT_DIR = "experiments/dryrun_torch"


@contextlib.contextmanager
def fake_world(mesh_shape: tuple, device: str, rank: int = 0):
    """Within: a fake default process group of ``prod(mesh_shape)`` ranks,
    this process its ``rank``, and its mesh: the production mesh for
    (16, 16) and (2, 16, 16), else a ``DeviceMesh`` of ``mesh_shape``
    named ``("data", "model")`` (or ``("pod", "data", "model")``).  The
    group is destroyed on exit and the active mesh cleared."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is initialised: the dry run "
                           "makes its own fake one and runs without another")
    mesh_shape = tuple(mesh_shape)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(mesh_shape))
    try:
        if mesh_shape in ((16, 16), (2, 16, 16)):
            yield make_production_mesh(multi_pod=len(mesh_shape) == 3,
                                       device=device)
        else:
            names = ("pod", "data", "model")[-len(mesh_shape):]
            yield init_device_mesh(device, mesh_shape,
                                   mesh_dim_names=names)
    finally:
        shd.set_active_mesh(None)
        dist.destroy_process_group()


def _tracer():
    """One dispatch mode for the traced step: ``MemTracker``'s peak and
    ``hlo_cost``'s counts (``.cost``, a ``CostMode`` never entered) in a
    single pass, since every mode on the stack adds its own dispatch to
    each op.  ``MemTracker``'s per-module statistics are left out: they
    refuse a module that runs twice in a step (a microbatched step's
    blocks)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class Tracer(MemTracker):
        def __init__(self):
            super().__init__()
            self.cost = hlo_cost.CostMode()

        def _pre_fw_hook(self, module, inputs):
            pass

        def _post_fw_hook(self, module, inputs, outputs):
            pass

        def _pre_bw_hook(self, module, args):
            pass

        def _post_bw_hook(self, module, args):
            pass

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = hlo_cost.decomposed(self, func, args, kwargs)
            if out is NotImplemented:
                out = super().__torch_dispatch__(func, types, args, kwargs)
                if out is not NotImplemented:  # a DTensor's: its local ops
                    self.cost.count(func, args, kwargs, out)  # come next
            return out

    return Tracer()


def _peak_bytes(tracker) -> tuple:
    """``(peak bytes on the device, {category: bytes at the peak})`` of a
    ``MemTracker`` (the device with the most)."""
    snap = tracker.get_tracker_snapshot("peak")
    dev = max(snap, key=lambda d: snap[d].get("Total", 0))
    cats = {str(k): int(v) for k, v in snap[dev].items() if v}
    return int(snap[dev].get("Total", 0)), cats


def trace_plan(plan) -> dict:
    """One run of ``plan``'s step under its fake mode, counted: ``{"cost",
    "collectives", "flop_counter", "memory"}`` (the record's keys)."""
    with plan.fake_mode:
        args = plan.make_args()
        # train: (state, batch); prefill: (batch,); decode: (cache,
        # tokens, pos)
        batch, cache = (args[1], args[0]) if plan.kind == "decode" \
            else (args[-1], None)
        arg_bytes = {"param_bytes": tensor_bytes(plan.module),
                     "opt_bytes": tensor_bytes(plan.opt),
                     "batch_bytes": tensor_bytes(batch),
                     "cache_bytes": tensor_bytes(cache)}
        tracker = _tracer()
        tracker.track_external(plan.module,
                               *_tensors((plan.opt, batch, cache)))
        with tracker:
            plan.step(*args)
    peak, cats = _peak_bytes(tracker)
    c = tracker.cost.summary()
    memory = dict(argument_size_in_bytes=sum(arg_bytes.values()),
                  per_device_bytes=peak, peak_by_category=cats, **arg_bytes)
    return {"cost": {k: c[k] for k in ("flops", "transcendentals",
                                       "bytes_accessed")},
            "collectives": {k: c[k] for k in ("per_op", "collective_bytes",
                                              "wire_bytes",
                                              "n_collectives")},
            "flop_counter": {"flops": tracker.cost.flop_counter},
            "memory": memory}


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def run_cell(arch: str, shape, *, multi_pod: bool = False,
             mesh_shape: tuple = None, out_dir: str = OUT_DIR,
             force: bool = False, tcfg=None, tag: str = "",
             device: str = "cuda") -> dict:
    """Dry-run one cell and write its record: ``shape`` a name of
    ``ALL_SHAPES`` or a ``ShapeCfg``; the production mesh (16 x 16, or 2
    x 16 x 16 with ``multi_pod``) unless ``mesh_shape`` names another."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh_shape = tuple(mesh_shape or ((2, 16, 16) if multi_pod
                                      else (16, 16)))
    mesh_name = {(16, 16): "pod16x16", (2, 16, 16): "pod2x16x16"}.get(
        mesh_shape, "x".join(map(str, mesh_shape)))
    cell_id = f"{canonical(arch)}__{shape.name}__{mesh_name}" + (
        f"__{tag}" if tag else "")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell_id + ".json")
    if os.path.exists(path) and not force:
        with open(path) as fh:
            return json.load(fh)

    rec = {"cell": cell_id, "arch": canonical(arch), "shape": shape.name,
           "mesh": list(mesh_shape), "chips": math.prod(mesh_shape),
           "device": device, "ok": False}
    try:
        with fake_world(mesh_shape, device) as mesh:
            t0 = time.perf_counter()
            plan = plan_cell(arch, shape, mesh, tcfg=tcfg)
            rec["plan_s"] = round(time.perf_counter() - t0, 2)
            rec["kind"] = plan.kind
            rec["serve_fsdp"] = plan.serve_fsdp
            t1 = time.perf_counter()
            rec.update(trace_plan(plan))
            rec["trace_s"] = round(time.perf_counter() - t1, 2)
        flops = rec["cost"]["flops"]
        rec["model_flops"] = plan.model_flops
        # the traced step is one rank's: model_flops is global —
        # normalize for the useful-compute ratio
        per_dev_model_flops = plan.model_flops / rec["chips"]
        rec["hlo_vs_model_flops"] = (
            flops / per_dev_model_flops if per_dev_model_flops else None)
        coll = rec["collectives"]
        rec["roofline"] = hlo_analysis.roofline_terms(
            flops, rec["cost"]["bytes_accessed"], coll["collective_bytes"],
            coll["wire_bytes"], rec["chips"])
        rec["ok"] = True
    except Exception as e:  # record failures — they are bugs to fix
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-2000:]

    with open(path, "w") as fh:
        json.dump(rec, fh, indent=1)
    if rec["ok"]:
        r = rec["roofline"]
        print(f"[dryrun] {cell_id}: OK trace={rec['trace_s']}s "
              f"mem/dev={rec['memory']['per_device_bytes']/2**30:.2f}GiB "
              f"compute={r['t_compute_s']:.4f}s "
              f"memory={r['t_memory_s']:.4f}s "
              f"wire={r['t_wire_s']:.4f}s dominant={r['dominant']}",
              flush=True)
    else:
        print(f"[dryrun] {cell_id}: FAIL {rec['error'][:300]}", flush=True)
    return rec


def main(argv=None):
    from repro_torch.launch.cells import iter_cells

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda, or cpu")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    todo = []
    if args.all:
        for arch, shape, skip in iter_cells():
            if skip:
                print(f"[dryrun] SKIP {arch}__{shape.name}: {skip}")
                continue
            todo.append((arch, shape.name))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        todo.append((args.arch, args.shape))

    failures = 0
    for mp in meshes:
        for arch, shape in todo:
            rec = run_cell(arch, shape, multi_pod=mp, out_dir=args.out,
                           force=args.force, device=args.device)
            failures += 0 if rec["ok"] else 1
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
