"""Training launcher: ETL-fed, checkpointed, fault-tolerant LM training.

On the card (the default: ``--device`` is CUDA, and the ETL runs the
hand-written kernels, ``--etl-backend cuda``)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_3b \
        --steps 8 --batch 8 --seq 1024 --ckpt-dir ckpt

On the CPU, at the smoke-scale config::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --reduced --arch llama3_2_3b --steps 4 --batch 4 --seq 32

Raw LM event logs (``Source.lm_events``) go through ``lm_token_pipeline``
(SigridHash into the model's vocabulary: one group dataflow launch a batch
on ``cuda``) in an ``EtlJob``'s staged executor, overlapped with the train
steps; the preset's microbatching (``launch/presets.py``) splits each batch
into gradient-accumulation chunks.  Every run is restartable: on startup
the newest committed checkpoint under ``--ckpt-dir`` is restored if there is
one (``resume_or_init``), and a retriable failure restarts the loop from it
(``run_with_restarts``).

Every decoder-only family trains: dense, MoE, VLM, SSM and hybrid, with the
presets' AdamW or Adafactor.  As the reference's launcher does, it feeds
tokens and labels only, so a VLM trains on text alone and an enc-dec model,
which needs frames, is refused with a ``ValueError`` before any ETL job
starts (the reference's launcher cannot run one either).  Without
``--device`` and without a CUDA device the launcher raises.

``--mesh host`` is one process, with no process group, unless ``WORLD_SIZE``
is set: then every rank of the world ``torchrun`` started (one a GPU,
NCCL; gloo with ``--device cpu``) joins ``make_host_mesh()``, a ``(world,
1)`` data-parallel mesh, runs the whole ETL job and keeps its rows of each
batch (``EtlJob(mesh=)``), and trains through ``shard_train_step``: FSDP
where the preset says ``fsdp``, replicated parameters otherwise::

    torchrun --nproc_per_node 8 -m repro_torch.launch.train --mesh host \
        --arch mixtral_8x7b --steps 8 --batch 8 --seq 1024

``--mesh pod`` / ``multipod`` build the production mesh
(``make_production_mesh``: ``(16, 16)`` ``("data", "model")`` over 256
ranks, ``(2, 16, 16)`` with a ``"pod"`` axis over 512; another world size
raises its ``ValueError``): the "model" axis splits the dense, MoE and
VLM families' parameters (tensor, sequence and expert parallelism, under
FSDP on the data axes where the preset says ``fsdp``), and the model ranks
of one data coordinate receive the same rows.

Rank 0 prints; ``main`` returns the summary on every rank.  A failure on a
rank is not retried there (the others would wait in a collective): it ends
the process, and ``torchrun`` ends the rest.
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.core.pipeline import lm_token_pipeline
from repro_torch.data.source import Source
from repro_torch.kernels.backend import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.etl_runtime.transfer import batch_sharding, put_packed
from repro_torch.launch.mesh import (init_process_group, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.presets import train_preset
from repro_torch.models.api import build_model
from repro_torch.session import EtlJob
from repro_torch.training.fault import run_with_restarts
from repro_torch.training.train_loop import (LoopConfig, TrainState,
                                             make_train_step, resume_or_init,
                                             shard_train_step, train_loop)


def check_fed(cfg) -> None:
    """Raise for a family whose inputs the token pipeline does not make:
    enc-dec trains and prefills on ``frames`` beside its tokens."""
    if cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name}: the enc-dec family needs frames, which the LM "
            "token pipeline does not make (it feeds tokens and labels); use "
            "models.api.build_model with random_batch's frames instead")


def placer(backend: str, device):
    """The executor's place stage for ``backend``: the ``numpy`` backend's
    batches are moved to ``device``; the ``torch`` / ``cuda`` backends'
    are there already (None)."""
    if backend != "numpy":
        return None
    dev = resolve_device(device)

    def place(b):
        return {k: torch.as_tensor(v).to(dev) for k, v in b.items()}
    return place


def make_job(cfg, batch, seq, steps, *, backend="cuda", device=None,
             metrics_file="", embed_cache=None, autotune=None, mesh=None,
             microbatches: int = 1) -> EtlJob:
    """Declarative ingest session: raw event logs -> token batches on the
    trainer's device.

    The ``Source`` names the stream; ``EtlJob`` owns compile + executor
    lifecycle.  The ``numpy`` backend's batches are moved to ``device`` by
    the place stage; the ``torch`` / ``cuda`` backends' are there already.
    ``embed_cache`` (an ``EmbedCacheConfig``) adds the lookahead embedding
    prefetch stage — recommender pipelines whose batches carry a sparse
    index matrix; LM pipelines have no such key and must leave it unset.
    On a ``mesh`` every rank runs the whole job and its place stage keeps
    the rank's rows (``put_packed`` with ``microbatches``: the rows of its
    token groups in each microbatch).
    """
    pipe = lm_token_pipeline(seq, cfg.vocab_size, batch_size=batch)
    src = Source.lm_events(seq, rows=batch * (steps + 4), batch_size=batch)
    place = placer(backend, device)
    if mesh is not None:
        keep = functools.partial(put_packed, sharding=batch_sharding(mesh),
                                 microbatches=microbatches)
        place = keep if place is None else (lambda b, f=place: keep(f(b)))
    return EtlJob(pipe, src, backend=backend, device=device, credits=2,
                  place=place, metrics_file=metrics_file,
                  embed_cache=embed_cache, autotune=autotune,
                  metrics_labels={"arch": cfg.name})


def embed_cache_config(args):
    """CLI knobs -> EmbedCacheConfig (None when the cache is off)."""
    if args.embed_cache_rows <= 0:
        return None
    from repro_torch.etl_runtime.lookahead import EmbedCacheConfig
    tables = (tuple(int(t) for t in args.embed_cache_tables.split(","))
              if args.embed_cache_tables else None)
    return EmbedCacheConfig(rows=args.embed_cache_rows,
                            window=args.embed_cache_window,
                            tables=tables, key=args.embed_cache_key)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["host", "pod", "multipod"],
                    default="host")
    ap.add_argument("--etl-backend", default="cuda",
                    choices=["numpy", "torch", "cuda"])
    ap.add_argument("--device", default=None,
                    help="where the model and the ETL run (default: CUDA; "
                         "'cpu' runs the plain versions)")
    ap.add_argument("--watchdog-s", type=float, default=0.0)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--metrics-file", default="",
                    help="write executor StageStats as Prometheus text here")
    ap.add_argument("--embed-cache-rows", type=int, default=0,
                    help="device-resident embedding-cache rows per table "
                         "(0 = lookahead prefetch off)")
    ap.add_argument("--embed-cache-window", type=int, default=4,
                    help="lookahead window W (batches) for hot-set planning")
    ap.add_argument("--embed-cache-tables", default="",
                    help="comma-separated feature columns to cache "
                         "(default: all columns of the index matrix)")
    ap.add_argument("--embed-cache-key", default="sparse",
                    help="payload key holding the [batch, tables] indices")
    ap.add_argument("--autotune", action="store_true",
                    help="run the self-tuning PipelineController over the "
                         "executor knobs (credits, prefetch depth, "
                         "lookahead window; row tile/fuse on cuda)")
    return ap


def main(argv=None) -> dict:
    """Run the launcher; returns the last attempt's summary (``state``,
    ``stats``, ``job``, ``seconds``, ``tok_per_s``,
    ``trainer_utilization``, ``restarts``)."""
    args = build_parser().parse_args(argv)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    check_fed(cfg)
    tcfg = train_preset(args.arch)
    mesh = None
    if args.mesh != "host":
        dev = init_process_group(args.device)
        mesh = make_production_mesh(multi_pod=args.mesh == "multipod",
                                    device=dev)
        shd.set_active_mesh(mesh)
    elif "WORLD_SIZE" in os.environ:
        dev = init_process_group(args.device)
        mesh = make_host_mesh(device=dev)
        shd.set_active_mesh(mesh)
    else:
        dev = resolve_device(args.device)
    rank0 = mesh is None or dist.get_rank() == 0
    model = build_model(cfg)
    summary: dict = {}

    def say(*a):
        if rank0:
            print(*a, flush=True)

    def make_run():
        def run():
            step_fn = None

            def make_state():
                nonlocal step_fn
                state = TrainState.create(model.init(seed=0, device=dev),
                                          tcfg)
                if mesh is None:
                    step_fn = make_train_step(model.loss, tcfg)
                    return state
                step_fn, state = shard_train_step(
                    model.loss, tcfg, mesh, state, batch_rows=args.batch,
                    fsdp=tcfg.fsdp,
                    n_experts=cfg.moe.n_experts if cfg.moe else 0)
                return state

            state = resume_or_init(make_state, args.ckpt_dir)
            if state.step:
                say(f"[train] resuming from step {state.step}")
            job = make_job(cfg, args.batch, args.seq, args.steps,
                           backend=args.etl_backend, device=dev,
                           metrics_file=args.metrics_file,
                           embed_cache=embed_cache_config(args),
                           autotune=args.autotune or None, mesh=mesh,
                           microbatches=max(tcfg.microbatch, 1))
            loop_cfg = LoopConfig(total_steps=args.steps,
                                  ckpt_dir=args.ckpt_dir,
                                  ckpt_every=args.ckpt_every,
                                  log_every=10,
                                  watchdog_s=args.watchdog_s)
            t0 = time.perf_counter()
            with job.batches() as batches:
                final = train_loop(state, step_fn, batches, loop_cfg,
                                   device=dev,
                                   on_metrics=None if rank0 else
                                   (lambda m: None))
            dt = time.perf_counter() - t0
            toks = args.steps * args.batch * args.seq
            stats = job.stats()
            util = stats.trainer_utilization(dt - stats.consumer_wait_s)
            say(f"[train] done: {args.steps} steps, "
                f"{toks/dt:,.0f} tok/s, etl_producer_wait="
                f"{stats.producer_wait_s:.2f}s trainer_wait="
                f"{stats.consumer_wait_s:.2f}s util={util:.2%}")
            for name, s in stats.stage_breakdown().items():
                say(f"[train]   stage {name:9s} items={s['items']:<5d} "
                    f"busy={s['busy_s']:.2f}s wait_in={s['wait_in_s']:.2f}s "
                    f"wait_out={s['wait_out_s']:.2f}s "
                    f"occ={s['occupancy']:.1%}")
            if args.metrics_file:
                say(f"[train] metrics written to {args.metrics_file}")
            summary.update(state=final, stats=stats, seconds=dt,
                           tok_per_s=toks / dt, trainer_utilization=util,
                           job=job)
            return final

        return run

    # one rank cannot restart alone: the others would wait in a collective
    restarts = run_with_restarts(
        make_run, max_restarts=args.max_restarts if mesh is None else 0)
    summary["restarts"] = restarts.restarts
    return summary


if __name__ == "__main__":
    main()
