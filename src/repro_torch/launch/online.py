"""Online-training launcher: event bus -> OnlineTrainer, continuously.

On the card (the default: ``--device`` is CUDA, and the ETL runs the
hand-written kernels, ``--etl-backend cuda``)::

    PYTHONPATH=src python -m repro_torch.launch.online --duration 20 \
        --batch 256 --vocab 4096 --rate 40 --refit-every 25 \
        --shed-max-staleness 0.5 --checkpoint-every 50 --ckpt-dir ckpt

On the CPU, with the plain torch ETL::

    PYTHONPATH=src python -m repro_torch.launch.online --device cpu \
        --etl-backend torch --duration 10 --steps 20 --refit-every 5

A producer thread replays a synthetic Criteo-like event stream onto an
in-process ``EventBus`` (optionally fronted by the TCP transport with
``--port``); the ``OnlineTrainer`` consumes it through the staged ETL
executor, interleaving DLRM steps with periodic incremental vocab refits
(rank-stable ``fit_incremental`` + atomic state swap), eval and checkpoint
rollover, while the ``FreshnessShedder`` keeps delivered event age under
``--shed-max-staleness``.  ``--rate-mult`` > 1 makes the producer
deliberately outrun the trainer (the shedding posture).
``--embed-cache-rows`` trains through the lookahead embedding cache
(refreshed every batch, invalidated on every refit).  Without ``--device``
and without a CUDA device the launcher raises.
"""

from __future__ import annotations

import argparse
import threading
import time

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.pipeline import paper_pipeline
from repro_torch.data.source import Source
from repro_torch.etl_runtime import transfer as transfer_lib
from repro_torch.etl_runtime.lookahead import EmbedCache, EmbedCacheConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import dlrm
from repro_torch.online import (BusServer, EventBus, OnlineConfig,
                                OnlineTrainer, replay)
from repro_torch.session import EtlJob
from repro_torch.training.train_loop import TrainState, make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration", type=float, default=30.0,
                    help="wall-clock budget for the service loop (s)")
    ap.add_argument("--steps", type=int, default=0,
                    help="stop after this many steps (0 = duration only)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=4096,
                    help="per-feature vocab capacity (fixed table size; "
                         "incremental refits grow ranks within it)")
    ap.add_argument("--d-emb", type=int, default=32)
    ap.add_argument("--rate", type=float, default=40.0,
                    help="producer rate, events (batches) per second")
    ap.add_argument("--rate-mult", type=float, default=1.0,
                    help="multiply --rate (2.0 = bursty 2x-trainer posture)")
    ap.add_argument("--burst", type=int, default=1,
                    help="publish this many events back-to-back per tick")
    ap.add_argument("--bus-capacity", type=int, default=128,
                    help="per-subscription bus bound (drop-oldest beyond)")
    ap.add_argument("--port", type=int, default=-1,
                    help="serve the bus over TCP on this port (0 = ephemeral,"
                         " -1 = in-process only)")
    ap.add_argument("--topic", default="events")
    ap.add_argument("--refit-every", type=int, default=25,
                    help="steps between incremental vocab refits (0 = off)")
    ap.add_argument("--refit-window", type=int, default=64,
                    help="max event batches per refit window")
    ap.add_argument("--shed-max-staleness", type=float, default=0.0,
                    help="freshness bound on event age at delivery, seconds "
                         "(0 = shedding off)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="steps between async checkpoints (0 = off)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--keep-ckpts", type=int, default=3)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="steps between holdout evals (0 = off)")
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--etl-backend", default="cuda",
                    choices=["numpy", "torch", "cuda"])
    ap.add_argument("--device", default=None,
                    help="where the ETL and the model run (default: CUDA; "
                         "raises without a CUDA device)")
    ap.add_argument("--embed-cache-rows", type=int, default=0,
                    help="resident rows per table of the lookahead embedding"
                         " cache (0 = no cache)")
    ap.add_argument("--metrics-file", default="",
                    help="write executor stats (incl. the staleness "
                         "histogram) as Prometheus text here")
    ap.add_argument("--autotune", action="store_true",
                    help="run the self-tuning PipelineController over the "
                         "executor knobs")
    ap.add_argument("--seed", type=int, default=11)
    return ap


def build_service(args):
    """Wire bus + job + model + trainer from parsed flags.

    Returns ``(trainer, bus, producer)`` where ``producer()`` runs the
    paced replay until the duration elapses or ``producer.stop`` is set,
    then closes the bus.
    """
    device = resolve_device(args.device)
    bus = EventBus(capacity=args.bus_capacity)
    server = BusServer(bus, port=args.port) if args.port >= 0 else None

    pipe = paper_pipeline("II", small_vocab=args.vocab,
                          batch_size=args.batch)
    cfg = dlrm.DLRMConfig(vocab_size=args.vocab + 1, d_emb=args.d_emb,
                          bot_mlp=(128, 64, args.d_emb),
                          top_mlp=(128, 64, 1))
    cache_cfg = (EmbedCacheConfig(rows=args.embed_cache_rows, window=4,
                                  tables=tuple(range(cfg.n_sparse)),
                                  refresh=True, row_bytes=4 * cfg.d_emb)
                 if args.embed_cache_rows else None)
    # the numpy oracle packs host arrays: the place stage moves them over
    place = ((lambda b: transfer_lib.to_device(b, device))
             if args.etl_backend == "numpy" else None)
    job = EtlJob(pipe, Source.events(bus, args.topic),
                 backend=args.etl_backend, device=device, place=place,
                 autotune=getattr(args, "autotune", False) or None,
                 embed_cache=cache_cfg, metrics_file=args.metrics_file,
                 metrics_labels={"service": "online"}, name="online")
    # initial vocab: fit on a short synthetic prefix so the service starts
    # with a live (small) vocabulary that refits then grow incrementally
    warm = list(Source.synth("I", rows=args.batch * 8,
                             batch_size=args.batch, seed=args.seed))
    job.compiled.fit(iter(warm))

    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = dlrm.DLRM(cfg, device=device, generator=gen)
    tcfg = TrainConfig(lr=1e-3)
    state = TrainState.create(model, tcfg)
    step = make_train_step(dlrm.loss_fn, tcfg)

    eval_fn = None
    if args.eval_every:
        holdout = transfer_lib.to_device(job.compiled(warm[0]), device) \
            if args.etl_backend == "numpy" else job.compiled(warm[0])

        def eval_fn(st):
            with torch.no_grad():
                return {"holdout_loss": float(dlrm.loss_fn(st.model,
                                                           holdout))}

    ocfg = OnlineConfig(
        refit_every=args.refit_every, window_batches=args.refit_window,
        shed_max_staleness_s=args.shed_max_staleness,
        checkpoint_every=args.checkpoint_every, ckpt_dir=args.ckpt_dir,
        keep_ckpts=args.keep_ckpts, eval_every=args.eval_every,
        log_every=args.log_every)
    cache = (EmbedCache(cache_cfg, cfg.n_sparse, cfg.d_emb, device=device)
             if cache_cfg else None)
    trainer = OnlineTrainer(job, state, step, ocfg,
                            bus=bus if args.refit_every else None,
                            topic=args.topic, embed_cache=cache,
                            eval_fn=eval_fn)
    stop = threading.Event()

    def producer():
        # endless stream: cycle fresh synthetic event batches at the paced
        # rate; a different seed per lap keeps new vocab values arriving
        # so refits have something to learn
        rate = args.rate * args.rate_mult
        timer = threading.Timer(args.duration, stop.set)
        timer.daemon = True
        timer.start()
        lap = 0
        try:
            while not stop.is_set():
                feed = Source.synth("I", rows=args.batch * 64,
                                    batch_size=args.batch,
                                    seed=args.seed + 1 + lap)
                replay(bus, args.topic, feed, rate_hz=rate,
                       burst=args.burst, stop=stop)
                lap += 1
        finally:
            timer.cancel()
            bus.close()
            if server is not None:
                server.close()

    producer.stop = stop
    return trainer, bus, producer


def main(argv=None):
    args = build_parser().parse_args(argv)
    trainer, bus, producer = build_service(args)
    t = threading.Thread(target=producer, name="online-producer")
    t.start()
    t0 = time.perf_counter()
    try:
        trainer.run(max_steps=args.steps or None,
                    deadline_s=args.duration + 5.0)
    finally:
        producer.stop.set()
        t.join()
    wall = time.perf_counter() - t0

    st, pct = trainer.stats, trainer.staleness_percentiles()
    shed = trainer.shed_stats()
    counts = bus.counts()
    print(f"[online] {st.steps} steps in {wall:.1f}s "
          f"({st.steps / max(wall, 1e-9):.1f} steps/s)")
    print(f"[online] swaps={st.swaps} versions={st.versions} "
          f"refit_batches={st.refit_batches} "
          f"checkpoints={st.checkpoints} evals={st.evals}")
    print(f"[online] staleness p50={pct['p50']*1e3:.1f}ms "
          f"p95={pct['p95']*1e3:.1f}ms p99={pct['p99']*1e3:.1f}ms "
          f"(bound {args.shed_max_staleness*1e3:.0f}ms)")
    print(f"[online] shed dropped={shed.dropped} "
          f"bus={counts}")
    if st.last_eval:
        print(f"[online] last eval: {st.last_eval}")
    return trainer


if __name__ == "__main__":
    main()
