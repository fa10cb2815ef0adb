"""Continuous online training on the PyTorch/CUDA port: event bus ->
incremental vocab -> DLRM.

    PYTHONPATH=src python examples/torch_online_training.py [--duration 20]
    PYTHONPATH=src python examples/torch_online_training.py --device cpu

Where ``torch_train_dlrm_e2e.py`` trains on a bounded stream and exits,
this example runs the service posture: a producer publishes an endless
Criteo-like event stream onto an in-process ``EventBus``, and an
``OnlineTrainer`` consumes it —

- training on each delivered batch (staged ETL executor in between; the
  hand-written kernels on the card, their plain versions with ``--device
  cpu``),
- refitting the vocabulary every ``--refit-every`` steps on just the
  window of new events (rank-stable: existing embedding rows keep their
  meaning; new values append), swapping the pipeline state atomically,
- shedding the globally-oldest in-flight events whenever ingest outruns
  training, so delivered event age stays under ``--shed-max-staleness``,
- rolling checkpoints (async save + prune) every ``--checkpoint-every``.

The producer runs at 2x the trainer's rate on purpose: watch the shed
counter climb while the staleness p95 holds under the bound.
"""

import argparse
import os
import tempfile
import threading
import time

from repro_torch.launch.online import build_parser, build_service
from repro_torch.training import checkpoint as ckpt_lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--refit-every", type=int, default=15)
    ap.add_argument("--shed-max-staleness", type=float, default=0.5)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "online_ckpt"))
    ap.add_argument("--device", default=None,
                    help="default: CUDA; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    svc_args = build_parser().parse_args([
        "--duration", str(args.duration),
        "--batch", "256", "--vocab", "4096", "--d-emb", "32",
        "--rate", "25", "--rate-mult", "2.0",       # bursty: 2x trainer
        "--refit-every", str(args.refit_every),
        "--shed-max-staleness", str(args.shed_max_staleness),
        "--checkpoint-every", str(args.checkpoint_every),
        "--ckpt-dir", args.ckpt_dir,
        "--eval-every", "50", "--log-every", "25",
        *(["--device", args.device] if args.device else []),
    ])
    trainer, bus, producer = build_service(svc_args)
    t = threading.Thread(target=producer, name="producer")
    t.start()
    t0 = time.perf_counter()
    try:
        trainer.run(deadline_s=args.duration + 5.0)
    finally:
        producer.stop.set()
        t.join()
    wall = time.perf_counter() - t0

    st, pct = trainer.stats, trainer.staleness_percentiles()
    print(f"\n[online] {st.steps} steps in {wall:.1f}s "
          f"({st.steps/max(wall,1e-9):.1f} steps/s), "
          f"{st.swaps} vocab swaps (version "
          f"{st.versions[-1] if st.versions else 1}), "
          f"{st.evals} evals: {st.last_eval}")
    print(f"[online] staleness p50/p95/p99 = "
          f"{pct['p50']*1e3:.1f}/{pct['p95']*1e3:.1f}/{pct['p99']*1e3:.1f}ms"
          f" (bound {args.shed_max_staleness*1e3:.0f}ms), "
          f"shed {trainer.shed_stats().dropped} stale events")
    latest = ckpt_lib.latest_step(args.ckpt_dir)
    print(f"[online] newest committed checkpoint: step {latest} "
          f"(restart resumes from it)")
    return trainer


if __name__ == "__main__":
    main()
