"""End-to-end driver on the PyTorch/CUDA port (paper Fig 3): streaming ETL
-> handoff on the card -> DLRM.  The twin of ``examples/train_dlrm_e2e.py``.

    PYTHONPATH=src python examples/torch_train_dlrm_e2e.py [--steps 300]
    PYTHONPATH=src python examples/torch_train_dlrm_e2e.py --device cpu \
        --steps 20 --batch 512 --vocab 8192

Trains a ~100M-parameter DLRM for a few hundred steps on a continuously
generated Criteo-like event stream.  Ingest is declarative: a ``Source``
names the stream and an ``EtlJob`` owns compile -> fit -> the staged
prefetching executor (Pipeline II runs the hand-written dataflow kernels on
the executor's own stream, double-buffered against the trainer with credit
backpressure); the script reports trainer utilization — the paper's
headline effect (Fig 14 / §4.4).
"""

import argparse
import time

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.pipeline import paper_pipeline
from repro_torch.data.source import Source
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import dlrm
from repro_torch.session import EtlJob
from repro_torch.training.train_loop import (LoopConfig, TrainState,
                                             make_train_step, train_loop)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--vocab", type=int, default=65536)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="default: CUDA ('cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ~100M params: 26 tables x 64k x 64
    cfg = dlrm.DLRMConfig(vocab_size=args.vocab + 1, d_emb=64,
                          bot_mlp=(512, 256, 64),
                          top_mlp=(512, 256, 128, 1))
    print(f"[e2e] DLRM params: {cfg.param_count():,}")

    job = EtlJob(
        paper_pipeline("II", small_vocab=args.vocab, batch_size=args.batch),
        Source.synth("I", rows=args.steps * args.batch,
                     batch_size=args.batch, seed=11),
        backend="cuda", device=dev,
        fit_source=Source.synth("I", rows=50_000, batch_size=10_000))
    t0 = time.perf_counter()
    job.fit()
    print(f"[e2e] vocab fit in {time.perf_counter()-t0:.2f}s; "
          f"n_unique={max(job.state.n_unique.values())}")

    tcfg = TrainConfig(lr=1e-3)
    model = dlrm.DLRM(cfg, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    state = TrainState.create(model, tcfg)
    step = make_train_step(dlrm.loss_fn, tcfg)

    t0 = time.perf_counter()
    with job.batches() as ex:
        state = train_loop(state, step, ex,
                           LoopConfig(total_steps=args.steps,
                                      ckpt_dir=args.ckpt_dir,
                                      ckpt_every=100 if args.ckpt_dir else 0,
                                      log_every=50),
                           device=dev)
    wall = time.perf_counter() - t0
    s = job.stats()
    rows = args.steps * args.batch
    train_s = wall - s.consumer_wait_s
    print(f"[e2e] {args.steps} steps / {rows:,} rows in {wall:.1f}s "
          f"({rows/wall:,.0f} rows/s)")
    print(f"[e2e] trainer utilization {s.trainer_utilization(train_s):.1%} "
          f"(trainer starved {s.consumer_wait_s:.2f}s; "
          f"ETL blocked on credits {s.producer_wait_s:.2f}s; "
          f"ETL hidden behind training {s.overlapped_etl_s:.2f}s)")
    for name, st in s.stage_breakdown().items():
        print(f"[e2e]   stage {name:9s} items={st['items']:<5d} "
              f"busy={st['busy_s']:.2f}s wait_in={st['wait_in_s']:.2f}s "
              f"wait_out={st['wait_out_s']:.2f}s occ={st['occupancy']:.1%}")
    return state


if __name__ == "__main__":
    main()
