"""Serving launcher: ETL-fed batched prefill + decode against a selectable
arch.

On the card (the default: ``--device`` is CUDA, and the prompts' ETL runs
the hand-written kernels, ``--etl-backend cuda``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2_3b \
        --batch 8 --prompt-len 1024 --max-new 128

On the CPU, at the smoke-scale config::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --reduced --arch mamba2_370m --batch 4 --prompt-len 32 --max-new 16

Prompt ingest runs through the same ``EtlJob`` facade as training (over
a ``Source``): raw event logs stream through the compiled
token pipeline (SigridHash bounds unbounded ids into the model's vocab), so
serving exercises the identical ETL contract, freshness, batching and
packer layout, that the trainer consumes.

Every decoder-only family serves (dense, MoE, VLM text, SSM, hybrid); an
enc-dec model, whose prefill needs frames, is refused with a
``ValueError`` before its prompt job starts (the reference's launcher
cannot serve one either).

``--metrics-file PATH`` exports the run's counters in Prometheus text
format for a node_exporter textfile collector.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.core.pipeline import lm_token_pipeline
from repro_torch.data.source import Source
from repro_torch.etl_runtime import metrics as metrics_lib
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.train import check_fed, placer
from repro_torch.models.api import build_model
from repro_torch.serving.decode import generate
from repro_torch.session import EtlJob


def export_metrics(path: str, *, counters: dict, arch: str) -> None:
    """Write serving counters to ``path`` in Prometheus text format."""
    text = metrics_lib.counters_to_prometheus(
        counters, prefix="repro_serve", labels={"arch": arch})
    metrics_lib.write_metrics_file(path, text)


def make_prompt_job(cfg, *, batch: int, prompt_len: int, seed: int = 0,
                    backend: str = "cuda", device=None) -> EtlJob:
    """Prompt-ingest job: raw event ids -> bounded (batch, len) tokens
    on ``device`` (the ``numpy`` backend's are moved there by the place
    stage)."""
    pipe = lm_token_pipeline(prompt_len, cfg.vocab_size, batch_size=batch)
    src = Source.lm_events(prompt_len, rows=batch, batch_size=batch,
                           seed=seed)
    return EtlJob(pipe, src, backend=backend, device=device, credits=1,
                  place=placer(backend, device), name="serve-prompts")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--metrics-file", default="",
                    help="write Prometheus-style text counters here")
    ap.add_argument("--etl-backend", default="cuda",
                    choices=["numpy", "torch", "cuda"])
    ap.add_argument("--device", default=None,
                    help="where the model and the ETL run (default: CUDA; "
                         "'cpu' runs the plain versions)")
    return ap


def main(argv=None) -> dict:
    """Serve one ETL-fed prompt batch; returns a summary: ``tokens`` (B,
    max_new), ``stats`` (``ServeStats``), ``etl`` (the prompt job's
    ``RuntimeStats``), ``prompts``, ``cfg``, ``model`` (``build_model``'s
    entry points), ``module``, ``job`` and ``max_len``."""
    args = build_parser().parse_args(argv)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    check_fed(cfg)
    dev = resolve_device(args.device)
    model = build_model(cfg)
    module = model.init(seed=0, device=dev)
    job = make_prompt_job(cfg, batch=args.batch, prompt_len=args.prompt_len,
                          backend=args.etl_backend, device=dev)
    with job.batches() as batches:
        prompt_batch = next(iter(batches))
    prompts = prompt_batch["tokens"]
    max_len = args.prompt_len + args.max_new
    toks, stats = generate(model, module, prompts, max_new=args.max_new,
                           max_len=max_len, temperature=args.temperature,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1))
    print(f"[serve] arch={cfg.name} prefill={stats.prefill_s:.3f}s "
          f"decode={stats.decode_s:.3f}s ({stats.tokens_per_s:,.1f} tok/s)")
    print("[serve] first sequence:", toks[0][:16].tolist())
    etl = job.stats()
    if args.metrics_file:
        export_metrics(args.metrics_file, arch=cfg.name, counters={
            "prefill_seconds_total": stats.prefill_s,
            "decode_seconds_total": stats.decode_s,
            "generated_tokens_total": args.batch * args.max_new,
            "sequences_total": args.batch,
            "etl_prompt_batches_total": etl.consumed if etl else 0,
        })
        print(f"[serve] metrics written to {args.metrics_file}")
    return {"tokens": toks, "stats": stats, "etl": etl, "prompts": prompts,
            "cfg": cfg, "model": model, "module": module, "job": job,
            "max_len": max_len}


if __name__ == "__main__":
    main()
