"""Multi-tenant ETL on the PyTorch/CUDA port: heterogeneous pipelines
sharing one GPU (paper §3.4 Q1/Q2 + §4.8), including a hot swap (the
partial-reconfiguration analogue).  The twin of
``examples/multitenant_pipelines.py``.

    PYTHONPATH=src python examples/torch_multitenant_pipelines.py
    PYTHONPATH=src python examples/torch_multitenant_pipelines.py --device cpu

On the card every tenant's transform runs the hand-written dataflow kernels
on its executor's own stream; ``--device cpu`` runs their plain versions.
"""

import argparse
import time

from repro_torch.core.pipeline import paper_pipeline
from repro_torch.data.source import Source
from repro_torch.etl_runtime.multitenant import PipelineManager
from repro_torch.session import EtlJob


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: CUDA ('cpu' runs the plain versions)")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--batches", type=int, default=4)
    args = ap.parse_args(argv)
    B = args.batch

    mgr = PipelineManager()
    # heterogeneous tenants: stateless, small-vocab, large-vocab — each a
    # declarative (pipeline, Source) pair the manager turns into an EtlJob
    fit_src = Source.synth("I", rows=2 * B, batch_size=B)
    for name, which in [("stateless", "I"), ("vocab8k", "II"),
                        ("vocab512k", "III")]:
        job = EtlJob(paper_pipeline(which, small_vocab=8192,
                                    large_vocab=524288, batch_size=B),
                     backend="cuda", device=args.device, fit_source=fit_src)
        job.fit()
        mgr.add(name, job.compiled,
                Source.synth("I", rows=args.batches * B, batch_size=B,
                             seed=len(name)))

    res = mgr.run(n_batches=args.batches)
    for name, r in res.items():
        print(f"[tenant {name:10s}] {r.rows_per_s:>10,.0f} rows/s "
              f"({r.batches} batches)")

    # hot swap: replace the stateless tenant with a new pipeline in O(1)
    new_pipe = paper_pipeline("I", modulus=1024, batch_size=B).compile(
        "cuda", device=args.device)
    t0 = time.perf_counter()
    mgr.swap("stateless", new_pipe,
             Source.synth("I", rows=2 * B, batch_size=B, seed=5))
    print(f"[swap] reconfigured tenant in {1e3*(time.perf_counter()-t0):.2f}ms"
          " (compiled-pipeline swap; no recompilation)")
    res = mgr.run(n_batches=2)
    print(f"[tenant stateless] {res['stateless'].rows_per_s:,.0f} rows/s "
          "after swap")
    return res


if __name__ == "__main__":
    main()
