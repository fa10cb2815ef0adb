"""Quickstart on the PyTorch/CUDA port: compose a pipeline, declare a
Source, run it as an EtlJob.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Builds the paper's Pipeline II on a Criteo-like schema with the Python
template interface, fits the vocabulary on a declarative Source, and
transforms a raw batch into training-ready tensors on the port's three
backends through the session facade: ``numpy`` (the host oracle),
``torch`` (plain PyTorch ops) and ``cuda`` (the hand-written kernels).
With ``--device cpu`` the ``torch`` backend runs on the CPU and ``cuda``
is skipped (its kernels run on the card only); without it every backend
runs on the card, and there is no fallback where there is none.
"""

import argparse

import numpy as np

from repro_torch.core.dag import Vocab
from repro_torch.core.operators import (Clamp, FillMissing, Hex2Int,
                                        Logarithm, Modulus)
from repro_torch.core.pipeline import Pipeline
from repro_torch.core.schema import Schema
from repro_torch.data.source import Source
from repro_torch.session import EtlJob


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: CUDA; 'cpu' runs the numpy and torch "
                         "backends on the CPU and skips cuda")
    args = ap.parse_args(argv)
    schema = Schema.criteo_kaggle()

    # -- compose (paper §3.4: software-defined operators -> symbolic DAG) --
    p = Pipeline(schema, name="quickstart", batch_size=4096)
    dense = (p.dense("dense_*") | FillMissing(0.0) | Clamp(0.0)
             | Logarithm())
    sparse = (p.sparse("sparse_*") | Hex2Int(8) | Modulus(8192)
              | Vocab(8192))
    p.output("dense", [dense], dtype=np.float32, pad_cols_to=128)
    p.output("sparse", [sparse], dtype=np.int32, pad_cols_to=128)
    p.output("label", [p.label("label")], dtype=np.float32, squeeze=True)

    # -- declare ingest once; the job owns compile -> fit -> apply ---------
    raw = next(iter(Source.synth("I", rows=4096, batch_size=4096, seed=9)))
    out = {}
    for backend in ["numpy", "torch", "cuda"]:
        if backend == "cuda" and args.device == "cpu":
            print("[cuda  ] skipped: --device cpu (the kernels run on the "
                  "card only)")
            continue
        job = EtlJob(p, backend=backend, device=args.device,
                     fit_source=Source.synth("I", rows=8192, batch_size=4096))
        job.fit()  # fit phase: learn vocab tables from the stream
        out[backend] = {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v)
                        for k, v in job.apply(raw).items()}
        print(f"[{backend:6s}] " + "  ".join(
            f"{k}:{v.shape}:{v.dtype}"
            for k, v in sorted(out[backend].items())))
        print(f"          n_unique={list(job.state.n_unique.values())} "
              f"version={job.state.version} "
              f"resources={job.compiled.resource_summary()}")
    same = all(np.array_equal(out["numpy"][k], o[k]) if o[k].dtype.kind
               in "iu" else np.allclose(out["numpy"][k], o[k], rtol=1e-5)
               for o in out.values() for k in o)
    print(f"[check ] {', '.join(out)} agree with numpy: {same}")
    return out


if __name__ == "__main__":
    main()
