"""Shared helpers for the parity tests of ``repro_torch`` against ``repro``.

Both packages build the same pipelines from the same builder (a function of
a namespace holding each package's ``Pipeline`` / operators / ``Vocab``).
Node ids come from a per-package class counter, so ``build_pair`` first sets
both counters to the same value: the two plans then use identical buffer
names and vocab ids, and inputs, tables and states pass between them by
name.  Inputs are made with numpy from a seed and handed to both.

The reference is imported only inside ``build_pair``, so tests of the port
alone (the card tests) also run where JAX is not installed.
"""

from __future__ import annotations

import types

import numpy as np

from repro_torch.core import dag as port_dag
from repro_torch.core import operators as port_ops
from repro_torch.core import pipeline as port_pipeline
from repro_torch.core.schema import Schema as PortSchema
from repro_torch.data import synth

PORT = types.SimpleNamespace(pipeline=port_pipeline, ops=port_ops,
                             Pipeline=port_pipeline.Pipeline,
                             Schema=PortSchema, Vocab=port_dag.Vocab)

# the reference tests' small sizes (tests/test_pipeline.py)
SMALL = dict(modulus=4096, small_vocab=2048, large_vocab=8192)


def paper(which: str, **kw):
    """Builder: paper Pipeline I/II/III at the small test sizes."""
    return lambda ns: ns.pipeline.paper_pipeline(which, **{**SMALL, **kw})


def kitchen_sink(ns):
    """Builder exercising every TileStep operator the paper pipelines do
    not: NaN through Clamp (no FillMissing), Clamp with an upper bound,
    float and int Bucketize, OneHot with out-of-range values, int
    FillMissing, SigridHash, Cartesian, a vocab over a cross, and
    int -> float casts in the packer."""
    o = ns.ops
    p = ns.Pipeline(ns.Schema.criteo_kaggle(), name="kitchen_sink")
    d = p.dense("dense_*") | o.Clamp(0.0, 50.0) | o.Logarithm()
    b = p.dense("dense_0") | o.FillMissing(0.0) | o.Bucketize((0.5, 2.0, 10.0))
    oh = b | o.OneHot(3)  # bucket 3 is out of range -> an all-zero row
    h = (p.sparse("sparse_0") | o.Hex2Int(8) | o.FillMissing(7)
         | o.SigridHash(1000))
    g = p.sparse("sparse_1") | o.Hex2Int(8) | o.Modulus(997)
    v = p.cross(h, g, 4096) | ns.Vocab(4096)
    bi = g | o.Bucketize((100.5, 500.0))
    p.output("dense", [d, oh, b], dtype=np.float32, pad_cols_to=8)
    p.output("ids", [v, bi, h], dtype=np.int32, pad_cols_to=8)
    p.output("label", [p.label("label")], dtype=np.float32, squeeze=True)
    return p


BUILDERS = {"I": paper("I"), "II": paper("II"), "III": paper("III"),
            "sink": kitchen_sink}


def build_pair(builder):
    """(reference Pipeline, port Pipeline) with identical node ids."""
    from repro.core import dag as ref_dag
    from repro.core import operators as ref_ops
    from repro.core import pipeline as ref_pipeline
    from repro.core.schema import Schema as RefSchema
    ref_ns = types.SimpleNamespace(pipeline=ref_pipeline, ops=ref_ops,
                                   Pipeline=ref_pipeline.Pipeline,
                                   Schema=RefSchema, Vocab=ref_dag.Vocab)
    start = max(ref_dag.Node._counter, port_dag.Node._counter)
    ref_dag.Node._counter = start
    ref = builder(ref_ns)
    port_dag.Node._counter = start
    port = builder(PORT)
    return ref, port


def fit_batches(rows: int = 3000):
    return synth.dataset_batches("I", rows=rows, batch_size=1000, seed=7)


def raw_batch(rows: int = 600, seed: int = 9) -> dict:
    return next(synth.dataset_batches("I", rows=rows, batch_size=rows,
                                      seed=seed))


def to_np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_match(want, got, msg: str = "") -> None:
    """The reference's policy: integers bit-equal, floats rtol 1e-5."""
    a, b = to_np(want), to_np(got)
    assert a.shape == b.shape, (msg, a.shape, b.shape)
    if np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(a, b, err_msg=msg)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=msg)


def assert_outputs_match(want: dict, got: dict, msg: str = "") -> None:
    assert set(want) == set(got), (msg, set(want), set(got))
    for k in want:
        assert_match(want[k], got[k], f"{msg}/{k}")
