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


def criteo_per_feature(vocab: int, modulus: int = 4194304,
                       features: int = 26):
    """Builder: one vocabulary per Criteo feature, as DLRM users lay out
    Criteo: ``sparse_i | Hex2Int(8) | Modulus(modulus) | Vocab(vocab)`` for
    i < ``features`` (all 26 by default) in one ``sparse`` output; dense
    and label as in Pipeline III.  ``chip_smoke.py`` builds its
    ``criteo*_group`` instances from it too."""
    def build(ns):
        o = ns.ops
        p = ns.Pipeline(ns.Schema.criteo_kaggle(), name="criteo_per_feature")
        d = p.dense("dense_*") | o.FillMissing(0.0) | o.Clamp(0.0) | \
            o.Logarithm()
        s = [p.sparse(f"sparse_{i}") | o.Hex2Int(8) | o.Modulus(modulus)
             | ns.Vocab(vocab) for i in range(features)]
        p.output("dense", [d], dtype=np.float32, pad_cols_to=16)
        p.output("sparse", s, dtype=np.int32, pad_cols_to=32)
        p.output("label", [p.label("label")], dtype=np.float32, squeeze=True)
        return p
    return build


def in_range_outputs(dtype):
    """Builder: Pipeline III's shape with its dense and sparse outputs in
    ``dtype`` and every value inside that dtype's range (the dense floats
    clamped to [0, 100], the ids bounded by Modulus(200)): casts of values
    out of range depend on the platform in both packages."""
    def build(ns):
        o = ns.ops
        p = ns.Pipeline(ns.Schema.criteo_kaggle(), name="out_dtype")
        d = p.dense("dense_*") | o.FillMissing(0.0) | o.Clamp(0.0, 100.0)
        s = p.sparse("sparse_*") | o.Hex2Int(8) | o.Modulus(200)
        p.output("dense", [d], dtype=dtype, pad_cols_to=16)
        p.output("sparse", [s], dtype=dtype, pad_cols_to=32)
        p.output("label", [p.label("label")], dtype=np.float32, squeeze=True)
        return p
    return build


# the output dtypes the reference returns besides float32 / int32 (it
# refuses float64 and the 64-bit integers)
OUT_DTYPES = ("float16", "bfloat16", "int8", "uint8", "int16", "uint16",
              "uint32", "bool")


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
    """numpy of either package's array; bfloat16 (which numpy knows only
    through an extension type) as float32, its values exactly."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        return (x.float() if str(x.dtype) == "torch.bfloat16"
                else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def dtype_name(x) -> str:
    """The element type's name, the same for both packages' arrays."""
    if hasattr(x, "detach"):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


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


def hex_planes(vals: np.ndarray, missing=None) -> np.ndarray:
    """uint32 [rows, width] -> digit-major ASCII hex uint8 [8, rows, width];
    ``missing`` rows/columns become all-zero strings."""
    digits = np.frombuffer(b"0123456789abcdef", np.uint8)
    shifts = np.arange(28, -4, -4, dtype=np.uint64)
    planes = digits[(vals.astype(np.uint64)[None] >> shifts[:, None, None])
                    & 15]
    if missing is not None:
        planes[:, missing] = 0
    return np.ascontiguousarray(planes)


FIT_EDGE_CASES = ("equal", "distinct", "out_of_range")


def fit_edge_values(case: str, rows: int, width: int, capacity: int):
    """Digit-major hex whose Hex2Int values are all equal (0x1ABC), all
    distinct (0, 1, 2, ...), or a mix of in-range, negative, missing and
    >= ``capacity`` values."""
    rng = np.random.default_rng(21)
    if case == "equal":
        return hex_planes(np.full((rows, width), 0x1ABC, np.uint32))
    if case == "distinct":
        return hex_planes(np.arange(rows * width, dtype=np.uint32)
                          .reshape(rows, width))
    vals = rng.integers(0, capacity, size=(rows, width)).astype(np.uint32)
    pick = rng.random((rows, width))
    vals[pick < 0.2] = rng.integers(0x80000000, 0xFFFFFFFF,
                                    size=int((pick < 0.2).sum()),
                                    dtype=np.uint32)  # negative
    big = (pick >= 0.2) & (pick < 0.4)
    vals[big] = rng.integers(capacity, 1 << 30, size=int(big.sum()),
                             dtype=np.uint32)
    return hex_planes(vals, missing=rng.random((rows, width)) < 0.1)


def merge_refit(prev, window_tables: dict) -> tuple:
    """``(tables, n_unique)`` of a rank-stable incremental refit, written out
    apart from both packages' ``fit_incremental``: the values ``prev`` lacks
    and the window's rank tables hold get ranks ``n_unique ..`` in the
    order of the window's ranks (its first occurrences)."""
    tables, n_unique = {}, {}
    for vid, wt in window_tables.items():
        wt = np.asarray(wt)
        base = np.array(prev.tables[vid], copy=True)
        n = int(prev.n_unique[vid])
        fresh = sorted((int(wt[v]), int(v)) for v in np.nonzero(wt >= 0)[0]
                       if base[v] < 0)
        for k, (_, v) in enumerate(fresh):
            base[v] = n + k
        tables[vid], n_unique[vid] = base, n + len(fresh)
    return tables, n_unique
