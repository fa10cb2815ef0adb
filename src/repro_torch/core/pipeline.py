"""User-facing Python template interface for pipeline composition (paper §3.4).

Example (the paper's Pipeline III on the Criteo schema), driven through the
session facade::

    from repro_torch.data.source import Source
    from repro_torch.session import EtlJob

    job = EtlJob(paper_pipeline("III", batch_size=65536),
                 Source.synth("I", rows=16 * 65536, batch_size=65536),
                 backend="cuda",
                 fit_source=Source.synth("I", rows=4 * 65536,
                                         batch_size=65536))
    job.fit()                       # fit phase: one fit kernel per chunk
    with job.batches() as batches:  # apply phase: one group kernel a batch
        for packed in batches:
            state, metrics = train_step(state, packed)

The low-level path (``compiled = p.compile(...); compiled.fit(...);
compiled(raw_batch)``) remains available for kernel-level work.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.compiler import CompiledPipeline
from repro_torch.core.dag import Graph, Node, Vocab  # noqa: F401 (re-export Vocab)
from repro_torch.core.operators import (Bucketize, Clamp, FillMissing, Hex2Int,  # noqa: F401
                                  Logarithm, Modulus, OneHot, SigridHash)
from repro_torch.core.planner import Planner
from repro_torch.core.schema import Schema
from repro_torch.core.semantics import (BatchingPolicy, FreshnessPolicy,
                                  OrderingPolicy, PipelineSemantics)


class Pipeline:
    def __init__(self, schema: Schema, *, name: str = "pipeline",
                 batch_size: int = 65536,
                 freshness: Optional[FreshnessPolicy] = None,
                 ordering: Optional[OrderingPolicy] = None):
        self.schema = schema
        self.name = name
        self.graph = Graph(schema)
        self._outputs: list[tuple] = []
        self.semantics = PipelineSemantics(
            batching=BatchingPolicy(batch_size),
            freshness=freshness or FreshnessPolicy(),
            ordering=ordering or OrderingPolicy())

    # --- sources ---------------------------------------------------------

    def dense(self, pattern: str) -> Node:
        return self._source(pattern, "dense")

    def sparse(self, pattern: str) -> Node:
        return self._source(pattern, "sparse")

    def label(self, pattern: str) -> Node:
        return self._source(pattern, "label")

    def tokens(self, pattern: str) -> Node:
        return self._source(pattern, "token")

    def _source(self, pattern: str, kind: str) -> Node:
        node = self.graph.source(pattern)
        if node.group_kind != kind:
            raise TypeError(f"pattern {pattern!r} selects {node.group_kind} "
                            f"features, not {kind}")
        return node

    def cross(self, a: Node, b: Node, m: int) -> Node:
        return self.graph.cross(a, b, m)

    # --- sinks -----------------------------------------------------------

    def output(self, name: str, nodes: list[Node], *, dtype=np.float32,
               pad_cols_to: int = 1, squeeze: bool = False) -> None:
        if any(o[0] == name for o in self._outputs):
            raise ValueError(f"duplicate output {name!r}")
        self._outputs.append((name, list(nodes), np.dtype(dtype),
                              int(pad_cols_to), bool(squeeze)))

    # --- compile ----------------------------------------------------------

    def compile(self, backend: str = "torch", *, device=None,
                vmem_budget: int = 4 << 20, lanes: int = 8,
                vector_width: int = 128, fuse="auto",
                optimize: str = "auto",
                row_tile: Optional[int] = None) -> CompiledPipeline:
        """Lower the DAG.  ``backend`` is "numpy" (host oracle), "torch"
        (eager plain ops) or "cuda" (the hand-written dataflow kernels; their
        plain versions on ``device="cpu"``).  ``device`` defaults to CUDA
        and raises when none exists.  ``optimize="auto"`` runs the
        relational optimizer (CSE, pushdown, grouping) first; ``fuse`` and
        ``row_tile`` are the planner knobs of the JAX package, judged with
        the same logical legality."""
        if not self._outputs:
            raise ValueError("pipeline has no outputs; call .output(...)")
        planner_kw = {} if row_tile is None else {"row_tile": row_tile}
        planner = Planner(self.graph, vmem_budget=vmem_budget, lanes=lanes,
                          vector_width=vector_width, **planner_kw)
        plan = planner.plan(self._outputs)
        return CompiledPipeline(plan, self.graph, backend, device=device,
                                name=self.name, fuse=fuse, optimize=optimize,
                                semantics=self.semantics)


# ---------------------------------------------------------------------------
# The paper's three evaluation pipelines (§4.1.3, Fig 9)
# ---------------------------------------------------------------------------

def paper_pipeline(which: str, schema: Optional[Schema] = None, *,
                   modulus: int = 65536, small_vocab: int = 8192,
                   large_vocab: int = 524288, batch_size: int = 65536,
                   fill_missing: bool = True, min_count: int = 1) -> Pipeline:
    """Pipeline I (stateless), II (small vocab), III (large vocab).

    ``fill_missing`` imputes NaN dense values first (Table-1 operator; the
    industrial pipeline cleans before Clamp/Log).  Sparse missing values
    (all-zero hex) map to INT_MISSING and are bounded by Modulus like any id.
    """
    schema = schema or Schema.criteo_kaggle()
    p = Pipeline(schema, name=f"pipeline_{which}", batch_size=batch_size)
    d = p.dense("dense_*")
    if fill_missing:
        d = d | FillMissing(0.0)
    d = d | Clamp(0.0) | Logarithm()
    n_hex = schema.select("sparse_*")[0].hex_width
    # the vocab capacity IS the range of the upstream Modulus (paper §3.2.2)
    if which == "I":
        s = p.sparse("sparse_*") | Hex2Int(n_hex) | Modulus(modulus)
    elif which == "II":
        s = (p.sparse("sparse_*") | Hex2Int(n_hex) | Modulus(small_vocab)
             | Vocab(small_vocab, min_count=min_count))
    elif which == "III":
        s = (p.sparse("sparse_*") | Hex2Int(n_hex) | Modulus(large_vocab)
             | Vocab(large_vocab, min_count=min_count))
    else:
        raise ValueError(f"unknown paper pipeline {which!r}")
    # §Perf E3: minimal aligned pads (13 dense -> 16, 26 sparse -> 32)
    # instead of blanket 128 — the packed batch is 4x smaller and the packer
    # stays sublane-aligned; trainers read cfg-declared padded widths.
    p.output("dense", [d], dtype=np.float32, pad_cols_to=16)
    p.output("sparse", [s], dtype=np.int32, pad_cols_to=32)
    p.output("label", [p.label("label")], dtype=np.float32, squeeze=True)
    return p


def lm_token_pipeline(seq_len: int, vocab_size: int, *, batch_size: int = 256
                      ) -> Pipeline:
    """Streaming event-log -> LM token batch pipeline.

    Raw event ids are bounded into the model's vocab with SigridHash (the
    training-aware path the paper's abstraction generalizes to; the packer
    emits the exact (batch, seq) int32 layout train_step declares).
    """
    schema = Schema.lm_events(seq_len)
    p = Pipeline(schema, name="lm_tokens", batch_size=batch_size)
    t = p.tokens("tokens_raw") | SigridHash(vocab_size)
    lbl = p.label("label")
    p.output("tokens", [t], dtype=np.int32, pad_cols_to=1)
    p.output("labels", [lbl], dtype=np.int32, pad_cols_to=1)
    return p
