"""Symbolic ETL DAG built from the Python template interface (paper Fig 5).

Users compose pipelines over *column groups* (columnar processing): a node
produces a block of shape [rows, width] (or [rows, width, hex_width] for raw
hex sources).  Stateless operators apply elementwise over the block; stateful
vocabulary operators attach shared state; ``cross`` joins two blocks.

The DAG is purely symbolic — no data moves until the planner/compiler lowers
it into an ExecutionPlan (see planner.py / compiler.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import operators as ops_lib
from repro_torch.core.schema import Schema, FeatureSpec


@dataclasses.dataclass
class NodeType:
    SOURCE = "source"
    OP = "op"
    CROSS = "cross"
    VOCAB = "vocab"


class Node:
    """One vertex of the symbolic DAG."""

    _counter = 0

    def __init__(self, kind: str, *, graph: "Graph", parents: tuple["Node", ...] = (),
                 op: Optional[ops_lib.Operator] = None,
                 features: Optional[list[FeatureSpec]] = None,
                 group_kind: str = ""):
        Node._counter += 1
        self.id = f"n{Node._counter}"
        self.kind = kind
        self.graph = graph
        self.parents = parents
        self.op = op
        self.features = features or []
        self.group_kind = group_kind
        graph.nodes.append(self)
        # dtype/width propagation
        if kind == NodeType.SOURCE:
            f0 = self.features[0]
            self.dtype = np.dtype(np.uint8) if f0.is_hex else f0.raw_dtype()
            self.width = (self.features[0].seq_len or 1) if f0.seq_len else len(self.features)
            self.hex_width = f0.hex_width
        elif kind == NodeType.CROSS:
            a, b = parents
            if a.width != b.width:
                raise ValueError(f"cross: width mismatch {a.width} vs {b.width}")
            op.validate(a.dtype)
            op.validate(b.dtype)
            self.dtype = np.dtype(np.int32)
            self.width = a.width
            self.hex_width = 0
        else:
            (p,) = parents
            op.validate(p.dtype)
            self.dtype = op.out_dtype(p.dtype)
            self.width = p.width * op.width_factor()
            self.hex_width = 0

    def __or__(self, op: ops_lib.Operator) -> "Node":
        """``node | Operator()`` chains a transform."""
        if isinstance(op, Vocab):
            return op._attach(self)
        if isinstance(op, (ops_lib.VocabGen, ops_lib.VocabMap)):
            raise TypeError("use the Vocab(...) sugar; VocabGen/VocabMap are "
                            "planned as a fit/apply pair")
        if not isinstance(op, ops_lib.Operator):
            raise TypeError(f"expected Operator, got {type(op)}")
        return Node(NodeType.OP, graph=self.graph, parents=(self,), op=op,
                    group_kind=self.group_kind)

    def __repr__(self):
        o = self.op.name if self.op else ",".join(f.name for f in self.features[:3])
        return f"<{self.kind}:{self.id} {o} w={self.width} {self.dtype}>"


class Vocab:
    """Sugar: plans into VocabGen (fit phase) + VocabMap (apply phase).

    ``node | Vocab(capacity)`` — the paper's Fig 5 pattern where VocabGen's
    keyed reduction builds the table and VocabMap performs keyed lookups
    against the frozen, partitioned table.
    """

    def __init__(self, capacity: int, min_count: int = 1):
        self.capacity = capacity
        self.min_count = min_count

    def _attach(self, parent: Node) -> Node:
        gen = ops_lib.VocabGen(capacity=self.capacity,
                               min_count=self.min_count)
        node = Node(NodeType.VOCAB, graph=parent.graph, parents=(parent,),
                    op=gen, group_kind=parent.group_kind)
        node.vocab_map = ops_lib.VocabMap(capacity=self.capacity)
        node.dtype = np.dtype(np.int32)
        node.width = parent.width
        return node


class Graph:
    """Holds every node created under one Pipeline."""

    def __init__(self, schema: Schema):
        self.schema = schema
        self.nodes: list[Node] = []

    # --- sources -------------------------------------------------------

    def source(self, pattern: str) -> Node:
        feats = self.schema.select(pattern)
        kinds = {f.kind for f in feats}
        if len(kinds) != 1:
            raise ValueError(f"pattern {pattern!r} mixes feature kinds {kinds}")
        hexw = {f.hex_width for f in feats}
        if len(hexw) != 1:
            raise ValueError(f"pattern {pattern!r} mixes hex widths")
        seqs = {f.seq_len for f in feats}
        if len(seqs) != 1 or (seqs != {0} and len(feats) != 1):
            raise ValueError("token (sequence) sources must select a single column")
        return Node(NodeType.SOURCE, graph=self, features=feats,
                    group_kind=feats[0].kind)

    def cross(self, a: Node, b: Node, m: int) -> Node:
        return Node(NodeType.CROSS, graph=self, parents=(a, b),
                    op=ops_lib.Cartesian(m=m), group_kind="sparse")

    # --- traversal helpers ----------------------------------------------

    def topo_order(self, sinks: list[Node]) -> list[Node]:
        seen: dict[str, Node] = {}
        order: list[Node] = []

        def visit(n: Node):
            if n.id in seen:
                return
            seen[n.id] = n
            for p in n.parents:
                visit(p)
            order.append(n)

        for s in sinks:
            visit(s)
        return order
