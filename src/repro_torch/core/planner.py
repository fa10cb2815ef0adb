"""Planner: lowers the symbolic DAG into an ExecutionPlan (paper §3.1).

The five planning steps mirror the paper's planner-compiler:
  (1) freeze operator parameters + verify type/shape constraints
      (done eagerly at DAG construction; re-checked here),
  (2) fuse compatible stateless operators into streaming stages,
  (3) choose parallelism: N lanes x W vector width per stage,
  (4) place vocabulary state in VMEM (BRAM analogue) or HBM and size tables,
  (5) emit the runtime plan: stage list, buffer specs, batching policy.

A sixth, plan-level pass groups the per-output stage chains into
``DataflowProgram`` nodes (the paper's full streaming dataflow: operators
connected by on-chip FIFOs ending in the format-aware packer).  Each program
is the backward slice of stages feeding one ``PackOutput``; a legality check
decides whether the slice can lower to a *single* streaming kernel (all
tables VMEM-resident, per-tile working set within budget).  Illegal programs
fall back to stage-at-a-time lowering, so fusion is an optimization, never a
constraint on expressible plans.

The same pass covers the *fit* phase: each ``VocabFit`` gets a ``FitProgram``
— the backward stage slice from its input buffer — whose legality check
mirrors the apply one but accounts for the build-side accumulators (the
chunk first-occurrence and count tables live in VMEM across the whole grid,
so an HBM-placed capacity is illegal and falls back to the staged build).

The plan is backend-neutral; compiler.py lowers it to numpy / torch / cuda.

Legality is the JAX package's *logical* judgement, unchanged, so both
packages make the same plan decisions ("VMEM" in the names below is the
reference's budget vocabulary).  The TPU-only lane-padding / gather-scratch
pass of the reference is not carried over: the CUDA dataflow kernels take
the plan's ``row_tile`` as the most rows a tile has and halve it until one
block's shared memory fits its target (``kernels/dataflow.py``); no result
depends on the tile.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import operators as ops_lib
from repro_torch.core.dag import Graph, Node, NodeType

VMEM_TABLE_BUDGET = 4 * 1024 * 1024  # tables at or under this live in VMEM
DATAFLOW_BLOCK_ROWS = 256  # row-tile granularity of the fused dataflow kernels

# fallback taxonomy for the legality passes (lowering_report.reason_kind):
#   "hex-terminal"    terminal is a raw hex block the packer cannot emit
#   "stage-kind"      a sliced stage has no tile codegen
#   "hbm-table"       a table / accumulator set is HBM-resident
#   "budget"          the per-tile working set exceeds dataflow_vmem_budget
FALLBACK_HEX_TERMINAL = "hex-terminal"
FALLBACK_STAGE_KIND = "stage-kind"
FALLBACK_HBM_TABLE = "hbm-table"
FALLBACK_BUDGET = "budget"


@dataclasses.dataclass
class BufferSpec:
    name: str
    width: int
    dtype: np.dtype
    hex_width: int = 0

    @property
    def bytes_per_row(self) -> int:
        per = self.dtype.itemsize * self.width
        return per * (self.hex_width or 1)


@dataclasses.dataclass
class FusedStage:
    """A chain of fusable stateless ops -> one streaming kernel (Stage-A)."""

    stage_id: str
    in_buf: str
    out_buf: str
    ops: list
    in_dtype: np.dtype
    out_dtype: np.dtype
    in_hex_width: int = 0
    # parallelism hints (step 3): N lanes x W vector width
    lanes: int = 8
    vector_width: int = 128

    @property
    def flops_per_elem(self) -> float:
        return sum(op.flops_per_elem for op in self.ops)


@dataclasses.dataclass
class CrossStage:
    stage_id: str
    op: ops_lib.Cartesian
    in_a: str
    in_b: str
    out_buf: str


@dataclasses.dataclass
class OneHotStage:
    stage_id: str
    op: ops_lib.OneHot
    in_buf: str
    out_buf: str


@dataclasses.dataclass
class VocabLookupStage:
    stage_id: str
    vocab_id: str
    in_buf: str
    out_buf: str
    capacity: int
    placement: str  # "vmem" | "hbm"


@dataclasses.dataclass
class VocabFit:
    vocab_id: str
    in_buf: str
    capacity: int
    placement: str
    min_count: int = 1


@dataclasses.dataclass
class PackOutput:
    """One tensor of the packed, training-ready batch."""

    name: str
    buffers: list[str]
    dtype: np.dtype
    pad_cols_to: int = 1  # pad concat width up to a multiple (128 for TPU)
    squeeze: bool = False  # emit (rows,) instead of (rows, 1)


@dataclasses.dataclass
class DataflowProgram:
    """Backward stage slice feeding one PackOutput (plan-level fusion node).

    When ``legal``, the compiler lowers the whole slice — elementwise chains,
    hex decode, vocab rank-lookup, one-hot expansion and the packing epilogue
    — to ONE row-tiled streaming kernel with no intermediate HBM tensors.
    When illegal (``reason`` says why), the output lowers stage-at-a-time.
    """

    output: str                    # PackOutput.name
    stage_ids: list[str]           # topo-ordered slice of plan.stages
    source_buffers: list[str]      # raw inputs the slice reads
    vocab_ids: list[str]           # tables consumed, in lookup-stage order
    legal: bool = True
    reason: str = ""
    reason_kind: str = ""          # one of the FALLBACK_* kinds, "" if legal

    @property
    def n_stages(self) -> int:
        return len(self.stage_ids)


@dataclasses.dataclass
class FitProgram:
    """Backward stage slice feeding one VocabFit (fit-phase fusion node).

    When ``legal``, the compiler lowers the whole fit chunk for this vocab —
    decode, elementwise bounding chains, cross joins — plus the chunk
    first-occurrence + count build to ONE row-tiled streaming kernel, with
    no intermediate HBM tensors between the upstream chains and the build.
    When illegal (``reason`` says why, e.g. an HBM-placed capacity whose
    accumulators cannot stay VMEM-resident), the vocab fits stage-at-a-time.
    """

    vocab_id: str
    in_buf: str                    # VocabFit.in_buf (the value stream)
    capacity: int
    stage_ids: list[str]           # topo-ordered slice of plan.stages
    source_buffers: list[str]      # raw inputs the slice reads
    legal: bool = True
    reason: str = ""
    reason_kind: str = ""          # one of the FALLBACK_* kinds, "" if legal

    @property
    def n_stages(self) -> int:
        return len(self.stage_ids)


@dataclasses.dataclass
class DataflowGroup:
    """Several PackOutputs lowered together as ONE streaming kernel.

    Emitted by the optimizer (core/optimizer.py): legal per-output
    ``DataflowProgram``s whose *merged* backward slice still fits one VMEM
    budget are grouped, so stages shared between outputs (decode, bounding
    chains) execute exactly once per tile instead of once per output.
    Groups always hold >= 2 outputs; ungrouped outputs keep their
    per-output program (the first rung of the fallback ladder:
    grouped -> per-output fused -> staged).
    """

    outputs: list[str]             # PackOutput names, pack order
    stage_ids: list[str]           # merged topo-ordered slice
    source_buffers: list[str]      # union of raw inputs, plan order
    vocab_ids: list[str]           # union of tables, lookup-stage order

    @property
    def n_outputs(self) -> int:
        return len(self.outputs)


@dataclasses.dataclass
class ExecutionPlan:
    buffers: dict[str, BufferSpec]
    stages: list  # topological order, apply phase
    fit_stage_ids: list[str]  # subset of stages also needed during fit
    vocab_fits: list[VocabFit]
    pack: list[PackOutput]
    source_buffers: list[str]
    dataflows: list[DataflowProgram] = dataclasses.field(default_factory=list)
    fit_dataflows: list[FitProgram] = dataclasses.field(default_factory=list)
    # source buffer -> raw column names it reads (planner column-set export;
    # consumed by repro.session to push projection into any Source)
    source_columns: dict = dataclasses.field(default_factory=dict)
    # multi-output fused groups (filled by the optimizer pass; empty when
    # the plan was not optimized or nothing grouped)
    groups: list[DataflowGroup] = dataclasses.field(default_factory=list)
    # fused-kernel per-tile working-set bound the legality passes used;
    # recorded here so the optimizer re-checks merged slices with the same
    # budget the planner checked per-output slices with
    dataflow_vmem_budget: int = 0
    # row-tile granularity of the fused dataflow kernels.  A tunable knob
    # (the controller's ``row_tile``): every legality pass and every kernel
    # builder reads it, so re-planning at a new tile re-judges legality —
    # bigger tiles amortize grid overhead but can push a slice over the
    # VMEM budget and back to the staged path
    row_tile: int = DATAFLOW_BLOCK_ROWS
    # what the optimizer did to this plan (see ExecutionPlan.optimize_report)
    opt_info: dict = dataclasses.field(default_factory=dict)

    def stage_by_id(self, sid: str):
        for s in self.stages:
            if s.stage_id == sid:
                return s
        raise KeyError(sid)

    def _columns_for(self, bufs) -> list[str]:
        seen: set = set()
        out: list[str] = []
        for buf in self.source_buffers:
            if buf not in bufs:
                continue
            for c in self.source_columns.get(buf, ()):
                if c not in seen:
                    seen.add(c)
                    out.append(c)
        return out

    def referenced_columns(self) -> list[str]:
        """Raw column names the apply program reads, in schema order.

        A Source projected to exactly this set feeds the pipeline without
        materializing any unreferenced column (projection pushdown)."""
        return self._columns_for(set(self.source_buffers))

    def fit_buffers(self) -> set:
        """Every buffer the fit phase touches (the vocab-fit closure):
        VocabFit inputs plus all inputs of the fit stages.  Single source
        of truth — the compiler's fit gather and the fit-read projection
        both derive from this set."""
        needed = {vf.in_buf for vf in self.vocab_fits}
        fit_ids = set(self.fit_stage_ids)
        for s in self.stages:
            if s.stage_id in fit_ids:
                for attr in ("in_buf", "in_a", "in_b"):
                    b = getattr(s, attr, None)
                    if b:
                        needed.add(b)
        return needed

    def fit_source_buffers(self) -> list[str]:
        """Source buffers (in plan order) the fit phase reads."""
        needed = self.fit_buffers()
        return [b for b in self.source_buffers if b in needed]

    def fit_referenced_columns(self) -> list[str]:
        """Raw column names the *fit* phase reads (the vocab-fit closure) —
        a subset of ``referenced_columns``; dense-only inputs never load
        during fit when the fit Source is projected to this set."""
        return self._columns_for(self.fit_buffers())

    def _slice_to(self, needed: set) -> list[str]:
        """Topo-ordered stage ids in the backward slice of ``needed`` bufs."""
        needed = set(needed)
        ids: list[str] = []
        for s in reversed(self.stages):
            if getattr(s, "out_buf", None) in needed:
                ids.append(s.stage_id)
                for attr in ("in_buf", "in_a", "in_b"):
                    b = getattr(s, attr, None)
                    if b:
                        needed.add(b)
        return list(reversed(ids))

    def output_slice(self, po: PackOutput) -> list[str]:
        """Topo-ordered stage ids in the backward slice of one output."""
        return self._slice_to(set(po.buffers))

    def fit_slice(self, vf: VocabFit) -> list[str]:
        """Topo-ordered stage ids in the backward slice of one vocab fit."""
        return self._slice_to({vf.in_buf})

    def optimize_report(self) -> dict:
        """What the optimizer pass did to this plan.

        Keys: ``optimized`` (bool), ``cse`` (merged stage/vocab counts),
        ``pushdown`` (dead stages/sources dropped), ``groups`` (output-name
        lists, one per ``DataflowGroup``), ``grouping`` (per-output decision
        string).  An unoptimized plan reports ``optimized=False`` with zero
        counts.
        """
        base = {"optimized": False,
                "cse": {"merged_sources": 0, "merged_stages": 0,
                        "merged_vocabs": 0},
                "pushdown": {"dead_stages": 0, "dead_sources": 0},
                "groups": [], "grouping": {}}
        base.update(self.opt_info)
        return base

    # ---- Table-4 analogue: resource summary -----------------------------
    def resource_summary(self) -> dict:
        vmem = sum(4 * v.capacity for v in self.vocab_fits if v.placement == "vmem")
        hbm = sum(4 * v.capacity for v in self.vocab_fits if v.placement == "hbm")
        flops_row = 0.0
        bytes_row = 0
        for s in self.stages:
            if isinstance(s, FusedStage):
                w = self.buffers[s.in_buf].width
                flops_row += s.flops_per_elem * w
                bytes_row += (self.buffers[s.in_buf].bytes_per_row
                              + self.buffers[s.out_buf].bytes_per_row)
            elif isinstance(s, (CrossStage, OneHotStage, VocabLookupStage)):
                bytes_row += self.buffers[s.out_buf].bytes_per_row
        return {"vmem_table_bytes": vmem, "hbm_table_bytes": hbm,
                "flops_per_row": flops_row, "bytes_per_row": bytes_row,
                "n_stages": len(self.stages), "n_vocabs": len(self.vocab_fits)}


class Planner:
    def __init__(self, graph: Graph, *, vmem_budget: int = VMEM_TABLE_BUDGET,
                 lanes: int = 8, vector_width: int = 128,
                 dataflow_vmem_budget: Optional[int] = None,
                 row_tile: int = DATAFLOW_BLOCK_ROWS):
        self.graph = graph
        self.vmem_budget = vmem_budget
        self.lanes = lanes
        self.vector_width = vector_width
        self.row_tile = max(1, int(row_tile))
        # Fused-kernel per-tile working-set bound (stream tiles +
        # intermediates + tables + output tile, double-buffered).  It tracks
        # the user's declared VMEM headroom: tables (each <= vmem_budget by
        # placement) plus equal tile space — 8 MiB at the 4 MiB default,
        # ~half a TPU core's VMEM, leaving room for the compiler.
        self.dataflow_vmem_budget = (2 * vmem_budget
                                     if dataflow_vmem_budget is None
                                     else dataflow_vmem_budget)

    def plan(self, pack_outputs: list[tuple[str, list[Node], np.dtype, int, bool]]
             ) -> ExecutionPlan:
        sinks = [n for _, nodes, _, _, _ in pack_outputs for n in nodes]
        order = self.graph.topo_order(sinks)

        # consumers count: multi-consumer intermediates must materialize
        consumers: dict[str, int] = {}
        for n in order:
            for p in n.parents:
                consumers[p.id] = consumers.get(p.id, 0) + 1
        sink_ids = {n.id for n in sinks}

        buffers: dict[str, BufferSpec] = {}
        stages: list = []
        vocab_fits: list[VocabFit] = []
        source_buffers: list[str] = []
        source_columns: dict[str, list[str]] = {}
        # node.id -> (base buffer name, pending fusable ops, in_dtype, hex_w)
        chain: dict[str, tuple] = {}
        materialized: dict[str, str] = {}  # node.id -> buffer name
        stage_n = 0

        def new_stage_id():
            nonlocal stage_n
            stage_n += 1
            return f"s{stage_n}"

        def materialize(node: Node) -> str:
            """Ensure node's value exists as a named buffer; emit stages."""
            if node.id in materialized:
                return materialized[node.id]
            base, pending, in_dtype, hexw = chain[node.id]
            if not pending:
                materialized[node.id] = base
                return base
            out = node.id
            buffers[out] = BufferSpec(out, node.width, np.dtype(node.dtype))
            stages.append(FusedStage(
                stage_id=new_stage_id(), in_buf=base, out_buf=out,
                ops=list(pending), in_dtype=np.dtype(in_dtype),
                out_dtype=np.dtype(node.dtype), in_hex_width=hexw,
                lanes=self.lanes, vector_width=self.vector_width))
            materialized[node.id] = out
            return out

        for node in order:
            if node.kind == NodeType.SOURCE:
                buffers[node.id] = BufferSpec(node.id, node.width,
                                              np.dtype(node.dtype),
                                              hex_width=node.hex_width)
                source_buffers.append(node.id)
                source_columns[node.id] = [f.name for f in node.features]
                chain[node.id] = (node.id, [], node.dtype, node.hex_width)
                materialized[node.id] = node.id
            elif node.kind == NodeType.OP and node.op.fusable:
                (p,) = node.parents
                base, pending, in_dtype, hexw = chain[p.id]
                if consumers.get(p.id, 0) > 1 and pending:
                    # parent reused elsewhere: materialize it, start new chain
                    pbuf = materialize(p)
                    base, pending, in_dtype, hexw = pbuf, [], p.dtype, 0
                chain[node.id] = (base, pending + [node.op], in_dtype, hexw)
                if node.id in sink_ids or consumers.get(node.id, 0) != 1:
                    materialize(node)
            else:
                # fusion boundary: cross / onehot / vocab
                parent_bufs = [materialize(p) for p in node.parents]
                out = node.id
                sid = new_stage_id()
                if node.kind == NodeType.CROSS:
                    buffers[out] = BufferSpec(out, node.width, np.dtype(np.int32))
                    stages.append(CrossStage(sid, node.op, parent_bufs[0],
                                             parent_bufs[1], out))
                elif node.kind == NodeType.VOCAB:
                    cap = node.op.capacity
                    placement = ("vmem" if node.op.table_bytes() <= self.vmem_budget
                                 else "hbm")
                    vocab_id = f"vocab_{out}"
                    vocab_fits.append(VocabFit(vocab_id, parent_bufs[0], cap,
                                               placement,
                                               min_count=node.op.min_count))
                    buffers[out] = BufferSpec(out, node.width, np.dtype(np.int32))
                    stages.append(VocabLookupStage(sid, vocab_id, parent_bufs[0],
                                                   out, cap, placement))
                elif isinstance(node.op, ops_lib.OneHot):
                    buffers[out] = BufferSpec(out, node.width,
                                              np.dtype(node.op.out_dtype(None)))
                    stages.append(OneHotStage(sid, node.op, parent_bufs[0], out))
                else:
                    raise NotImplementedError(f"node {node}")
                chain[node.id] = (out, [], node.dtype, 0)
                materialized[node.id] = out

        # force-materialize every pack input
        pack = []
        for name, nodes, dtype, pad_to, squeeze in pack_outputs:
            bufs = [materialize(n) for n in nodes]
            pack.append(PackOutput(name, bufs, np.dtype(dtype), pad_to, squeeze))

        fit_stage_ids = self._fit_closure(stages, vocab_fits)
        plan = ExecutionPlan(buffers=buffers, stages=stages,
                             fit_stage_ids=fit_stage_ids,
                             vocab_fits=vocab_fits, pack=pack,
                             source_buffers=source_buffers,
                             source_columns=source_columns,
                             dataflow_vmem_budget=self.dataflow_vmem_budget,
                             row_tile=self.row_tile)
        build_plan_programs(plan)
        return plan

    @staticmethod
    def _fit_closure(stages, vocab_fits) -> list[str]:
        """Stage ids needed to produce every VocabFit input buffer."""
        needed: set[str] = {vf.in_buf for vf in vocab_fits}
        fit_ids: list[str] = []
        for s in reversed(stages):
            outs = {getattr(s, "out_buf", None)}
            if outs & needed:
                fit_ids.append(s.stage_id)
                for attr in ("in_buf", "in_a", "in_b"):
                    b = getattr(s, attr, None)
                    if b:
                        needed.add(b)
        return list(reversed(fit_ids))


# ---- step 6: plan-level fusion (one streaming program per output) ----------
#
# Module-level so the optimizer (core/optimizer.py) re-runs the same legality
# checks after rewriting the plan — per-output programs and merged groups are
# judged by identical VMEM arguments against ``plan.dataflow_vmem_budget``.

FUSABLE_STAGES = (FusedStage, CrossStage, OneHotStage, VocabLookupStage)
# stateless kinds the fit-side tile codegen knows; a lookup can never
# legally precede a fit (tables are unfitted then), so it is excluded
FIT_FUSABLE_STAGES = (FusedStage, CrossStage, OneHotStage)


def slice_sources(stages, terminals) -> list[str]:
    """Slice inputs (incl. terminals) that no slice stage produces."""
    produced = {s.out_buf for s in stages}
    consumed: list[str] = []
    for s in stages:
        for attr in ("in_buf", "in_a", "in_b"):
            b = getattr(s, attr, None)
            if b:
                consumed.append(b)
    sources: list[str] = []
    for b in consumed + list(terminals):
        if b not in produced and b not in sources:
            sources.append(b)
    return sources


def stream_tile_bytes(plan: ExecutionPlan, stages, sources,
                      *, block_rows: Optional[int] = None) -> int:
    """VMEM bytes of one row tile of every buffer a slice touches.

    ``block_rows`` defaults to ``plan.row_tile`` (as do the other sizing
    helpers below), so legality is always judged at the tile the kernels
    will actually run."""
    if block_rows is None:
        block_rows = plan.row_tile
    produced = {s.out_buf for s in stages}
    return sum(block_rows * plan.buffers[b].bytes_per_row
               for b in set(sources) | produced)


def packed_output_bytes(plan: ExecutionPlan, po: PackOutput,
                        *, block_rows: Optional[int] = None) -> int:
    """VMEM bytes of one packed output tile (width padded per the layout)."""
    if block_rows is None:
        block_rows = plan.row_tile
    out_w = sum(plan.buffers[b].width for b in po.buffers)
    padded_w = -(-out_w // po.pad_cols_to) * po.pad_cols_to
    return block_rows * padded_w * po.dtype.itemsize


def build_dataflow_program(plan: ExecutionPlan, po: PackOutput,
                           *, block_rows: Optional[int] = None
                           ) -> DataflowProgram:
    """Backward-slice the stages feeding ``po`` and check legality.

    Legal programs lower to a single row-tiled streaming kernel, so the
    check is a VMEM feasibility argument: every buffer the slice touches
    contributes one (block_rows x width) tile, every vocab table is
    staged whole (it must be VMEM-placed), and the packed output tile
    rides along.  Anything over budget — or any HBM-resident table, or a
    stage kind the tile codegen does not know — falls back to the staged
    path for this output only, with ``reason_kind`` naming the fallback
    class (budget vs stage kind vs HBM table vs hex terminal).
    """
    if block_rows is None:
        block_rows = plan.row_tile
    stage_ids = plan.output_slice(po)
    stages = [plan.stage_by_id(sid) for sid in stage_ids]
    sources = slice_sources(stages, po.buffers)

    vocab_ids: list[str] = []
    for s in stages:
        if isinstance(s, VocabLookupStage) and s.vocab_id not in vocab_ids:
            vocab_ids.append(s.vocab_id)

    def illegal(reason: str, kind: str) -> DataflowProgram:
        return DataflowProgram(po.name, stage_ids, sources, vocab_ids,
                               legal=False, reason=reason, reason_kind=kind)

    for b in po.buffers:
        if plan.buffers[b].hex_width:
            return illegal(f"terminal {b} is a raw hex block; the packer "
                           "epilogue writes 2-D lane tiles only",
                           FALLBACK_HEX_TERMINAL)
    for s in stages:
        if not isinstance(s, FUSABLE_STAGES):
            return illegal(f"unsupported stage {type(s).__name__}",
                           FALLBACK_STAGE_KIND)
    for s in stages:
        if isinstance(s, VocabLookupStage) and s.placement != "vmem":
            return illegal(f"vocab {s.vocab_id} is {s.placement}-resident; "
                           "the streaming kernel stages tables in VMEM",
                           FALLBACK_HBM_TABLE)

    tile_bytes = stream_tile_bytes(plan, stages, sources,
                                   block_rows=block_rows)
    table_bytes = sum(4 * s.capacity for s in stages
                      if isinstance(s, VocabLookupStage))
    out_bytes = packed_output_bytes(plan, po, block_rows=block_rows)
    working_set = 2 * (tile_bytes + out_bytes) + table_bytes
    if working_set > plan.dataflow_vmem_budget:
        return illegal(f"per-tile working set {working_set} exceeds "
                       f"budget {plan.dataflow_vmem_budget}",
                       FALLBACK_BUDGET)
    return DataflowProgram(po.name, stage_ids, sources, vocab_ids)


def build_fit_program(plan: ExecutionPlan, vf: VocabFit,
                      *, block_rows: Optional[int] = None) -> FitProgram:
    """Backward-slice the stages feeding ``vf`` and check fit legality.

    Legal programs lower decode + bound + first-occurrence/count build to
    a single row-tiled kernel, so the VMEM argument adds the build-side
    accumulators: two int32[capacity] tables (chunk first-pos + counts)
    stay resident across the whole grid.  An HBM-placed vocab therefore
    falls back (its capacity is exactly what exceeded the table budget),
    as does any stage kind the fit tile codegen does not know or an
    over-budget working set — staged per vocab, never per pipeline;
    ``reason_kind`` names the fallback class either way.
    """
    if block_rows is None:
        block_rows = plan.row_tile
    stage_ids = plan.fit_slice(vf)
    stages = [plan.stage_by_id(sid) for sid in stage_ids]
    sources = slice_sources(stages, [vf.in_buf])

    def illegal(reason: str, kind: str) -> FitProgram:
        return FitProgram(vf.vocab_id, vf.in_buf, vf.capacity,
                          stage_ids, sources, legal=False, reason=reason,
                          reason_kind=kind)

    if vf.placement != "vmem":
        return illegal(
            f"vocab {vf.vocab_id} is {vf.placement}-resident; the fused "
            "fit kernel keeps first-pos/count accumulators in VMEM",
            FALLBACK_HBM_TABLE)
    for s in stages:
        if not isinstance(s, FIT_FUSABLE_STAGES):
            return illegal(f"unsupported fit stage {type(s).__name__}",
                           FALLBACK_STAGE_KIND)

    tile_bytes = stream_tile_bytes(plan, stages, sources,
                                   block_rows=block_rows)
    accum_bytes = 2 * 4 * vf.capacity  # first-pos + counts, int32 each
    working_set = 2 * tile_bytes + accum_bytes
    if working_set > plan.dataflow_vmem_budget:
        return illegal(f"per-tile working set {working_set} exceeds "
                       f"budget {plan.dataflow_vmem_budget}", FALLBACK_BUDGET)
    return FitProgram(vf.vocab_id, vf.in_buf, vf.capacity,
                      stage_ids, sources)


def build_plan_programs(plan: ExecutionPlan) -> None:
    """(Re)build the per-output and per-vocab fusion programs in place.

    Called by the planner after step 5 and by the optimizer after every plan
    rewrite, so slices and legality always describe the current stages.
    """
    plan.dataflows = [build_dataflow_program(plan, po) for po in plan.pack]
    plan.fit_dataflows = [build_fit_program(plan, vf)
                          for vf in plan.vocab_fits]
