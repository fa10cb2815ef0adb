"""Compiler: lowers an ExecutionPlan to an executable pipeline (paper §3.1/§3.4).

Three backends share identical semantics (tests pin them against each other
and against the JAX package):

- ``numpy`` : the CPU-baseline oracle (the paper's pandas path); host only.
- ``torch`` : eager plain PyTorch ops, stage by stage (the analogue of the
  JAX package's ``jnp`` backend).
- ``cuda``  : the streaming-dataflow analogue of the paper's FPGA pipeline,
  with the JAX package's ``pallas`` fallback ladder grouped -> fused ->
  staged, chosen per output:

  - grouped / fused: every ``DataflowGroup`` lowers to ONE launch of the
    hand-written group kernel, every legal ungrouped output to one launch
    of the output kernel, and every legal vocabulary fit chunk to one launch
    of the fit kernel (``kernels/dataflow.py``);
  - staged (an HBM-placed table, an over-budget slice, ``fuse="off"`` or a
    per-output ``fuse`` spec): each fused stage is one ``fused_stage``
    launch, each vocabulary lookup one ``vocab_lookup`` launch and each
    non-squeezed output one ``packer`` launch, with the buffers in device
    memory between them; a staged fit chunk runs its stages, then one
    ``vocab_build_chunk`` launch per vocabulary.  Cross and one-hot stages
    and the squeezed outputs run as plain torch ops on the device, as the
    JAX package runs them as plain jnp outside Pallas.

  On ``device="cpu"`` the same encoded programs run through the kernels'
  plain versions (the analogue of Pallas ``interpret=True``).

Plans are rewritten by ``core/optimizer.optimize_plan`` first
(``optimize="auto"``) for every backend, exactly as in the JAX package.

Vocabulary *fit* is streamed: per chunk, first-occurrence positions and
counts; merged into an int32 (chunk, position, count) state; finalized into
rank tables.  Tables are host numpy arrays in ``PipelineState`` (a state
fitted by the JAX package loads as it is), versioned, and uploaded once per
version: in their OOV-resolved form (``table'[v] = rank or n_unique``) for
the dataflow kernels, whose in-kernel lookup is then a pure gather, and raw
with ``n_unique`` for the staged lookups.  The state is bit-identical
whichever lowering fitted it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import operators as ops_lib
from repro_torch.core.dag import NodeType
from repro_torch.core.optimizer import optimize_plan
from repro_torch.core.planner import (CrossStage, DataflowGroup,
                                      DataflowProgram, ExecutionPlan,
                                      FitProgram, FusedStage, OneHotStage,
                                      PackOutput, VocabLookupStage,
                                      build_plan_programs)
from repro_torch.etl_runtime import transfer
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.dataflow import (GroupOutput, StreamInput, TableInput,
                                          TileStep)

BACKENDS = ("numpy", "torch", "cuda")


@dataclasses.dataclass
class PipelineState:
    """Frozen vocabulary tables + version (freshness bookkeeping)."""

    tables: dict  # vocab_id -> int32[capacity] (numpy)
    n_unique: dict  # vocab_id -> int
    version: int = 0


def _chain_torch(stage: FusedStage, x: torch.Tensor) -> torch.Tensor:
    """The fused elementwise chain of one stage, as plain torch ops (a hex
    input arrives digit-major and is consumed by Hex2Int first)."""
    ops_seq = list(stage.ops)
    if stage.in_hex_width and not isinstance(ops_seq[0], ops_lib.Hex2Int):
        raise TypeError("hex source must be consumed by Hex2Int first")
    for op in ops_seq:
        x = op.torch_expr(x)
    return x


def _chain_numpy(stage: FusedStage, x):
    ops_seq = list(stage.ops)
    if stage.in_hex_width:
        if not isinstance(ops_seq[0], ops_lib.Hex2Int):
            raise TypeError("hex source must be consumed by Hex2Int first")
        # numpy path uses trailing-hex layout [rows, cols, w]
        x = ops_seq[0].numpy(x)
        ops_seq = ops_seq[1:]
    for op in ops_seq:
        x = op.numpy(x)
    return x


class CompiledPipeline:
    """Executable ETL pipeline with fit/apply phases."""

    def __init__(self, plan: ExecutionPlan, graph, backend: str = "torch", *,
                 device=None, name: str = "pipeline", fuse="auto",
                 optimize: str = "auto", semantics=None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        # fuse: "auto" / "off", or a per-output spec — a set/sequence of
        # output names to force STAGED, or a {output: bool} dict
        fuse_off: frozenset = frozenset()
        if isinstance(fuse, dict):
            fuse_off = frozenset(k for k, v in fuse.items() if not v)
            fuse = "auto"
        elif isinstance(fuse, (set, frozenset, list, tuple)):
            fuse_off = frozenset(fuse)
            fuse = "auto"
        elif fuse not in ("auto", "off"):
            raise ValueError(f"unknown fuse mode {fuse!r}")
        self._fuse_off = fuse_off
        if optimize not in ("auto", "off"):
            raise ValueError(f"unknown optimize mode {optimize!r}")
        if optimize == "auto":
            plan = optimize_plan(plan)
        self.plan = plan
        self.graph = graph
        self.backend = backend
        # the numpy oracle is host-only; the others run on a resolved device
        self.device = None if backend == "numpy" else resolve_device(device)
        self.name = name
        self.fuse = fuse
        self.optimize = optimize
        self.semantics = semantics
        self._fused_programs: dict[str, DataflowProgram] = {}
        self._fused_fit_programs: dict[str, FitProgram] = {}
        self._active_groups: list[DataflowGroup] = []
        self._grouped_outputs: dict[str, int] = {}
        if backend == "cuda" and fuse == "auto":
            self._fused_programs = {dp.output: dp for dp in plan.dataflows
                                    if dp.legal
                                    and dp.output not in self._fuse_off}
            self._fused_fit_programs = {fp.vocab_id: fp
                                        for fp in plan.fit_dataflows
                                        if fp.legal}
            self._active_groups = [g for g in plan.groups
                                   if all(o in self._fused_programs
                                          for o in g.outputs)]
            self._grouped_outputs = {o: gi
                                     for gi, g in enumerate(self._active_groups)
                                     for o in g.outputs}
        self.state = PipelineState(
            tables={vf.vocab_id: np.full(vf.capacity, -1, np.int32)
                    for vf in plan.vocab_fits},
            n_unique={vf.vocab_id: 0 for vf in plan.vocab_fits},
            version=0)
        self._source_nodes = {n.id: n for n in graph.nodes
                              if n.kind == NodeType.SOURCE}
        self._table_cache: tuple = (-1, ({}, {}))
        self._staged_vocab_ids: list[str] = []
        self._fit_bufs = plan.fit_source_buffers()
        # kernel calls per phase on the cuda backend, either route (CUDA
        # launch or plain version): the counterpart of
        # traced_pallas_call_count
        self.dataflow_calls = {"apply": 0, "fit": 0}
        if backend != "numpy":
            self._apply_fn = self._build_apply()
            self._fit_chunk_fn = self._build_fit_chunk()

    # ------------------------------------------------------------------
    # knob recompilation
    # ------------------------------------------------------------------

    def kernel_tiles(self) -> tuple:
        """Rows per tile of every dataflow kernel (groups, solo outputs,
        fits, in build order) on the ``cuda`` backend, else ``()``."""
        if self.backend != "cuda":
            return ()
        fns = [*self._group_fns, *self._solo_fns.values(),
               *self._fit_fns.values()]
        return tuple(fn.program.tile_rows() for fn in fns)

    def fuse_spec(self):
        """The current fuse setting in ``with_knobs``-compatible form."""
        if self.fuse == "off":
            return "off"
        return frozenset(self._fuse_off) if self._fuse_off else "auto"

    def with_knobs(self, *, row_tile: Optional[int] = None, fuse=None):
        """Recompile at new knob settings, SHARING vocabulary state.

        ``row_tile`` re-judges legality at the new plan tile and caps the
        dataflow kernels' rows per tile (``kernel_tiles``); ``fuse``
        takes the constructor's forms.  The returned pipeline aliases
        ``self.state``."""
        new_tile = (self.plan.row_tile if row_tile is None
                    else max(1, int(row_tile)))
        new_fuse = self.fuse_spec() if fuse is None else fuse
        plan = dataclasses.replace(
            self.plan, dataflows=[], fit_dataflows=[], groups=[],
            opt_info={}, row_tile=new_tile)
        build_plan_programs(plan)
        new = CompiledPipeline(plan, self.graph, self.backend,
                               device=self.device, name=self.name,
                               fuse=new_fuse, optimize=self.optimize,
                               semantics=self.semantics)
        new.state = self.state
        return new

    # ------------------------------------------------------------------
    # source assembly: raw columnar batch -> source buffers
    # ------------------------------------------------------------------

    def _gather_sources(self, raw: dict, buffers=None) -> dict:
        """numpy backend: assemble column blocks on the host."""
        out = {}
        for buf in (self.plan.source_buffers if buffers is None else buffers):
            feats = self._source_nodes[buf].features
            if feats[0].seq_len:  # token column: (rows, seq)
                out[buf] = np.asarray(raw[feats[0].name])
            else:  # hex: (rows, n, w); dense: (rows, n)
                out[buf] = np.stack([np.asarray(raw[f.name]) for f in feats],
                                    axis=1)
        return out

    def _device_columns(self, raw: dict, buffers=None) -> dict:
        """The raw columns the source buffers read, on this device."""
        cols = {}
        for buf in (self.plan.source_buffers if buffers is None else buffers):
            for f in self._source_nodes[buf].features:
                cols[f.name] = raw[f.name]
        return transfer.to_device(cols, self.device)

    def _assemble_sources(self, cols: dict, buffers=None) -> dict:
        """Device-side assembly: dense [rows, n], hex digit-major
        uint8[w, rows, n], token [rows, seq]."""
        out = {}
        for buf in (self.plan.source_buffers if buffers is None else buffers):
            feats = self._source_nodes[buf].features
            if feats[0].seq_len:
                out[buf] = cols[feats[0].name]
            elif feats[0].is_hex:
                stacked = torch.stack([cols[f.name] for f in feats], dim=1)
                out[buf] = stacked.permute(2, 0, 1).contiguous()
            else:
                out[buf] = torch.stack([cols[f.name] for f in feats], dim=1)
        return out

    # ------------------------------------------------------------------
    # stage interpreters (numpy oracle, torch eager)
    # ------------------------------------------------------------------

    def _run_stages_numpy(self, bufs: dict, stage_ids=None,
                          state: Optional[PipelineState] = None) -> dict:
        state = self.state if state is None else state
        for s in self.plan.stages:
            if stage_ids is not None and s.stage_id not in stage_ids:
                continue
            if isinstance(s, FusedStage):
                bufs[s.out_buf] = _chain_numpy(s, bufs[s.in_buf])
            elif isinstance(s, CrossStage):
                bufs[s.out_buf] = s.op.numpy2(bufs[s.in_a], bufs[s.in_b])
            elif isinstance(s, OneHotStage):
                bufs[s.out_buf] = s.op.numpy(bufs[s.in_buf])
            elif isinstance(s, VocabLookupStage):
                vm = ops_lib.VocabMap(s.capacity)
                bufs[s.out_buf] = vm.numpy_apply(
                    bufs[s.in_buf], np.asarray(state.tables[s.vocab_id]))
            else:
                raise NotImplementedError(type(s))
        return bufs

    def _stage_fns(self, needed_ids: set) -> dict:
        """Per-stage callables keyed by stage id, for the stages the staged
        path runs: on cuda the ``fused_stage`` and ``vocab_lookup`` kernels,
        on torch plain ops.  Cross and one-hot stages are plain torch ops on
        both, as the JAX package runs them as plain jnp outside Pallas."""
        cuda = self.backend == "cuda"
        fns = {}
        for s in self.plan.stages:
            if s.stage_id not in needed_ids:
                continue
            if isinstance(s, FusedStage):
                fns[s.stage_id] = (
                    kops.fused_stage(s.ops, in_dtype=s.in_dtype,
                                     out_dtype=s.out_dtype,
                                     hex_width=s.in_hex_width)
                    if cuda else functools.partial(_chain_torch, s))
            elif isinstance(s, CrossStage):
                fns[s.stage_id] = s.op.torch_expr2
            elif isinstance(s, OneHotStage):
                fns[s.stage_id] = s.op.torch_expr
            elif isinstance(s, VocabLookupStage):
                fns[s.stage_id] = (kops.vocab_lookup if cuda
                                   else kref.vocab_lookup)
            else:
                raise NotImplementedError(type(s))
        return fns

    def _caller(self, phase: str, trace: Optional[list]) -> Callable:
        """``call(kernel, what, runner, args)`` runs one kernel call of a
        phase.  On cuda it counts the call in ``dataflow_calls`` or, when
        ``trace`` is a list, records ``(kernel, what, runner, args)`` there
        instead; plain torch ops are neither counted nor recorded."""
        cuda = self.backend == "cuda"

        def call(kname: str, what, fn, args: list):
            if cuda and trace is not None:
                trace.append((kname, what, fn, args))
            elif cuda:
                self.dataflow_calls[phase] += 1
            return fn(*args)

        return call

    def _run_staged(self, bufs: dict, stage_ids: set, fns: dict, tables,
                    call: Callable) -> None:
        """Run the staged stages in plan order, each buffer materialized
        whole before the next stage reads it.  ``tables``: vocab id ->
        (raw table, n_unique) on the device, None in the fit phase."""
        for s in self.plan.stages:
            if s.stage_id not in stage_ids:
                continue
            fn = fns[s.stage_id]
            if isinstance(s, FusedStage):
                bufs[s.out_buf] = call("fused_stage", s.out_buf, fn,
                                       [bufs[s.in_buf]])
            elif isinstance(s, CrossStage):
                bufs[s.out_buf] = fn(bufs[s.in_a], bufs[s.in_b])
            elif isinstance(s, OneHotStage):
                bufs[s.out_buf] = fn(bufs[s.in_buf])
            else:  # VocabLookupStage
                if tables is None:
                    raise AssertionError("lookup cannot precede fit")
                tbl, n = tables[s.vocab_id]
                bufs[s.out_buf] = call("vocab_lookup", s.out_buf, fn,
                                       [bufs[s.in_buf], tbl, n])

    # ------------------------------------------------------------------
    # lowering to the dataflow kernels (cuda backend)
    # ------------------------------------------------------------------

    def _stream_inputs(self, buffers) -> list:
        plan = self.plan
        return [StreamInput(b, plan.buffers[b].width, plan.buffers[b].dtype,
                            plan.buffers[b].hex_width) for b in buffers]

    def _tile_steps(self, stage_ids, vocab_ids=()) -> tuple:
        """TileStep program + TableInput list for a slice (lookup steps
        resolved against the slice's vocab table order)."""
        tbl_index = {vid: i for i, vid in enumerate(vocab_ids)}
        tables: list = [None] * len(vocab_ids)
        steps: list = []
        for sid in stage_ids:
            s = self.plan.stage_by_id(sid)
            if isinstance(s, FusedStage):
                steps.append(TileStep("map", s.out_buf, (s.in_buf,),
                                      ops=tuple(s.ops)))
            elif isinstance(s, CrossStage):
                steps.append(TileStep("join", s.out_buf, (s.in_a, s.in_b),
                                      ops=(s.op,)))
            elif isinstance(s, OneHotStage):
                steps.append(TileStep("map", s.out_buf, (s.in_buf,),
                                      ops=(s.op,)))
            elif isinstance(s, VocabLookupStage):
                idx = tbl_index[s.vocab_id]
                tables[idx] = TableInput(s.vocab_id, s.capacity)
                steps.append(TileStep("lookup", s.out_buf, (s.in_buf,),
                                      table=idx))
            else:  # pragma: no cover - legality passes reject these
                raise NotImplementedError(type(s))
        return steps, tables

    def _build_group_fn(self, group: DataflowGroup):
        """One DataflowGroup -> its single multi-output kernel."""
        steps, tables = self._tile_steps(group.stage_ids, group.vocab_ids)
        outs = []
        for name in group.outputs:
            po = next(p for p in self.plan.pack if p.name == name)
            outs.append(GroupOutput(
                name, tuple((b, self.plan.buffers[b].width) for b in po.buffers),
                po.dtype, po.pad_cols_to))
        return kops.group_dataflow(self._stream_inputs(group.source_buffers),
                                   tables, steps, outs,
                                   row_tile=self.plan.row_tile)

    def _build_dataflow_fn(self, po: PackOutput, dp: DataflowProgram):
        """One legal ungrouped output -> its single-output kernel."""
        steps, tables = self._tile_steps(dp.stage_ids, dp.vocab_ids)
        terminals = [(b, self.plan.buffers[b].width) for b in po.buffers]
        return kops.output_dataflow(self._stream_inputs(dp.source_buffers),
                                    tables, steps, terminals, po.dtype,
                                    pad_cols_to=po.pad_cols_to,
                                    row_tile=self.plan.row_tile)

    def _build_fit_dataflow_fn(self, fp: FitProgram):
        """One legal FitProgram -> its single fit kernel."""
        steps, _ = self._tile_steps(fp.stage_ids)
        return kops.fit_dataflow(self._stream_inputs(fp.source_buffers),
                                 steps, fp.in_buf, fp.capacity,
                                 row_tile=self.plan.row_tile)

    def _build_apply(self) -> Callable:
        """``apply(tables, cols, trace=None) -> packed``: the staged stages
        in plan order, then one kernel per group, then per output its solo
        kernel, its packer or (squeezed outputs, torch) a plain pack."""
        plan = self.plan
        fused = self._fused_programs
        staged_pos = [po for po in plan.pack if po.name not in fused]
        staged_ids: set = ({sid for po in staged_pos
                            for sid in plan.output_slice(po)} if fused
                           else {s.stage_id for s in plan.stages})
        # raw tables reach the device only for staged lookups
        self._staged_vocab_ids = sorted(
            s.vocab_id for s in plan.stages
            if isinstance(s, VocabLookupStage) and s.stage_id in staged_ids)
        fns = self._stage_fns(staged_ids)
        pos = {po.name: po for po in plan.pack}
        self._group_fns = [self._build_group_fn(g)
                           for g in self._active_groups]
        self._solo_fns = {name: self._build_dataflow_fn(pos[name], dp)
                          for name, dp in fused.items()
                          if name not in self._grouped_outputs}
        packers = {}
        if self.backend == "cuda":
            packers = {po.name: kops.packer(
                           [plan.buffers[b].width for b in po.buffers],
                           [plan.buffers[b].dtype for b in po.buffers],
                           po.dtype, pad_cols_to=po.pad_cols_to)
                       for po in staged_pos if not po.squeeze}

        def apply_fn(tables, cols, trace=None):
            resolved, raw = tables
            call = self._caller("apply", trace)
            bufs = self._assemble_sources(cols)
            self._run_staged(bufs, staged_ids, fns, raw, call)
            got = {}
            for g, gfn in zip(self._active_groups, self._group_fns):
                got.update(zip(g.outputs, call(
                    "group_dataflow", tuple(g.outputs), gfn,
                    [bufs[b] for b in g.source_buffers]
                    + [resolved[vid] for vid in g.vocab_ids])))
            for po in plan.pack:
                if po.name in self._solo_fns:
                    dp = fused[po.name]
                    got[po.name] = call(
                        "output_dataflow", (po.name,), self._solo_fns[po.name],
                        [bufs[b] for b in dp.source_buffers]
                        + [resolved[vid] for vid in dp.vocab_ids])
                elif po.name in packers:
                    got[po.name] = call("packer", (po.name,), packers[po.name],
                                        [bufs[b] for b in po.buffers])
                elif po.name not in got:
                    got[po.name] = kref.pack_blocks(
                        [bufs[b] for b in po.buffers],
                        transfer.torch_dtype(po.dtype), po.pad_cols_to)
            return {po.name: got[po.name][:, 0] if po.squeeze
                    else got[po.name] for po in plan.pack}

        return apply_fn

    def _build_fit_chunk(self) -> Callable:
        """``fit_chunk(cols, trace=None) -> {vocab_id: (first_pos,
        counts)}``: one fit kernel per legally fused vocabulary; the rest
        run their staged stages, then the build kernel (counts are
        ``torch.bincount``, as the JAX package's are ``jnp.bincount``)."""
        plan = self.plan
        fused_fit = self._fused_fit_programs
        staged_ids: set = ({sid for vf in plan.vocab_fits
                            if vf.vocab_id not in fused_fit
                            for sid in plan.fit_slice(vf)} if fused_fit
                           else set(plan.fit_stage_ids))
        fns = self._stage_fns(staged_ids)
        self._fit_fns = {vid: self._build_fit_dataflow_fn(fp)
                         for vid, fp in fused_fit.items()}
        build = (kops.vocab_build_chunk if self.backend == "cuda"
                 else kref.vocab_build_chunk)
        fit_bufs = self._fit_bufs

        def fit_chunk(cols, trace=None):
            call = self._caller("fit", trace)
            bufs = self._assemble_sources(cols, fit_bufs)
            self._run_staged(bufs, staged_ids, fns, None, call)
            out = {}
            for vf in plan.vocab_fits:
                vid = vf.vocab_id
                if vid in fused_fit:
                    out[vid] = call(
                        "fit_dataflow", vid, self._fit_fns[vid],
                        [bufs[b] for b in fused_fit[vid].source_buffers])
                    continue
                vals = bufs[vf.in_buf].reshape(-1)
                out[vid] = (call("vocab_build_chunk", vid, build,
                                 [vals, vf.capacity]),
                            kref.vocab_counts_chunk(vals, vf.capacity))
            return out

        return fit_chunk

    def dataflow_launches(self, raw_batch: dict, phase: str = "apply") -> list:
        """The kernel calls a phase issues for ``raw_batch``, in order:
        ``(kernel name, what, runner, args)`` with the arguments on the
        device, so a caller can hold ``runner(*args)`` against
        ``runner.plain(*args)``.  The phase is run once to produce them (a
        staged call reads what the calls before it wrote); the calls are not
        counted in ``dataflow_calls``."""
        if self.backend != "cuda":
            raise ValueError("only the cuda backend launches dataflow kernels")
        trace: list = []
        if phase == "fit":
            self._fit_chunk_fn(self._device_columns(raw_batch, self._fit_bufs),
                               trace)
        elif phase == "apply":
            self._apply_fn(self._device_tables(self.state),
                           self._device_columns(raw_batch), trace)
        else:
            raise ValueError(f"unknown phase {phase!r}")
        return trace

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def fit(self, batch_iter) -> PipelineState:
        """Stream batches; learn vocabulary tables (the fit phase)."""
        if not self.plan.vocab_fits:
            self.state = dataclasses.replace(self.state,
                                             version=self.state.version + 1)
            return self.state
        tables, n_unique = self._fit_tables(batch_iter)
        self.state = PipelineState(tables=tables, n_unique=n_unique,
                                   version=self.state.version + 1)
        return self.state

    def fit_incremental(self, batch_iter) -> PipelineState:
        """Online vocabulary refresh over a window of NEW events.

        Unlike ``fit`` (which rebuilds the tables from scratch), this merges
        the window into the current state **rank-stably**: every value the
        pipeline already admitted keeps its rank — so embedding rows learned
        by a live trainer keep their meaning across the swap — and values
        first seen in the window are appended in first-occurrence order at
        ranks ``n_unique ..``.  The frequency filter (``min_count``) applies
        per window.  The window's tables come from the fit kernels (on the
        cuda backend); the merge is host numpy.  The swap is a single
        attribute store of a fresh ``PipelineState`` with a version bump, so
        concurrent apply calls (which snapshot the state once per batch) are
        each served by exactly one version, and the device tables follow the
        version (``_device_tables``)."""
        cur = self.state
        if not self.plan.vocab_fits:
            self.state = dataclasses.replace(cur, version=cur.version + 1)
            return self.state
        win_tables, _ = self._fit_tables(batch_iter)
        tables, n_unique = {}, {}
        for vid, wt in win_tables.items():
            base = np.asarray(cur.tables[vid])
            n = int(cur.n_unique[vid])
            wt = np.asarray(wt)
            new_vals = np.flatnonzero((wt >= 0) & (base < 0))
            order = np.argsort(wt[new_vals], kind="stable")
            merged = base.copy()
            merged[new_vals[order]] = n + np.arange(len(new_vals),
                                                    dtype=np.int32)
            tables[vid] = merged
            n_unique[vid] = n + int(len(new_vals))
        self.state = PipelineState(tables=tables, n_unique=n_unique,
                                   version=cur.version + 1)
        return self.state

    def _fit_tables(self, batch_iter) -> tuple:
        """Run the chunked fit over ``batch_iter`` and return ``(tables,
        n_unique)`` without touching ``self.state``."""
        if self.backend == "numpy":
            gens = {vf.vocab_id: ops_lib.VocabGen(vf.capacity,
                                                  min_count=vf.min_count)
                    for vf in self.plan.vocab_fits}
            states = {vid: g.init_state() for vid, g in gens.items()}
            offset = 0
            for raw in batch_iter:
                bufs = self._gather_sources(raw, self._fit_bufs)
                bufs = self._run_stages_numpy(bufs,
                                              set(self.plan.fit_stage_ids))
                n_elems = 0
                for vf in self.plan.vocab_fits:
                    vals = bufs[vf.in_buf].reshape(-1)
                    n_elems = max(n_elems, vals.size)
                    states[vf.vocab_id] = gens[vf.vocab_id].update(
                        states[vf.vocab_id], vals, offset)
                offset += n_elems
            tables = {vid: gens[vid].finalize(st) for vid, st in states.items()}
        else:
            states = {vf.vocab_id: kref.vocab_state_init(vf.capacity,
                                                         self.device)
                      for vf in self.plan.vocab_fits}
            for ci, raw in enumerate(batch_iter):
                cols = self._device_columns(raw, self._fit_bufs)
                for vid, (fp, cnt) in self._fit_chunk_fn(cols).items():
                    states[vid] = kref.vocab_merge(states[vid], fp, ci,
                                                   chunk_counts=cnt)
            tables = {vf.vocab_id: kref.vocab_finalize(
                          states[vf.vocab_id], min_count=vf.min_count
                          ).cpu().numpy()
                      for vf in self.plan.vocab_fits}
        n_unique = {vid: ops_lib.VocabGen.n_unique(t)
                    for vid, t in tables.items()}
        return tables, n_unique

    def _device_tables(self, state: PipelineState) -> tuple:
        """``(resolved, raw)`` on this device, uploaded once per state
        version: the OOV-resolved int32[capacity] table of every vocabulary
        a dataflow kernel gathers from, and the raw table + n_unique of
        every vocabulary a staged lookup reads.  A plan that looks one
        vocabulary up both ways ships both forms.  Keyed on the version of
        the ``state`` handed in (the caller's one snapshot), never on
        ``self.state``; only the newest version's tables are held, so an
        older version's are released when the next is uploaded."""
        ver, cached = self._table_cache
        if ver == state.version:
            return cached
        fused_vids = {vid for dp in self._fused_programs.values()
                      for vid in dp.vocab_ids}
        resolved, raw = {}, {}
        for vid in sorted(fused_vids):
            t = np.asarray(state.tables[vid], np.int32)
            n = int(state.n_unique[vid])
            resolved[vid] = torch.as_tensor(
                np.where(t >= 0, t, n).astype(np.int32), device=self.device)
        for vid in self._staged_vocab_ids:
            raw[vid] = (torch.as_tensor(np.asarray(state.tables[vid],
                                                   np.int32),
                                        device=self.device),
                        int(state.n_unique[vid]))
        self._table_cache = (state.version, (resolved, raw))
        return resolved, raw

    def apply_versioned(self, raw_batch: dict) -> tuple:
        """Apply one batch against a single state snapshot and return
        ``(packed, version)``: the snapshot is read exactly once, so a
        concurrent ``fit_incremental`` swap never serves one batch a mix of
        two versions, and the caller learns which version it was."""
        state = self.state
        if self.backend == "numpy":
            bufs = self._run_stages_numpy(self._gather_sources(raw_batch),
                                          state=state)
            out = {}
            for po in self.plan.pack:
                blocks = [bufs[b] for b in po.buffers]
                rows = blocks[0].shape[0]
                cat = np.concatenate(
                    [np.asarray(b, dtype=po.dtype).reshape(rows, -1)
                     for b in blocks], axis=1)
                padded = -(-cat.shape[1] // po.pad_cols_to) * po.pad_cols_to
                if padded != cat.shape[1]:
                    cat = np.pad(cat, ((0, 0), (0, padded - cat.shape[1])))
                out[po.name] = cat[:, 0] if po.squeeze else cat
            return out, state.version
        cols = self._device_columns(raw_batch)
        return self._apply_fn(self._device_tables(state), cols), state.version

    def __call__(self, raw_batch: dict) -> dict:
        """Apply phase: raw columnar batch -> packed training-ready tensors."""
        return self.apply_versioned(raw_batch)[0]

    def referenced_columns(self) -> list:
        """Raw columns the apply program reads (projection-pushdown set)."""
        return self.plan.referenced_columns()

    def resource_summary(self) -> dict:
        return self.plan.resource_summary()

    def optimize_report(self) -> dict:
        return self.plan.optimize_report()

    def lowering_report(self) -> dict:
        """Per-output lowering decision: grouped / fused / staged (same keys
        as the JAX package's report)."""
        dfmap = {dp.output: dp for dp in self.plan.dataflows}
        groups = {name: self._active_groups[gi]
                  for name, gi in self._grouped_outputs.items()}
        rep = {}
        for po in self.plan.pack:
            dp = dfmap.get(po.name)
            if po.name in groups:
                path = "grouped"
            elif po.name in self._fused_programs:
                path = "fused"
            else:
                path = "staged"
            rep[po.name] = {
                "path": path,
                "group": list(groups[po.name].outputs)
                         if po.name in groups else [],
                "legal": dp.legal if dp else False,
                "reason": dp.reason if dp else "no dataflow program planned",
                "reason_kind": dp.reason_kind if dp else "",
                "n_stages": dp.n_stages if dp else 0,
                "vocab_ids": list(dp.vocab_ids) if dp else [],
            }
        return rep

    def fit_lowering_report(self) -> dict:
        """Per-vocab fit lowering decision: fused single-kernel vs staged."""
        fpmap = {fp.vocab_id: fp for fp in self.plan.fit_dataflows}
        rep = {}
        for vf in self.plan.vocab_fits:
            fp = fpmap.get(vf.vocab_id)
            rep[vf.vocab_id] = {
                "path": ("fused" if vf.vocab_id in self._fused_fit_programs
                         else "staged"),
                "legal": fp.legal if fp else False,
                "reason": fp.reason if fp else "no fit program planned",
                "reason_kind": fp.reason_kind if fp else "",
                "n_stages": fp.n_stages if fp else 0,
                "placement": vf.placement,
            }
        return rep

    def stage_execution_counts(self, phase: str = "apply") -> dict:
        """Static per-batch execution count of every plan stage, from the
        lowering decisions: a staged stage runs once per batch whatever its
        consumers; a stage in k solo fused kernels runs k times; a stage in
        a DataflowGroup runs once for the whole group."""
        if phase not in ("apply", "fit"):
            raise ValueError(f"unknown phase {phase!r}")
        plan = self.plan
        if phase == "fit":
            counts = {sid: 0 for sid in plan.fit_stage_ids}
            staged_ids = {sid for vf in plan.vocab_fits
                          if vf.vocab_id not in self._fused_fit_programs
                          for sid in plan.fit_slice(vf)}
            for sid in staged_ids:
                counts[sid] += 1
            for fp in self._fused_fit_programs.values():
                for sid in fp.stage_ids:
                    counts[sid] += 1
            return counts
        counts = {s.stage_id: 0 for s in plan.stages}
        staged_ids = {sid for po in plan.pack
                      if po.name not in self._fused_programs
                      for sid in plan.output_slice(po)}
        for sid in staged_ids:
            counts[sid] += 1
        for g in self._active_groups:
            for sid in g.stage_ids:
                counts[sid] += 1
        for name, dp in self._fused_programs.items():
            if name not in self._grouped_outputs:
                for sid in dp.stage_ids:
                    counts[sid] += 1
        return counts
