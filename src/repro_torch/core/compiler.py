"""Compiler: lowers an ExecutionPlan to an executable pipeline (paper §3.1/§3.4).

Three backends share identical semantics (tests pin them against each other
and against the JAX package):

- ``numpy`` : the CPU-baseline oracle (the paper's pandas path); host only.
- ``torch`` : eager plain PyTorch ops, stage by stage (the analogue of the
  JAX package's ``jnp`` backend).
- ``cuda``  : the streaming-dataflow analogue of the paper's FPGA pipeline:
  every ``DataflowGroup`` lowers to ONE launch of the hand-written group
  kernel, every legal ungrouped output to one launch of the output kernel,
  and every legal vocabulary fit chunk to one launch of the fit kernel
  (``kernels/dataflow.py``).  On ``device="cpu"`` the same encoded programs
  run through the kernels' plain versions (the analogue of Pallas
  ``interpret=True``).

Plans are rewritten by ``core/optimizer.optimize_plan`` first
(``optimize="auto"``) for every backend, exactly as in the JAX package.

The staged kernels of the reference (``make_fused_stage``, ``make_packer``,
``vocab_lookup``, ``vocab_build_chunk``) are not ported yet: on ``cuda`` an
output or vocabulary that the plan sends down the staged path (``fuse=
"off"``, an HBM-placed table, an over-budget slice) raises
``NotImplementedError`` at compile time instead of quietly using plain ops.

Vocabulary *fit* is streamed: per chunk, first-occurrence positions and
counts; merged into an int32 (chunk, position, count) state; finalized into
rank tables.  Tables are host numpy arrays in ``PipelineState`` (a state
fitted by the JAX package loads as it is), versioned, and uploaded once per
version in their OOV-resolved form (``table'[v] = rank or n_unique``), so
the in-kernel lookup is a pure gather.
"""

from __future__ import annotations

import dataclasses
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
        if backend == "cuda":
            self._require_fused()
        self.state = PipelineState(
            tables={vf.vocab_id: np.full(vf.capacity, -1, np.int32)
                    for vf in plan.vocab_fits},
            n_unique={vf.vocab_id: 0 for vf in plan.vocab_fits},
            version=0)
        self._source_nodes = {n.id: n for n in graph.nodes
                              if n.kind == NodeType.SOURCE}
        self._table_cache: tuple = (-1, {})
        self._fit_bufs = plan.fit_source_buffers()
        # dataflow kernel calls per phase, either route (CUDA launch or
        # plain version): the counterpart of traced_pallas_call_count
        self.dataflow_calls = {"apply": 0, "fit": 0}
        if backend != "numpy":
            self._apply_fn = self._build_apply()
            self._fit_chunk_fn = self._build_fit_chunk()

    def _require_fused(self) -> None:
        """On cuda every output and vocabulary must lower to a ported
        dataflow kernel; the staged kernels are not ported yet."""
        rep = self.lowering_report()
        staged = {k: v for k, v in rep.items() if v["path"] == "staged"}
        if staged:
            why = "; ".join(f"{k}: {v['reason_kind'] or 'fuse off'}"
                            + (f" ({v['reason']})" if v["reason"] else "")
                            for k, v in staged.items())
            raise NotImplementedError(
                f"outputs {sorted(staged)} lower to the staged path ({why}); "
                "its kernels (make_fused_stage, vocab_lookup, make_packer) "
                "are not ported to CUDA yet")
        frep = self.fit_lowering_report()
        staged_v = {k: v for k, v in frep.items() if v["path"] == "staged"}
        if staged_v:
            why = "; ".join(f"{k}: {v['reason_kind'] or 'fuse off'}"
                            for k, v in staged_v.items())
            raise NotImplementedError(
                f"vocabularies {sorted(staged_v)} fit on the staged path "
                f"({why}); its kernels (make_fused_stage, vocab_build_chunk) "
                "are not ported to CUDA yet")

    # ------------------------------------------------------------------
    # knob recompilation
    # ------------------------------------------------------------------

    def fuse_spec(self):
        """The current fuse setting in ``with_knobs``-compatible form."""
        if self.fuse == "off":
            return "off"
        return frozenset(self._fuse_off) if self._fuse_off else "auto"

    def with_knobs(self, *, row_tile: Optional[int] = None, fuse=None):
        """Recompile at new knob settings, SHARING vocabulary state.

        ``row_tile`` re-judges legality at the new plan tile (the CUDA
        kernels pick their own shared-memory tile either way); ``fuse``
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

    def _run_stages_torch(self, bufs: dict, stage_ids, tables=None) -> dict:
        for s in self.plan.stages:
            if s.stage_id not in stage_ids:
                continue
            if isinstance(s, FusedStage):
                bufs[s.out_buf] = _chain_torch(s, bufs[s.in_buf])
            elif isinstance(s, CrossStage):
                bufs[s.out_buf] = s.op.torch_expr2(bufs[s.in_a], bufs[s.in_b])
            elif isinstance(s, OneHotStage):
                bufs[s.out_buf] = s.op.torch_expr(bufs[s.in_buf])
            elif isinstance(s, VocabLookupStage):
                if tables is None:
                    raise AssertionError("lookup cannot precede fit")
                tbl, n = tables[s.vocab_id]
                bufs[s.out_buf] = kref.vocab_lookup(bufs[s.in_buf], tbl, n)
            else:
                raise NotImplementedError(type(s))
        return bufs

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
                                   tables, steps, outs)

    def _build_dataflow_fn(self, po: PackOutput, dp: DataflowProgram):
        """One legal ungrouped output -> its single-output kernel."""
        steps, tables = self._tile_steps(dp.stage_ids, dp.vocab_ids)
        terminals = [(b, self.plan.buffers[b].width) for b in po.buffers]
        return kops.output_dataflow(self._stream_inputs(dp.source_buffers),
                                    tables, steps, terminals, po.dtype,
                                    pad_cols_to=po.pad_cols_to)

    def _build_fit_dataflow_fn(self, fp: FitProgram):
        """One legal FitProgram -> its single fit kernel."""
        steps, _ = self._tile_steps(fp.stage_ids)
        return kops.fit_dataflow(self._stream_inputs(fp.source_buffers),
                                 steps, fp.in_buf, fp.capacity)

    def _build_apply(self) -> Callable:
        plan = self.plan
        if self.backend == "torch":
            all_ids = {s.stage_id for s in plan.stages}

            def apply_torch(tables, cols):
                bufs = self._run_stages_torch(self._assemble_sources(cols),
                                              all_ids, tables)
                out = {}
                for po in plan.pack:
                    packed = kref.pack_blocks([bufs[b] for b in po.buffers],
                                              transfer.torch_dtype(po.dtype),
                                              po.pad_cols_to)
                    out[po.name] = packed[:, 0] if po.squeeze else packed
                return out

            return apply_torch

        self._group_fns = [self._build_group_fn(g)
                           for g in self._active_groups]
        self._solo_fns = {name: self._build_dataflow_fn(
                              next(po for po in plan.pack if po.name == name),
                              dp)
                          for name, dp in self._fused_programs.items()
                          if name not in self._grouped_outputs}

        def apply_cuda(resolved, cols):
            got = {}
            for kname, names, fn, args in self._apply_launches(
                    self._assemble_sources(cols), resolved):
                packed = fn(*args)
                got.update(zip(names, packed if kname == "group_dataflow"
                               else (packed,)))
                self.dataflow_calls["apply"] += 1
            return {po.name: got[po.name][:, 0] if po.squeeze
                    else got[po.name] for po in plan.pack}

        return apply_cuda

    def _apply_launches(self, bufs: dict, resolved: dict) -> list:
        """``(kernel, output names, runner, args)`` for every dataflow
        kernel one apply issues: one per group, one per solo fused output."""
        calls = []
        for g, gfn in zip(self._active_groups, self._group_fns):
            calls.append(("group_dataflow", tuple(g.outputs), gfn,
                          [bufs[b] for b in g.source_buffers]
                          + [resolved[vid] for vid in g.vocab_ids]))
        dfmap = {dp.output: dp for dp in self.plan.dataflows}
        for name, fn in self._solo_fns.items():
            dp = dfmap[name]
            calls.append(("output_dataflow", (name,), fn,
                          [bufs[b] for b in dp.source_buffers]
                          + [resolved[vid] for vid in dp.vocab_ids]))
        return calls

    def _fit_launches(self, bufs: dict) -> list:
        """``(kernel, vocab id, runner, args)`` for every fit kernel one
        chunk issues: one per vocabulary."""
        return [("fit_dataflow", vid, self._fit_fns[vid],
                 [bufs[b] for b in fp.source_buffers])
                for vid, fp in self._fused_fit_programs.items()]

    def dataflow_launches(self, raw_batch: dict, phase: str = "apply") -> list:
        """The kernel calls a phase issues for ``raw_batch``, unrun:
        ``(kernel name, outputs or vocab id, runner, args)`` with the
        arguments already on the device.  ``runner.program`` is the encoded
        program, so a caller can hold ``runner(*args)`` against the plain
        version (``kernels.dataflow.*_plain``) on the same inputs."""
        if self.backend != "cuda":
            raise ValueError("only the cuda backend launches dataflow kernels")
        if phase == "fit":
            cols = self._device_columns(raw_batch, self._fit_bufs)
            return self._fit_launches(self._assemble_sources(cols,
                                                             self._fit_bufs))
        if phase != "apply":
            raise ValueError(f"unknown phase {phase!r}")
        return self._apply_launches(
            self._assemble_sources(self._device_columns(raw_batch)),
            self._device_tables(self.state))

    def _build_fit_chunk(self) -> Callable:
        """One streamed fit chunk -> {vocab_id: (first_pos, counts)}."""
        plan = self.plan
        fit_bufs = self._fit_bufs
        if self.backend == "torch":
            fit_ids = set(plan.fit_stage_ids)

            def fit_torch(cols):
                bufs = self._run_stages_torch(
                    self._assemble_sources(cols, fit_bufs), fit_ids)
                out = {}
                for vf in plan.vocab_fits:
                    vals = bufs[vf.in_buf].reshape(-1)
                    out[vf.vocab_id] = (
                        kref.vocab_build_chunk(vals, vf.capacity),
                        kref.vocab_counts_chunk(vals, vf.capacity))
                return out

            return fit_torch

        self._fit_fns = {vid: self._build_fit_dataflow_fn(fp)
                         for vid, fp in self._fused_fit_programs.items()}

        def fit_cuda(cols):
            out = {}
            for _, vid, fn, args in self._fit_launches(
                    self._assemble_sources(cols, fit_bufs)):
                out[vid] = fn(*args)
                self.dataflow_calls["fit"] += 1
            return out

        return fit_cuda

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

    def _fit_tables(self, batch_iter) -> tuple:
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

    def _device_tables(self, state: PipelineState) -> dict:
        """Tables on this device, uploaded once per state version: the
        OOV-resolved int32[capacity] form for the kernels (cuda), the raw
        table + n_unique for the eager lookups (torch)."""
        ver, cached = self._table_cache
        if ver == state.version:
            return cached
        out = {}
        for vid, t in state.tables.items():
            t = np.asarray(t, np.int32)
            n = int(state.n_unique[vid])
            if self.backend == "cuda":
                out[vid] = torch.as_tensor(
                    np.where(t >= 0, t, n).astype(np.int32), device=self.device)
            else:
                out[vid] = (torch.as_tensor(t, device=self.device), n)
        self._table_cache = (state.version, out)
        return out

    def apply_versioned(self, raw_batch: dict) -> tuple:
        """Apply one batch against a single state snapshot and return
        ``(packed, version)``."""
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
