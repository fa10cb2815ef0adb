"""Relational optimizer over the ExecutionPlan (plan → optimize → lower).

The planner owns *what* each output computes (backward slices, legality);
this pass owns *how much of it is shared*.  It rewrites the plan between
planning and lowering with three relational rewrites, in order:

1. **Common-subexpression sharing (CSE).**  Stage subgraphs that are
   structurally identical — same kind, same (canonicalized) inputs, same
   operator parameters — are planned once.  Duplicate ``FusedStage`` chains
   (decode, bounding), ``CrossStage``/``OneHotStage`` nodes, and whole
   ``VocabFit``/``VocabLookupStage`` pairs (same value stream, capacity,
   min_count and placement ⇒ bit-identical fitted tables) collapse onto
   their first occurrence; every downstream reference is renamed onto the
   surviving buffer.  The rewrite cascades: once two prefixes merge, their
   structurally-equal consumers merge too.

2. **Generalized pushdown (dead-code elimination).**  Projection pushdown
   already narrows the *columns* a Source reads
   (``ExecutionPlan.referenced_columns``); this pass generalizes the same
   backward-reachability argument to *stages*: anything not in the
   transitive closure of the pack terminals and vocab-fit inputs — e.g.
   producers orphaned by CSE, or stages injected by plan surgery — is
   dropped before the legality checks ever see it, along with the source
   buffers/columns only dead stages read.  The fit closure
   (``fit_stage_ids``) is recomputed on the pruned stage list.

3. **Multi-output fused dataflows (grouping).**  Legal per-output
   ``DataflowProgram``s are greedily merged (pack order) into
   ``DataflowGroup``s while the *merged* slice still passes the same VMEM
   feasibility argument the planner applies per output: one row tile per
   touched buffer, each distinct table staged once, one packed tile per
   member output, double-buffered, within ``plan.dataflow_vmem_budget``.
   A group lowers to ONE row-tiled kernel launch emitting every member's
   packed tensor per tile (``kernels/dataflow.make_group_dataflow``), so
   stages shared across outputs execute exactly once per tile.  The
   fallback ladder is monotone: grouped → per-output fused → staged.

``optimize_plan`` never mutates its input; the rewritten plan carries an
``opt_info`` dict surfaced by ``ExecutionPlan.optimize_report()`` (and from
there by ``CompiledPipeline``/``EtlJob``) with CSE/pushdown counts and the
per-output grouping decision.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.planner import (CrossStage, DataflowGroup,
                                      ExecutionPlan, FusedStage, OneHotStage,
                                      Planner, VocabLookupStage,
                                      build_plan_programs, packed_output_bytes,
                                      stream_tile_bytes)

_INPUT_ATTRS = ("in_buf", "in_a", "in_b")


def _stage_inputs(stage) -> tuple:
    return tuple(b for b in (getattr(stage, a, None) for a in _INPUT_ATTRS)
                 if b)


def _op_signature(stage) -> tuple:
    """Parameter part of a stage's structural signature (operators are
    declarative dataclasses, so ``repr`` is a stable parameter fingerprint)."""
    if isinstance(stage, FusedStage):
        return ("fused", tuple(repr(op) for op in stage.ops),
                str(stage.in_dtype), str(stage.out_dtype), stage.in_hex_width)
    if isinstance(stage, CrossStage):
        return ("cross", repr(stage.op))
    if isinstance(stage, OneHotStage):
        return ("onehot", repr(stage.op))
    # unknown kinds never merge; identity keeps them unique
    return ("opaque", stage.stage_id)


def _rewrite_stage(stage, rename: dict, vocab_rename: dict):
    """Copy of ``stage`` with inputs (and vocab id) canonicalized."""
    changes = {a: rename[getattr(stage, a)] for a in _INPUT_ATTRS
               if getattr(stage, a, None) in rename}
    if isinstance(stage, VocabLookupStage) and stage.vocab_id in vocab_rename:
        changes["vocab_id"] = vocab_rename[stage.vocab_id]
    return dataclasses.replace(stage, **changes) if changes else stage


def _merge_sources(plan: ExecutionPlan, rename: dict) -> int:
    """Seed the rename map with duplicate raw source buffers.

    Each ``p.dense("dense_*")``-style call mints a fresh source node, so
    structurally equal prefixes built in separate expressions start from
    *distinct* buffers reading the *same* columns.  Two sources with the
    same column list and buffer spec deliver byte-identical streams; fold
    them so downstream stage CSE can fire."""
    seen: dict = {}
    merged = 0
    for b in list(plan.source_buffers):
        spec = plan.buffers[b]
        key = (tuple(plan.source_columns[b]), spec.width, str(spec.dtype),
               spec.hex_width)
        canon = seen.setdefault(key, b)
        if canon != b:
            rename[b] = canon
            plan.source_buffers.remove(b)
            del plan.source_columns[b]
            del plan.buffers[b]
            merged += 1
    return merged


def _cse(plan: ExecutionPlan) -> tuple[int, int, int]:
    """Merge structurally identical sources / stages / vocab fits."""
    fit_by_vid = {vf.vocab_id: vf for vf in plan.vocab_fits}
    rename: dict = {}        # dropped out_buf -> surviving out_buf
    vocab_rename: dict = {}  # dropped vocab_id -> surviving vocab_id
    merged_sources = _merge_sources(plan, rename)
    seen: dict = {}          # stage signature -> surviving stage
    fit_seen: dict = {}      # fit signature -> surviving vocab_id
    new_stages: list = []
    merged_stages = 0
    for s in plan.stages:
        ins = tuple(rename.get(b, b) for b in _stage_inputs(s))
        if isinstance(s, VocabLookupStage):
            vf = fit_by_vid[s.vocab_id]
            fit_key = (ins[0], vf.capacity, vf.min_count, vf.placement)
            canon = fit_seen.setdefault(fit_key, s.vocab_id)
            if canon != s.vocab_id:
                vocab_rename[s.vocab_id] = canon
            sig = ("lookup", ins, canon, s.capacity, s.placement)
        else:
            sig = (type(s).__name__, ins, _op_signature(s))
        survivor = seen.get(sig)
        if survivor is not None:
            rename[s.out_buf] = survivor.out_buf
            merged_stages += 1
            continue
        s2 = _rewrite_stage(s, rename, vocab_rename)
        seen[sig] = s2
        new_stages.append(s2)
    plan.stages = new_stages
    plan.pack = [dataclasses.replace(po, buffers=[rename.get(b, b)
                                                  for b in po.buffers])
                 for po in plan.pack]
    plan.vocab_fits = [
        dataclasses.replace(vf, in_buf=rename.get(vf.in_buf, vf.in_buf))
        for vf in plan.vocab_fits if vf.vocab_id not in vocab_rename]
    return merged_sources, merged_stages, len(vocab_rename)


def _prune_dead(plan: ExecutionPlan) -> tuple[int, int]:
    """Drop stages/sources outside the closure of outputs + vocab fits."""
    needed = {b for po in plan.pack for b in po.buffers}
    needed |= {vf.in_buf for vf in plan.vocab_fits}
    kept: list = []
    for s in reversed(plan.stages):
        if s.out_buf in needed:
            kept.append(s)
            needed.update(_stage_inputs(s))
    dead_stages = len(plan.stages) - len(kept)
    plan.stages = list(reversed(kept))
    live_sources = [b for b in plan.source_buffers if b in needed]
    dead_sources = len(plan.source_buffers) - len(live_sources)
    plan.source_buffers = live_sources
    plan.source_columns = {b: cols for b, cols in plan.source_columns.items()
                           if b in needed}
    plan.buffers = {name: spec for name, spec in plan.buffers.items()
                    if name in needed}
    plan.fit_stage_ids = Planner._fit_closure(plan.stages, plan.vocab_fits)
    return dead_stages, dead_sources


def _merged_working_set(plan: ExecutionPlan, members) -> int:
    """The per-output VMEM argument, applied to a merged slice: one tile per
    touched buffer, each distinct table once, one packed tile per output."""
    stage_ids = {sid for _, dp in members for sid in dp.stage_ids}
    stages = [s for s in plan.stages if s.stage_id in stage_ids]
    sources: list = []
    for _, dp in members:
        sources.extend(b for b in dp.source_buffers if b not in sources)
    tile_bytes = stream_tile_bytes(plan, stages, sources)
    table_bytes = sum(4 * s.capacity for s in stages
                      if isinstance(s, VocabLookupStage))
    out_bytes = sum(packed_output_bytes(plan, po) for po, _ in members)
    return 2 * (tile_bytes + out_bytes) + table_bytes


def _make_group(plan: ExecutionPlan, members) -> DataflowGroup:
    stage_ids = {sid for _, dp in members for sid in dp.stage_ids}
    sources: list = []
    vocab_ids: list = []
    for _, dp in members:
        sources.extend(b for b in dp.source_buffers if b not in sources)
        vocab_ids.extend(v for v in dp.vocab_ids if v not in vocab_ids)
    return DataflowGroup(
        outputs=[po.name for po, _ in members],
        stage_ids=[s.stage_id for s in plan.stages
                   if s.stage_id in stage_ids],
        source_buffers=sources, vocab_ids=vocab_ids)


def _group_outputs(plan: ExecutionPlan) -> tuple[list, dict]:
    """Greedy pack-order binning of legal programs under the VMEM budget."""
    legal = {dp.output: dp for dp in plan.dataflows if dp.legal}
    groups: list = []
    grouping: dict = {}
    current: list = []  # [(PackOutput, DataflowProgram)]

    def flush():
        if len(current) >= 2:
            for po, _ in current:
                grouping[po.name] = f"grouped[{len(groups)}]"
            groups.append(_make_group(plan, current))
        elif current:
            grouping[current[0][0].name] = "per-output fused (no co-resident partner)"
        current.clear()

    for po in plan.pack:
        dp = legal.get(po.name)
        if dp is None:
            bad = next(d for d in plan.dataflows if d.output == po.name)
            grouping[po.name] = (f"staged ({bad.reason_kind or 'illegal'}: "
                                 f"{bad.reason})")
            continue
        if current and (_merged_working_set(plan, current + [(po, dp)])
                        > plan.dataflow_vmem_budget):
            flush()
        current.append((po, dp))
    flush()
    return groups, grouping


def optimize_plan(plan: ExecutionPlan) -> ExecutionPlan:
    """Rewrite ``plan`` (CSE → pushdown → regrouped fusion programs).

    Returns a new ``ExecutionPlan``; the input is left untouched.  The
    rewritten plan is observationally equivalent: every backend produces
    bit-identical packed outputs and (modulo deduplicated vocab ids)
    bit-identical pipeline state — ``tests/test_property.py`` pins this
    over randomly generated DAGs with shared prefixes.
    """
    plan = dataclasses.replace(
        plan,
        buffers=dict(plan.buffers),
        stages=list(plan.stages),
        fit_stage_ids=list(plan.fit_stage_ids),
        vocab_fits=list(plan.vocab_fits),
        pack=list(plan.pack),
        source_buffers=list(plan.source_buffers),
        source_columns={b: list(c) for b, c in plan.source_columns.items()},
        dataflows=[], fit_dataflows=[], groups=[], opt_info={})
    merged_sources, merged_stages, merged_vocabs = _cse(plan)
    dead_stages, dead_sources = _prune_dead(plan)
    # legality re-runs on the rewritten stage list (pushdown before legality)
    build_plan_programs(plan)
    groups, grouping = _group_outputs(plan)
    plan.groups = groups
    plan.opt_info = {
        "optimized": True,
        "cse": {"merged_sources": merged_sources,
                "merged_stages": merged_stages,
                "merged_vocabs": merged_vocabs},
        "pushdown": {"dead_stages": dead_stages,
                     "dead_sources": dead_sources},
        "groups": [list(g.outputs) for g in groups],
        "grouping": grouping,
    }
    return plan
