"""EtlJob: the single session facade over compile → fit → streaming batches.

The paper's training-aware ETL abstraction ends at the trainer, not at
``Pipeline.compile()``.  ``EtlJob`` owns the whole lifecycle::

    job = EtlJob(paper_pipeline("III", batch_size=65536),
                 Source.synth("I", rows=16 * 65536, batch_size=65536),
                 backend="cuda",
                 fit_source=Source.synth("I", rows=4 * 65536,
                                         batch_size=65536))
    job.fit()                      # learn vocab tables (projected fit read)
    with job.batches() as batches: # staged prefetching executor
        for packed in batches:
            state, m = train_step(state, packed)
    print(job.stats().stage_breakdown())

- **compile**: a ``Pipeline`` template is compiled on first use with the
  job's ``backend`` / ``device`` / ``fuse`` / ``optimize`` (an already
  compiled pipeline is accepted as is).  The device defaults to CUDA and a
  missing one raises (``kernels.backend.resolve_device``).
- **projection pushdown**: the source is projected to the plan's referenced
  columns; the fit read to the (smaller) vocab-fit closure.
- **overlapped fit ingest**: ``fit()`` reads through ``SourcePrefetcher``.
- **semantics overrides**: ``freshness=`` / ``ordering=``.
- **executor lifecycle**: ``batches()`` starts the staged executor and tears
  it down on exit; ``stats()`` exposes its ``RuntimeStats``;
  ``metrics_file`` exports them as Prometheus text on close.

Not ported yet (``NotImplementedError``): ``autotune=``, ``embed_cache=``,
``adaptive_credits=True``, ``mesh=`` / ``sharding=``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

from repro_torch.core.compiler import CompiledPipeline
from repro_torch.core.pipeline import Pipeline
from repro_torch.core.semantics import (FreshnessPolicy, OrderingPolicy,
                                        PipelineSemantics)
from repro_torch.data.source import Source, as_source
from repro_torch.etl_runtime import metrics as metrics_lib
from repro_torch.etl_runtime.runtime import (RuntimeStats, SourcePrefetcher,
                                             StreamingExecutor,
                                             default_length_key)
from repro_torch.kernels.backend import resolve_device


class EtlJob:
    """One ETL session: ``(Pipeline, Source, overrides) -> batches``.

    Parameters
    ----------
    pipeline : a ``Pipeline`` template (compiled lazily) or a compiled
        apply program.
    source : the apply-phase ``Source`` (anything batch-yielding is coerced
        via ``Source.stream``); may be ``None`` for fit-/apply-only jobs.
    backend : "numpy" | "torch" | "cuda" (see ``core/compiler.py``).
    device : where the torch/cuda backends run; default CUDA.
    fit_source : Source for ``fit()`` when it differs from ``source``.
    freshness, ordering : per-job overrides of the pipeline's semantics.
    credits, read_timeout_s, place, length_key, clock : forwarded to the
        executor (see ``StreamingExecutor``).
    rebatch : rebatch the source to the batching policy's ``batch_size``.
    pushdown : when False, skip the automatic column projection.
    metrics_file, metrics_labels : Prometheus-text export on close.
    """

    def __init__(self, pipeline, source=None, *,
                 backend: str = "torch", device=None, fuse="auto",
                 optimize: str = "auto", fit_source=None,
                 freshness: Optional[FreshnessPolicy] = None,
                 ordering: Optional[OrderingPolicy] = None,
                 credits: int = 2, adaptive_credits: bool = False,
                 autotune=None, clock=None, read_timeout_s: float = 30.0,
                 mesh=None, sharding=None, place=None,
                 length_key: Callable = default_length_key,
                 embed_cache=None, rebatch: bool = False,
                 pushdown: bool = True, metrics_file: str = "",
                 metrics_labels: Optional[dict] = None,
                 name: Optional[str] = None):
        if autotune or adaptive_credits:
            raise NotImplementedError("the knob controller (autotune / "
                                      "adaptive_credits) is not ported yet")
        if embed_cache is not None:
            raise NotImplementedError("the lookahead embedding cache is not "
                                      "ported yet")
        self._template: Optional[Pipeline] = None
        self._compiled: Optional[CompiledPipeline] = None
        if isinstance(pipeline, Pipeline):
            self._template = pipeline
        elif callable(pipeline):
            self._compiled = pipeline
        else:
            raise TypeError("pipeline must be a Pipeline or a compiled "
                            f"apply program, got {type(pipeline).__name__}")
        self._backend = backend
        self._device = (None if backend == "numpy"
                        or self._compiled is not None
                        else resolve_device(device))
        self._fuse = fuse
        self._optimize = optimize
        self._source = as_source(source) if source is not None else None
        self._fit_source = (as_source(fit_source)
                            if fit_source is not None else None)
        self._freshness = freshness
        self._ordering = ordering
        self._executor_kw = dict(
            credits=credits, read_timeout_s=read_timeout_s, mesh=mesh,
            sharding=sharding, place=place, length_key=length_key,
            clock=clock)
        self._rebatch = rebatch
        self._pushdown = pushdown
        self.metrics_file = metrics_file
        self.metrics_labels = dict(metrics_labels or {})
        self.name = name or getattr(pipeline, "name", "etl-job")
        self._executor: Optional[StreamingExecutor] = None
        self._last_stats: Optional[RuntimeStats] = None
        self._fit_read_stats = None

    # ---- compile ---------------------------------------------------------

    @property
    def compiled(self) -> CompiledPipeline:
        """The compiled apply/fit program (compiled on first use)."""
        if self._compiled is None:
            self._compiled = self._template.compile(
                backend=self._backend, device=self._device, fuse=self._fuse,
                optimize=self._optimize)
        return self._compiled

    @property
    def semantics(self) -> Optional[PipelineSemantics]:
        """Pipeline semantics with this job's overrides applied."""
        base = getattr(self.compiled, "semantics", None)
        if base is None and self._template is not None:
            base = self._template.semantics
        if base is None:
            return None
        changes = {}
        if self._freshness is not None:
            changes["freshness"] = self._freshness
        if self._ordering is not None:
            changes["ordering"] = self._ordering
        return dataclasses.replace(base, **changes) if changes else base

    # ---- sources (projection pushdown) -----------------------------------

    def _project(self, src: Source, columns) -> Source:
        """Push a column set into a Source unless the user already projected
        or supplied a host ``length_key`` (it may read other columns)."""
        if (not self._pushdown or src.spec.columns is not None
                or src.spec.length_key is not None):
            return src
        return src.columns(columns)

    def apply_source(self) -> Source:
        """The effective apply-phase Source: user spec + pushed projection
        (+ rebatch to the batching policy when requested)."""
        if self._source is None:
            raise ValueError("EtlJob has no source; pass one at construction")
        plan = getattr(self.compiled, "plan", None)
        src = self._source
        if plan is not None:
            src = self._project(src, plan.referenced_columns())
        sem = self.semantics
        if self._rebatch and sem is not None and src.spec.rebatch_rows is None:
            src = src.rebatch(sem.batching.batch_size,
                              drop_remainder=sem.batching.drop_remainder)
        return src

    # ---- fit -------------------------------------------------------------

    def fit(self, source=None, *, prefetch: bool = True):
        """Fit phase: learn vocabulary tables from ``source`` (default: the
        job's ``fit_source``, else its apply source), reading only the
        vocab-fit closure's columns, through a background read stage."""
        src = source if source is not None else (self._fit_source
                                                 or self._source)
        plan = getattr(self.compiled, "plan", None)
        if src is None:
            if plan is None or not plan.vocab_fits:
                return self.compiled.fit(iter(()))  # stateless: bump version
            raise ValueError("fit requires a source (pipeline has vocabs)")
        if plan is not None and not plan.vocab_fits:
            return self.compiled.fit(iter(()))
        src = as_source(src)
        if plan is not None:
            src = self._project(src, plan.fit_referenced_columns())
        if not prefetch:
            return self.compiled.fit(iter(src))
        reader = SourcePrefetcher(src, credits=self._executor_kw["credits"],
                                  name=f"{self.name}-fit-read")
        try:
            state = self.compiled.fit(iter(reader))
        finally:
            reader.close()
            self._fit_read_stats = reader.stats
        return state

    def apply(self, raw_batch: dict) -> dict:
        """Apply the compiled program to one raw batch (no executor)."""
        return self.compiled(raw_batch)

    # ---- executor lifecycle ----------------------------------------------

    def executor(self, transform=None) -> StreamingExecutor:
        """Build (without starting) the staged executor for this job."""
        return StreamingExecutor(transform or self.compiled,
                                 self.apply_source(),
                                 semantics=self.semantics,
                                 **self._executor_kw)

    def start(self) -> StreamingExecutor:
        if self._executor is None:
            self._executor = self.executor()
            self._executor.start()
        return self._executor

    @contextlib.contextmanager
    def batches(self):
        """Start the staged executor, yield it (iterate for packed batches),
        and stop it (writing the metrics file if configured) on exit."""
        ex = self.start()
        try:
            yield ex
        finally:
            self.close()

    def close(self) -> None:
        """Stop the executor (if running) and export metrics when asked."""
        if self._executor is not None:
            self._executor.stop()
            self._executor.join(timeout=10.0)
            self._last_stats = self._executor.stats
            self._executor = None
        if self.metrics_file and self._last_stats is not None:
            self.write_metrics(self.metrics_file)

    stop = close

    def __enter__(self) -> StreamingExecutor:
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- observability ---------------------------------------------------

    def stats(self) -> Optional[RuntimeStats]:
        """RuntimeStats of the live executor, else the last finished run."""
        if self._executor is not None:
            return self._executor.stats
        return self._last_stats

    def write_metrics(self, path: str, *, labels: Optional[dict] = None) -> None:
        stats = self.stats()
        if stats is None:
            return
        all_labels = {**self.metrics_labels, **(labels or {})}
        metrics_lib.write_metrics_file(
            path, metrics_lib.stats_to_prometheus(stats, labels=all_labels))

    @property
    def state(self):
        """Vocabulary PipelineState of the compiled pipeline."""
        return self.compiled.state

    def lowering_report(self) -> dict:
        return self.compiled.lowering_report()

    def fit_lowering_report(self) -> dict:
        return self.compiled.fit_lowering_report()

    def optimize_report(self) -> dict:
        return self.compiled.optimize_report()

    @property
    def fit_read_stats(self):
        """StageStats of the last ``fit()`` read stage."""
        return self._fit_read_stats
