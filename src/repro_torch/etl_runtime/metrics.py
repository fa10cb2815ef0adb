"""Prometheus-style text exposition of runtime stats (ops satellite).

The staged executor already accounts every stage's items / busy / wait-in /
wait-out (``StageStats``, the paper's Fig-8 breakdown).  This module renders
those counters — plus any ad-hoc scalar map — in the Prometheus text format
so launchers can expose them via ``--metrics-file`` (scrape the file with
node_exporter's textfile collector) without taking a client-library
dependency.

Only ``counter``/``gauge``/``histogram`` text lines are emitted; values are
cumulative since executor start, which is exactly Prometheus counter
semantics.  For equal stats the text is identical to the JAX package's.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

from repro_torch.etl_runtime.runtime import RuntimeStats


def _escape(value: str) -> str:
    """Escape a label value per the Prometheus exposition format."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: Optional[Mapping[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def counters_to_prometheus(values: Mapping[str, float], *,
                           prefix: str = "repro",
                           labels: Optional[Mapping[str, str]] = None) -> str:
    """Render a flat name -> value map as Prometheus counter lines."""
    lines = []
    for name in sorted(values):
        metric = f"{prefix}_{name}"
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric}{_fmt_labels(labels)} {values[name]:.9g}")
    return "\n".join(lines) + "\n"


def stats_to_prometheus(stats: RuntimeStats, *, prefix: str = "repro_etl",
                        labels: Optional[Mapping[str, str]] = None) -> str:
    """Render RuntimeStats (incl. per-stage StageStats) as Prometheus text.

    Per-stage series carry a ``stage`` label; top-level counters mirror the
    produced/consumed/drop accounting.
    """
    base = dict(labels or {})
    lines = []

    top = {"produced_total": stats.produced,
           "consumed_total": stats.consumed,
           "dropped_stale_total": stats.dropped_stale,
           "skipped_straggler_total": stats.skipped_straggler,
           "consumer_wait_seconds_total": stats.consumer_wait_s,
           "credit_grows_total": stats.credit_grows,
           "credit_shrinks_total": stats.credit_shrinks,
           "raw_queue_resizes_total": stats.raw_resizes}
    for name in sorted(top):
        metric = f"{prefix}_{name}"
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric}{_fmt_labels(base)} {top[name]:.9g}")

    stage_series = {"stage_items_total": lambda s: s.items,
                    "stage_busy_seconds_total": lambda s: s.busy_s,
                    "stage_wait_in_seconds_total": lambda s: s.wait_in_s,
                    "stage_wait_out_seconds_total": lambda s: s.wait_out_s,
                    "stage_drop_oldest_total": lambda s: s.drop_oldest}
    for name in sorted(stage_series):
        metric = f"{prefix}_{name}"
        lines.append(f"# TYPE {metric} counter")
        get = stage_series[name]
        for stage_name in stats.stages:
            lbl = _fmt_labels({**base, "stage": stage_name})
            lines.append(f"{metric}{lbl} {get(stats.stages[stage_name]):.9g}")

    # delivered-batch staleness (seconds since Source.arrival) as a real
    # Prometheus histogram, plus the ingest rate gauge — the online-training
    # freshness signals
    hist = getattr(stats, "staleness", None)
    if hist is not None:
        metric = f"{prefix}_delivered_staleness_seconds"
        lines.append(f"# TYPE {metric} histogram")
        cum = hist.cumulative()
        for le, c in zip(hist.buckets, cum):
            lbl = _fmt_labels({**base, "le": f"{le:g}"})
            lines.append(f"{metric}_bucket{lbl} {c}")
        lines.append(f'{metric}_bucket{_fmt_labels({**base, "le": "+Inf"})} '
                     f"{cum[-1]}")
        lines.append(f"{metric}_sum{_fmt_labels(base)} {hist.sum:.9g}")
        lines.append(f"{metric}_count{_fmt_labels(base)} {hist.count}")
    if hasattr(stats, "ingest_rate"):
        metric = f"{prefix}_ingest_events_per_second"
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric}{_fmt_labels(base)} {stats.ingest_rate():.9g}")

    # lookahead embedding-cache accounting, present when the executor ran
    # with a lookahead config (etl_runtime.lookahead.CacheStats)
    cache = getattr(stats, "cache", None)
    if cache is not None:
        cache_counters = {
            "embed_cache_lookups_total": cache.lookups,
            "embed_cache_hits_total": cache.hits,
            "embed_cache_misses_total": cache.misses,
            "embed_cache_admitted_rows_total": cache.admitted,
            "embed_cache_evicted_rows_total": cache.evicted,
            "embed_cache_staged_rows_total": cache.staged,
            "embed_cache_overflow_cold_total": cache.overflow_cold,
            "embed_cache_gather_bytes_saved_total":
                cache.gather_bytes_saved()}
        for name in sorted(cache_counters):
            metric = f"{prefix}_{name}"
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric}{_fmt_labels(base)} "
                         f"{cache_counters[name]:.9g}")
        metric = f"{prefix}_embed_cache_hit_rate"
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric}{_fmt_labels(base)} {cache.hit_rate():.9g}")

    # self-tuning controller: live knob values + decision counts (present
    # when the executor ran with autotune / adaptive credits)
    knobs = getattr(stats, "knobs", None)
    if knobs:
        num_knobs = {k: v for k, v in knobs.items()
                     if isinstance(v, (bool, int, float))}
        if num_knobs:
            metric = f"{prefix}_controller_knob"
            lines.append(f"# TYPE {metric} gauge")
            for k in sorted(num_knobs):
                lbl = _fmt_labels({**base, "knob": k})
                lines.append(f"{metric}{lbl} {float(num_knobs[k]):.9g}")
        str_knobs = {k: v for k, v in knobs.items() if k not in num_knobs}
        if str_knobs:
            metric = f"{prefix}_controller_knob_info"
            lines.append(f"# TYPE {metric} gauge")
            for k in sorted(str_knobs):
                lbl = _fmt_labels({**base, "knob": k,
                                   "value": str(str_knobs[k])})
                lines.append(f"{metric}{lbl} 1")
    controller = getattr(stats, "controller", None)
    if controller is not None:
        metric = f"{prefix}_controller_decisions_total"
        lines.append(f"# TYPE {metric} counter")
        for action, n in sorted(controller.decision_counts().items()):
            lbl = _fmt_labels({**base, "action": action})
            lines.append(f"{metric}{lbl} {n}")
        metric = f"{prefix}_controller_queued_bytes_estimate"
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric}{_fmt_labels(base)} "
                     f"{controller.total_queued_bytes():.9g}")
    return "\n".join(lines) + "\n"


def write_metrics_file(path: str, text: str) -> None:
    """Atomically-enough write for textfile-collector scraping."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
