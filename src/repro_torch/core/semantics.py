"""Training-aware ETL semantics: freshness, ordering, batching (paper §1, §3).

These policies are part of the pipeline contract and are enforced by the
streaming runtime (etl_runtime/runtime.py):

- BatchingPolicy : emitted batch geometry (the packer pads/aligns to it).
- FreshnessPolicy: bound on batch staleness; with continuous training the
  runtime drops batches older than ``max_staleness_batches`` behind the
  trainer instead of feeding stale data (time-to-freshness over completeness).
- OrderingPolicy : fifo (point-in-time order preserved, the default —
  required for online recommenders) or bucket_by_length (LM efficiency mode;
  trades strict arrival order inside a bounded reorder window).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BatchingPolicy:
    batch_size: int
    drop_remainder: bool = True
    # pack/pad row count to a multiple (TPU sublane alignment)
    align_rows_to: int = 8

    def __post_init__(self):
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")


@dataclasses.dataclass(frozen=True)
class FreshnessPolicy:
    # maximum number of batches a packed batch may wait before the trainer
    # consumes it; 0 disables the bound (offline mode)
    max_staleness_batches: int = 0

    @property
    def online(self) -> bool:
        return self.max_staleness_batches > 0


@dataclasses.dataclass(frozen=True)
class OrderingPolicy:
    kind: str = "fifo"  # "fifo" | "bucket_by_length"
    reorder_window: int = 0  # batches; only for bucket_by_length

    def __post_init__(self):
        if self.kind not in ("fifo", "bucket_by_length"):
            raise ValueError(f"unknown ordering {self.kind!r}")
        if self.kind == "fifo" and self.reorder_window:
            raise ValueError("fifo ordering cannot have a reorder window")
        if self.kind == "bucket_by_length" and self.reorder_window < 2:
            raise ValueError("bucket_by_length needs reorder_window >= 2 "
                             "(a smaller window cannot reorder anything)")


@dataclasses.dataclass(frozen=True)
class PipelineSemantics:
    batching: BatchingPolicy
    freshness: FreshnessPolicy = FreshnessPolicy()
    ordering: OrderingPolicy = OrderingPolicy()
