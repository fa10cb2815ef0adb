"""Freshness-aware global shedding: drop the oldest in-flight event.

The executor's per-queue ``put(drop_oldest=True)`` (``FreshnessPolicy.
online``) sheds only at one queue, only under local backpressure.  A
long-running online trainer needs the *global* policy the paper implies:
when ingest outruns training, the event that should die is the stalest one
**anywhere** in the pipeline — raw, packed, sorted, placed or ready — not
whichever happens to sit at a full queue.

``FreshnessShedder`` polls every stage queue of a ``StreamingExecutor``,
finds the envelope with the globally-oldest ``Source.arrival`` stamp, and
drops it while its age exceeds the shed threshold.  Drops are strictly
oldest-first among *visible* events (an envelope mid-stage — between a get
and the next put — is invisible for one poll; it is picked up as soon as it
lands in the next queue).  Each drop increments the owning
``CreditQueue.dropped`` counter (the ``drop_oldest`` accounting) and
the executor's ``stats.dropped_stale``, so the Prometheus export needs no
new series for the drop path; staleness itself lands in the delivered-age
histogram.

Threshold: queued events are shed at ``max_staleness_s * slack``
(default slack 0.7) — the headroom covers the shed poll interval plus the
deliver→train latency of the final in-flight batch, so the *reported* p95
event-age-at-delivery stays under the configured bound rather than
oscillating just above it.

With a lookahead stage the ready queue carries planned batches whose cache
admits must all execute in delivery order (the planner's host mirror), so
the shedder excludes the ready queue in that configuration and sheds from
the placed queue upstream of planning.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


def _arrival_key(item) -> Optional[float]:
    # non-envelopes (EOS markers) have no arrival and are invisible
    return getattr(item, "arrival", None)


@dataclass
class ShedStats:
    """Global-shed accounting, kept separately from per-queue counters."""

    dropped: int = 0
    max_age_at_drop_s: float = 0.0
    # arrival stamps of dropped events, in drop order (oldest-first check)
    dropped_arrivals: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=4096))

    def note(self, arrival: float, age_s: float) -> None:
        self.dropped += 1
        self.dropped_arrivals.append(arrival)
        self.max_age_at_drop_s = max(self.max_age_at_drop_s, age_s)


class FreshnessShedder:
    """Poll-driven global oldest-first shedder over an executor's queues.

    Parameters
    ----------
    executor : a started (or about-to-start) ``StreamingExecutor`` whose
        Source stamps arrivals (``Source.events`` / ``Source.arrival``).
    max_staleness_s : the freshness bound on event age at delivery.
    slack : fraction of the bound at which *queued* events are shed (see
        module docstring); 1.0 sheds exactly at the bound.
    poll_s : sweep interval — bounds how long a stale event can linger.
    clock : arrival-comparable clock (``time.monotonic`` matches the bus).
    """

    def __init__(self, executor, max_staleness_s: float, *,
                 slack: float = 0.7, poll_s: float = 0.02,
                 clock: Callable[[], float] = time.monotonic):
        if max_staleness_s <= 0:
            raise ValueError("max_staleness_s must be positive")
        self.max_staleness_s = float(max_staleness_s)
        self.threshold_s = self.max_staleness_s * float(slack)
        self.poll_s = poll_s
        self.clock = clock
        self.stats = ShedStats()
        self._rt_stats = executor.stats
        queues = executor.stage_queues()
        if getattr(executor, "lookahead", None) is not None:
            # planned batches must not be dropped (host-mirror coherence)
            queues.pop("ready", None)
        self._queues = list(queues.values())
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="etl-shed",
                                        daemon=True)
        self._started = False

    # ---- one sweep (also the unit-test surface) --------------------------

    def shed_once(self, now: Optional[float] = None) -> int:
        """Drop every visible event older than the threshold, strictly
        oldest-first across all queues; returns the number dropped."""
        now = self.clock() if now is None else now
        dropped = 0
        while True:
            oldest: Optional[float] = None
            owner = None
            for q in self._queues:
                k = q.peek_oldest_key(_arrival_key)
                if k is not None and (oldest is None or k < oldest):
                    oldest, owner = k, q
            if oldest is None or (now - oldest) <= self.threshold_s:
                return dropped
            item = owner.drop_by_key(_arrival_key, oldest)
            if item is None:
                continue  # raced downstream between peek and drop: rescan
            self.stats.note(oldest, now - oldest)
            self._rt_stats.dropped_stale += 1
            dropped += 1

    # ---- lifecycle -------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            self.shed_once()
            self._stop.wait(self.poll_s)

    def start(self) -> "FreshnessShedder":
        if not self._started:
            self._thread.start()
            self._started = True
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._started:
            self._thread.join(timeout=2.0)

    def __enter__(self) -> "FreshnessShedder":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
