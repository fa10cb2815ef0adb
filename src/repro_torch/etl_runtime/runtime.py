"""Staged prefetching executor: overlap ETL with training (paper §3, Fig 3/8).

The pipeline is an explicit chain of stages connected by credit-bounded,
stop-aware queues (the paper's GPU staging buffers):

  read ──raw──▶ transform ──packed──▶ [order] ──▶ place ──ready──▶ deliver
       credits              credits               credits         (trainer)

(with a lookahead stage: place ──placed──▶ lookahead ──ready──▶ deliver)

Stage names, ``StageStats`` and ``RuntimeStats`` are those of the JAX
package, so the Prometheus export (``etl_runtime/metrics.py``) is too.

- **read** pulls raw batches from a ``Source`` (host-side ``length_key`` /
  ``arrival`` specs ride each batch's envelope) or any iterator.  A source
  stall beyond ``read_timeout_s`` is counted as a straggler skip.
- **transform** runs the compiled apply program.  For a CUDA pipeline it
  runs on the transform thread's own CUDA stream: raw columns go through
  pinned host buffers with ``non_blocking`` copies, the dataflow kernel is
  enqueued, and an event is recorded after it (``transfer.StreamTransform``)
  — no host sync, so ETL work overlaps the trainer's step on its stream.
- **order** (``OrderingPolicy.bucket_by_length`` only) buffers up to
  ``reorder_window`` packed batches and emits them by ascending length key.
- **place** applies an optional placement hook (identity by default: the
  batch is already on the trainer's device).  A CUDA payload's hook runs on
  the place thread's stream after the transform's event, and an event
  recorded after the hook replaces it.
- **lookahead** (``lookahead=EmbedCacheConfig(...)`` only) windows W placed
  batches, plans the embedding cache's admits and staging on the host, and
  annotates each delivered batch with its plan (``etl_runtime/lookahead.py``).
- **deliver** is the consumer side (``__iter__`` / ``get_batch``): the
  consumer's stream waits on the batch's event and records its tensors
  (``transfer.receive``), and trainer starvation time is recorded.

Backpressure: each queue holds at most ``credits`` items.  Freshness: with
``FreshnessPolicy.online`` a full ready queue sheds its oldest batch.  A
stage error stops the pipeline and re-raises at the consumer.  Timing goes
through an injected ``Clock``.

Knobs (``etl_runtime/controller.py``): ``autotune=`` runs the
measured-throughput ``PipelineController`` over the executor's actuators
(``set_credits``, ``set_prefetch_depth``, ``set_lookahead_window``; the job
adds ``swap_pipeline`` for the compile-time knobs), and the deprecated
``adaptive_credits=True`` builds the occupancy-rule controller on the
credits alone.  Resizes land in ``stats.credit_grows`` /
``stats.credit_shrinks``.  ``stage_queues()`` is what the global freshness
shedder (``online/shed.py``) sweeps.

``mesh=`` / ``sharding=`` make the place stage keep this rank's rows of each
batch (``transfer.put_packed``) unless a ``place`` hook is given.
"""

from __future__ import annotations

import collections
import functools
import queue
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.semantics import PipelineSemantics
from repro_torch.data.source import Source
from repro_torch.etl_runtime import transfer as transfer_lib
from repro_torch.etl_runtime.clock import SYSTEM_CLOCK, Clock
from repro_torch.etl_runtime.controller import PipelineController
from repro_torch.etl_runtime.lookahead import CacheStats, LookaheadStage


class _EOS:
    """End-of-stream marker forwarded through every queue."""


class _STOPPED:
    """Returned by queue ops when the executor is stopping."""


class CreditQueue:
    """Bounded FIFO whose put/get respect a shared stop event.

    Unlike ``queue.Queue``, a producer can never deadlock on a full queue
    during shutdown: both ends poll the stop event and return ``_STOPPED``.
    ``put(drop_oldest=True)`` implements the freshness policy — a full queue
    sheds its oldest entry to admit the new one (oldest-first drop).
    """

    def __init__(self, capacity: int, stop: threading.Event, name: str = "",
                 clock: Optional[Clock] = None):
        self.capacity = max(1, capacity)
        self.name = name
        self.dropped = 0  # lifetime count of entries shed by drop_oldest
        self._dq: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._stop = stop
        self._clock = clock or SYSTEM_CLOCK

    def __len__(self) -> int:
        with self._cv:
            return len(self._dq)

    def wake(self) -> None:
        with self._cv:
            self._cv.notify_all()

    def set_capacity(self, capacity: int) -> None:
        """Resize the credit budget.  Growing unblocks credit-waiting
        producers; shrinking never evicts queued items — the queue drains
        down to the new bound."""
        with self._cv:
            self.capacity = max(1, capacity)
            self._cv.notify_all()

    def put(self, item, *, drop_oldest: bool = False):
        """Block until enqueued. Returns the number of entries dropped to
        make room (0 normally), or ``_STOPPED`` if the executor stopped."""
        dropped = 0
        with self._cv:
            while len(self._dq) >= self.capacity:
                if self._stop.is_set():
                    return _STOPPED
                if drop_oldest:
                    # keep shedding until under the bound
                    self._dq.popleft()
                    dropped += 1
                    self.dropped += 1
                    continue
                # every transition notifies under this lock and stop() wakes
                # all queues, so an untimed wait cannot miss a wakeup
                self._cv.wait()
            if self._stop.is_set():
                return _STOPPED
            self._dq.append(item)
            self._cv.notify_all()
        return dropped

    def get(self, timeout: Optional[float] = None):
        """Block until an item is available. Raises ``queue.Empty`` on
        timeout; returns ``_STOPPED`` if the executor stopped."""
        deadline = (None if timeout is None
                    else self._clock.monotonic() + timeout)
        with self._cv:
            while True:
                # stop takes precedence over draining: shutdown is prompt
                if self._stop.is_set():
                    return _STOPPED
                if self._dq:
                    break
                if deadline is not None:
                    rem = deadline - self._clock.monotonic()
                    if rem <= 0:
                        raise queue.Empty
                    self._cv.wait(rem)
                else:
                    self._cv.wait()
            item = self._dq.popleft()
            self._cv.notify_all()
            return item

    def peek_oldest_key(self, key_fn: Callable) -> Optional[float]:
        """Smallest non-``None`` ``key_fn(item)`` among queued items (the
        oldest arrival when keyed by envelope arrival), or ``None``: how the
        global freshness shedder (``online/shed.py``) finds the stalest
        in-flight event across all stage queues."""
        with self._cv:
            keys = [k for item in self._dq
                    if (k := key_fn(item)) is not None]
            return min(keys) if keys else None

    def drop_by_key(self, key_fn: Callable, key: float):
        """Remove and return the first queued item whose ``key_fn`` equals
        ``key`` (``None`` if it moved downstream since the peek).  Counted
        in ``dropped`` like every other freshness shed."""
        with self._cv:
            for i, item in enumerate(self._dq):
                if key_fn(item) == key:
                    del self._dq[i]
                    self.dropped += 1
                    self._cv.notify_all()
                    return item
            return None


@dataclass
class _Envelope:
    """Per-batch sidecar riding every queue: the payload plus host-side
    metadata the stages consult without touching the (possibly in-flight
    device) payload — the Source-provided ordering key and arrival time,
    and the CUDA event the transform stage recorded after the payload's
    work (``None`` off the GPU)."""

    payload: object
    length_key: Optional[float] = None
    arrival: Optional[float] = None
    event: Optional[object] = None


@dataclass
class StageStats:
    """Per-stage occupancy accounting (paper Fig 8 breakdown)."""
    name: str
    items: int = 0
    busy_s: float = 0.0       # time spent doing the stage's own work
    wait_in_s: float = 0.0    # blocked waiting for upstream input
    wait_out_s: float = 0.0   # blocked on downstream credits (backpressure)
    drop_oldest: int = 0      # batches this stage's put shed (freshness)

    def occupancy(self) -> float:
        total = self.busy_s + self.wait_in_s + self.wait_out_s
        return self.busy_s / total if total > 0 else 0.0

    def as_dict(self) -> dict:
        return {"items": self.items, "busy_s": self.busy_s,
                "wait_in_s": self.wait_in_s, "wait_out_s": self.wait_out_s,
                "drop_oldest": self.drop_oldest,
                "occupancy": self.occupancy()}


#: delivered-staleness histogram buckets (seconds); Prometheus ``le`` bounds
STALENESS_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5, 5.0, 10.0)


@dataclass
class StalenessHistogram:
    """Cumulative histogram of event age at delivery (seconds since the
    Source.arrival stamp).  Rendered in the Prometheus histogram text
    format by ``etl_runtime.metrics``."""

    buckets: tuple = STALENESS_BUCKETS
    counts: list = field(default_factory=lambda: [0] * (len(STALENESS_BUCKETS) + 1))
    sum: float = 0.0
    count: int = 0

    def observe(self, age_s: float) -> None:
        self.sum += age_s
        self.count += 1
        for i, le in enumerate(self.buckets):
            if age_s <= le:
                self.counts[i] += 1
                return
        self.counts[-1] += 1  # +Inf bucket

    def cumulative(self) -> list:
        """Per-``le`` cumulative counts (Prometheus bucket semantics),
        ending with the +Inf bucket == ``count``."""
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


@dataclass
class RuntimeStats:
    produced: int = 0
    consumed: int = 0
    dropped_stale: int = 0
    skipped_straggler: int = 0
    consumer_wait_s: float = 0.0   # time trainer starved (ETL slower)
    credit_grows: int = 0          # adaptive-credit budget increases
    credit_shrinks: int = 0        # adaptive-credit budget decreases
    raw_resizes: int = 0           # adaptive resizes applied to the raw queue
    epoch_marks: list = field(default_factory=list)
    stages: dict = field(default_factory=dict)  # name -> StageStats
    # arrival timestamps (Source.arrival) of delivered batches, in delivery
    # order — the freshness-experiment record of what actually trained;
    # bounded so a long-running online job never grows it without limit
    delivered_arrivals: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=4096))
    # event age at delivery (now - arrival): cumulative histogram for the
    # Prometheus export plus a bounded recent window for exact percentiles
    staleness: StalenessHistogram = field(default_factory=StalenessHistogram)
    delivered_ages: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=4096))
    # ingest-side accounting for the events/sec gauge
    ingest_events: int = 0
    t_start: Optional[float] = None          # monotonic, set at start()
    t_last_ingest: Optional[float] = None    # monotonic, last read item
    # live knob values ({name: value}) and the owning PipelineController
    # when the executor runs with autotune / adaptive credits; exported as
    # gauges by etl_runtime.metrics
    knobs: dict = field(default_factory=dict)
    controller: Optional[object] = None
    # lookahead embedding-cache accounting (etl_runtime.lookahead.CacheStats)
    # when the executor runs with a lookahead config; None otherwise
    cache: Optional[CacheStats] = None

    def note_delivered(self, arrival: float,
                       now: Optional[float] = None) -> None:
        self.delivered_arrivals.append(arrival)
        age = (time.monotonic() if now is None else now) - arrival
        self.delivered_ages.append(age)
        self.staleness.observe(max(0.0, age))

    def note_ingest(self, now: Optional[float] = None) -> None:
        self.ingest_events += 1
        self.t_last_ingest = time.monotonic() if now is None else now

    def ingest_rate(self) -> float:
        """Mean ingested events/sec over the active span (read-stage items
        per second between start and the last read)."""
        if not self.ingest_events or self.t_start is None:
            return 0.0
        span = (self.t_last_ingest or self.t_start) - self.t_start
        return self.ingest_events / span if span > 0 else 0.0

    def staleness_percentiles(self) -> dict:
        """p50/p95/p99 event-age-at-delivery (seconds) over the recent
        ``delivered_ages`` window; zeros before any stamped delivery."""
        if not self.delivered_ages:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        ages = np.asarray(self.delivered_ages)
        return {f"p{p}": float(np.percentile(ages, p)) for p in (50, 95, 99)}

    # -- compatibility views over the per-stage accounting ----------------

    @property
    def etl_time_s(self) -> float:
        """Total ETL work time (transform dispatch + placement)."""
        return sum(s.busy_s for n, s in self.stages.items()
                   if n in ("transform", "place"))

    @property
    def producer_wait_s(self) -> float:
        """Time the producer side blocked on credits (ETL faster)."""
        return sum(s.wait_out_s for s in self.stages.values())

    @property
    def overlapped_etl_s(self) -> float:
        """ETL work hidden behind training: busy time the trainer did not
        pay for as starvation.  > 0 is the measured overlap win."""
        return max(0.0, self.etl_time_s - self.consumer_wait_s)

    def trainer_utilization(self, total_train_s: float) -> float:
        denom = total_train_s + self.consumer_wait_s
        return total_train_s / denom if denom > 0 else 1.0

    def stage_breakdown(self) -> dict:
        """Fig-8-style per-stage breakdown: {stage: {items, busy_s, ...}}."""
        return {name: s.as_dict() for name, s in self.stages.items()}


class _Stage(threading.Thread):
    """One pipeline stage: pull → work → push, with full time accounting.

    ``fn(item)`` returns the transformed item.  EOS is forwarded and the
    stage exits; a stop event aborts promptly even mid-put (CreditQueue is
    stop-aware, so a full downstream queue cannot deadlock teardown).
    """

    def __init__(self, stats: StageStats, fn: Callable, in_q: CreditQueue,
                 out_q: CreditQueue, *, drop_oldest: bool = False,
                 in_timeout_s: Optional[float] = None,
                 on_in_timeout: Optional[Callable[[], None]] = None,
                 on_put: Optional[Callable[[int], None]] = None,
                 on_error: Optional[Callable[[BaseException], None]] = None,
                 clock: Optional[Clock] = None):
        super().__init__(name=f"etl-{stats.name}", daemon=True)
        self.stats = stats
        self.fn = fn
        self.in_q = in_q
        self.out_q = out_q
        self.drop_oldest = drop_oldest
        self.in_timeout_s = in_timeout_s
        self.on_in_timeout = on_in_timeout
        self.on_put = on_put
        self.on_error = on_error
        self._clock = clock or SYSTEM_CLOCK

    def run(self):
        mono = self._clock.monotonic
        while True:
            t0 = mono()
            try:
                item = self.in_q.get(timeout=self.in_timeout_s)
            except queue.Empty:
                self.stats.wait_in_s += mono() - t0
                if self.on_in_timeout:
                    self.on_in_timeout()
                continue
            self.stats.wait_in_s += mono() - t0
            if item is _STOPPED:
                return
            if item is _EOS:
                self.out_q.put(_EOS)
                return
            t1 = mono()
            try:
                out = self.fn(item)
            except Exception as e:
                # never die silently: surface the error and stop the
                # pipeline so the consumer unblocks instead of hanging
                if self.on_error:
                    self.on_error(e)
                return
            self.stats.busy_s += mono() - t1
            t2 = mono()
            r = self.out_q.put(out, drop_oldest=self.drop_oldest)
            self.stats.wait_out_s += mono() - t2
            if r is _STOPPED:
                return
            self.stats.items += 1
            self.stats.drop_oldest += r
            if self.on_put:
                self.on_put(r)


def _pump_source(source, out_q: CreditQueue, stats: StageStats,
                 stop: threading.Event, *, wrap: Optional[Callable] = None,
                 on_error: Optional[Callable[[BaseException], None]] = None,
                 clock: Optional[Clock] = None) -> None:
    """The read stage's pump loop, shared by the executor's read thread and
    the standalone ``SourcePrefetcher``: drain ``source`` into ``out_q``
    with busy / wait-out accounting, then enqueue a stop-aware EOS (never a
    blocking put into a full queue).  ``wrap(raw, idx)`` transforms each
    item at read time (the executor stamps envelope metadata here);
    ``on_error`` sets the failure policy (the executor stops the whole
    pipeline, the prefetcher records and re-raises at the consumer)."""
    mono = (clock or SYSTEM_CLOCK).monotonic
    try:
        it = iter(source)
        idx = 0
        while not stop.is_set():
            t0 = mono()
            try:
                raw = next(it)
                item = raw if wrap is None else wrap(raw, idx)
            except StopIteration:
                break
            except Exception as e:
                if on_error is not None:
                    on_error(e)
                return
            stats.busy_s += mono() - t0
            idx += 1
            t1 = mono()
            r = out_q.put(item)
            stats.wait_out_s += mono() - t1
            if r is _STOPPED:
                return
            stats.items += 1
    finally:
        out_q.put(_EOS)


def default_length_key(batch) -> float:
    """Length proxy for bucket_by_length: nonzero entries of the first
    2-D integer tensor (token count for LM batches), else 0.

    Reads a device tensor's count back to the host, so the sort stage
    synchronizes with the transform's work — acceptable because ordering
    buys its win at the trainer, after the transform already overlapped.
    """
    if isinstance(batch, dict):
        for v in batch.values():
            if isinstance(v, torch.Tensor):
                if v.dim() >= 2 and not v.is_floating_point():
                    return float(torch.count_nonzero(v))
                continue
            a = np.asarray(v)
            if a.ndim >= 2 and np.issubdtype(a.dtype, np.integer):
                return float(np.count_nonzero(a))
    return 0.0


class _SortStage(threading.Thread):
    """Bounded reorder window (OrderingPolicy.bucket_by_length).

    Buffers up to ``window`` packed batches, flushes them in ascending
    ``length_key`` order (stable: equal keys keep arrival order), then
    refills.  EOS flushes the partial window before forwarding, so no batch
    is lost; stop aborts promptly like every other stage.

    The key comes from the batch envelope when the Source supplied a
    host-side ``length_key`` (computed at read time — the transform stage's
    device futures are never synced); only keyless envelopes fall back to
    the ``length_key`` callable, which materializes the payload.
    """

    def __init__(self, stats: StageStats, in_q: CreditQueue,
                 out_q: CreditQueue, *, window: int,
                 length_key: Callable = default_length_key,
                 on_error: Optional[Callable[[BaseException], None]] = None,
                 clock: Optional[Clock] = None):
        super().__init__(name=f"etl-{stats.name}", daemon=True)
        self.stats = stats
        self.in_q = in_q
        self.out_q = out_q
        self.window = max(2, window)
        self.length_key = length_key
        self.on_error = on_error
        self._clock = clock or SYSTEM_CLOCK

    def _flush(self, buf: list) -> bool:
        mono = self._clock.monotonic
        t0 = mono()
        buf.sort(key=lambda kv: kv[0])
        self.stats.busy_s += mono() - t0
        for _, item in buf:
            t1 = mono()
            r = self.out_q.put(item)
            self.stats.wait_out_s += mono() - t1
            if r is _STOPPED:
                return False
            self.stats.items += 1
        buf.clear()
        return True

    def run(self):
        mono = self._clock.monotonic
        buf: list = []
        while True:
            t0 = mono()
            item = self.in_q.get()
            self.stats.wait_in_s += mono() - t0
            if item is _STOPPED:
                return
            if item is _EOS:
                if buf and not self._flush(buf):
                    return
                self.out_q.put(_EOS)
                return
            t1 = mono()
            try:
                key = item.length_key
                if key is None:
                    key = self.length_key(item.payload)
                buf.append((key, item))
            except Exception as e:
                if self.on_error:
                    self.on_error(e)
                return
            self.stats.busy_s += mono() - t1
            if len(buf) >= self.window and not self._flush(buf):
                return


class SourcePrefetcher:
    """The executor's read stage, standalone: prefetch raw batches from a
    Source through a credit-bounded, stop-aware queue on a background
    thread.

    ``EtlJob.fit`` wraps its (projected) fit Source in one of these so fit
    ingest overlaps the fused chunk build — the reader fills the queue while
    the device builds the previous chunk's first-occurrence tables — instead
    of blocking the build on every disk read.  Iterating yields raw batches;
    a reader error stops the stream and re-raises at the consumer (same
    loud-failure contract as the full executor).  ``close()`` is prompt and
    also closes a closeable Source.
    """

    def __init__(self, source, *, credits: int = 2, name: str = "fit-read",
                 clock: Optional[Clock] = None):
        self._source = source
        self._stop = threading.Event()
        self._clock = clock or SYSTEM_CLOCK
        self._q = CreditQueue(max(1, credits), self._stop, name,
                              clock=self._clock)
        self.stats = StageStats(name)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._read_loop,
                                        name=f"etl-{name}", daemon=True)
        self._started = False

    def _read_loop(self):
        def record(e: BaseException) -> None:
            # end the stream but let already-queued batches deliver;
            # the consumer re-raises at EOS
            self._error = e

        _pump_source(self._source, self._q, self.stats, self._stop,
                     on_error=record, clock=self._clock)

    def start(self) -> "SourcePrefetcher":
        if not self._started:
            self._thread.start()
            self._started = True
        return self

    def __iter__(self):
        self.start()
        st = self.stats
        mono = self._clock.monotonic
        while True:
            t0 = mono()
            item = self._q.get()
            st.wait_in_s += mono() - t0
            if item is _EOS or item is _STOPPED:
                if item is _EOS:
                    self._q.put(_EOS)  # re-arm: a later iteration ends too
                if self._error is not None:
                    raise RuntimeError("fit read stage failed") from self._error
                return
            yield item

    def set_credits(self, credits: int) -> None:
        """Resize the prefetch depth (the controller's prefetch knob)."""
        self._q.set_capacity(max(1, int(credits)))

    def close(self) -> None:
        self._stop.set()
        if isinstance(self._source, Source):
            self._source.close()
        self._q.wake()
        if self._started:
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "SourcePrefetcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


class StreamingExecutor:
    """Staged prefetching bridge between a CompiledPipeline and a trainer.

    Parameters
    ----------
    pipeline : compiled apply program, called as ``pipeline(raw) -> packed``;
        when it carries a CUDA ``device`` the transform stage runs it on a
        stream of its own (see the module docstring).
    source : a ``Source`` or any iterator of raw columnar batches.
    semantics : optional PipelineSemantics; ``freshness.online`` enables
        oldest-first shedding at the ready queue.
    credits : staging-buffer depth per queue (2 = double buffering).
    place : optional placement hook ``packed -> ready``.
    sharding, mesh : without ``place``, place each batch with
        ``transfer.put_packed`` on ``sharding`` (default: the row
        sharding of ``mesh``'s data axes, ``transfer.batch_sharding``).
    read_timeout_s : straggler bound on the raw queue.
    adaptive_credits : deprecated spelling of the occupancy-rule credits
        controller (grow on starvation, shrink on idle-full, with
        hysteresis); ignored when ``autotune`` is set.
    max_credits : upper bound for adaptive / autotuned credit growth.
    autotune : ``True`` builds the measured-throughput
        ``PipelineController`` over this executor's knobs (credits, prefetch
        depth, lookahead window); a ``PipelineController`` instance is bound
        as is (its knob list is extended with the executor knobs it does not
        already declare).  Decisions and live knob values land in
        ``stats.controller`` / ``stats.knobs`` and the Prometheus export.
    length_key : fallback batch -> sortable length for bucket_by_length.
    transform_service : optional acquire/release gate arbitrating the
        transform stage's dispatch across tenants (see
        ``etl_runtime.multitenant``): acquired around each apply call,
        released after it.  On CUDA the apply runs on this executor's own
        stream, so a grant orders kernel launches, not device time.
    lookahead : optional ``etl_runtime.lookahead.EmbedCacheConfig``; adds the
        lookahead stage after **place**: a window of W in-flight envelopes
        drives per-table hot-set planning and each delivered batch carries
        its embedding-cache plan (``lookahead.PLAN_KEYS``, host numpy).
        Cache accounting lands in ``stats.cache``.  With freshness shedding
        the shed point moves to the placed queue (before planning), so a
        planned cache update is never dropped — the consumer must apply
        every delivered plan, in order.
    clock : timing source; defaults to the system clock.
    """

    def __init__(self, pipeline, source, *,
                 semantics: Optional[PipelineSemantics] = None,
                 credits: int = 2,
                 place: Optional[Callable[[dict], dict]] = None,
                 sharding=None, mesh=None,
                 read_timeout_s: float = 30.0,
                 adaptive_credits: bool = False, max_credits: int = 8,
                 autotune=None,
                 length_key: Callable = default_length_key,
                 transform_service=None, lookahead=None,
                 clock: Optional[Clock] = None):
        self.pipeline = pipeline
        self.semantics = semantics or getattr(pipeline, "semantics", None)
        self.credits = max(1, credits)
        self.max_credits = max(self.credits, max_credits)
        self.current_credits = self.credits
        self.lookahead = lookahead
        self.read_timeout_s = read_timeout_s
        self.clock = clock or SYSTEM_CLOCK
        if place is None:
            if sharding is None and mesh is not None:
                sharding = transfer_lib.batch_sharding(mesh)
            if sharding is not None:
                place = functools.partial(transfer_lib.put_packed,
                                          sharding=sharding)
            else:
                place = lambda b: b
        self.place = place
        self._source = source
        self._host_key_fn = None
        self._arrival_fn = None
        if isinstance(source, Source):
            self._host_key_fn = source.spec.length_key
            self._arrival_fn = source.spec.arrival_fn()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self.stats = RuntimeStats()
        ordering = self.semantics.ordering if self.semantics else None
        reorder = bool(ordering and ordering.kind == "bucket_by_length"
                       and ordering.reorder_window >= 2)
        names = ["read", "transform", "place", "deliver"]
        if reorder:
            names.insert(2, "order")
        if lookahead is not None:
            names.insert(names.index("deliver"), "lookahead")
        for name in names:
            self.stats.stages[name] = StageStats(name)

        fresh = bool(self.semantics and self.semantics.freshness.online)
        ck = self.clock
        self._raw_q = CreditQueue(self.credits, self._stop, "raw", clock=ck)
        self._packed_q = CreditQueue(self.credits, self._stop, "packed",
                                     clock=ck)
        self._ready_q = CreditQueue(self.credits, self._stop, "ready",
                                    clock=ck)
        self._placed_q = (CreditQueue(self.credits, self._stop, "placed",
                                      clock=ck)
                          if lookahead is not None else None)

        def _on_straggler():
            self.stats.skipped_straggler += 1

        def _on_delivered(dropped: int):
            self.stats.produced += 1
            self.stats.dropped_stale += dropped

        def _on_shed(dropped: int):
            # place -> placed under lookahead: shedding happens here (before
            # planning), production is counted at the final ready-queue put
            self.stats.dropped_stale += dropped

        def _on_error(exc: BaseException):
            # first error wins; stop() unblocks every stage and the consumer
            if self._error is None:
                self._error = exc
            self.stop()

        place_in_q = self._packed_q
        order_stages: list = []
        self._sorted_q = None
        if reorder:
            self._sorted_q = CreditQueue(self.credits, self._stop, "sorted",
                                         clock=ck)
            order_stages.append(_SortStage(
                self.stats.stages["order"], self._packed_q, self._sorted_q,
                window=ordering.reorder_window, length_key=length_key,
                on_error=_on_error, clock=ck))
            place_in_q = self._sorted_q

        # the transform reads self.pipeline per batch (not a captured
        # reference), so swap_pipeline takes effect on the next batch
        def apply(raw):
            return self.pipeline(raw)
        if transform_service is not None:
            def apply(raw):
                # weighted round-robin service: dispatch, not just staging
                # credits, follows tenant weights
                granted = transform_service.acquire(stop=self._stop)
                try:
                    return self.pipeline(raw)
                finally:
                    if granted:
                        transform_service.release()
        device = getattr(pipeline, "device", None)
        if device is not None and torch.device(device).type == "cuda":
            run = transfer_lib.StreamTransform(apply, torch.device(device))
        else:
            def run(raw):
                return apply(raw), None

        def transform_fn(env: _Envelope) -> _Envelope:
            payload, event = run(env.payload)
            return replace(env, payload=payload, event=event)

        def place_fn(env: _Envelope) -> _Envelope:
            if env.event is None:
                return replace(env, payload=self.place(env.payload))
            # the hook reads what the transform stream wrote (put_packed
            # copies a rank's rows): it runs on this thread's stream after
            # the transform's event, and the stages after it wait on an
            # event recorded after the hook
            with torch.cuda.device(device):
                payload = self.place(transfer_lib.receive(env.payload,
                                                          env.event))
                event = torch.cuda.Event()
                event.record()
            return replace(env, payload=payload, event=event)

        self._stages = [
            _Stage(self.stats.stages["transform"], transform_fn,
                   self._raw_q, self._packed_q,
                   in_timeout_s=self.read_timeout_s,
                   on_in_timeout=_on_straggler, on_error=_on_error, clock=ck),
            *order_stages,
            _Stage(self.stats.stages["place"], place_fn, place_in_q,
                   self._placed_q if lookahead is not None else self._ready_q,
                   drop_oldest=fresh,
                   on_put=_on_shed if lookahead is not None else _on_delivered,
                   on_error=_on_error, clock=ck),
        ]
        self._lookahead_stage = None
        if lookahead is not None:
            self.stats.cache = CacheStats(row_bytes=lookahead.row_bytes)
            self._lookahead_stage = LookaheadStage(
                self.stats.stages["lookahead"], self._placed_q, self._ready_q,
                lookahead, cache_stats=self.stats.cache,
                on_put=_on_delivered, on_error=_on_error, clock=ck)
            self._stages.append(self._lookahead_stage)
        self._on_error = _on_error
        self._reader = threading.Thread(target=self._read_loop,
                                        name="etl-read", daemon=True)
        self._started = False

        # ---- knob controller (autotune / deprecated adaptive_credits) ----
        self.stats.knobs["credits"] = self.current_credits
        self._controller = None
        if autotune:
            if isinstance(autotune, PipelineController):
                autotune.bind_executor(self)
                self._controller = autotune
            else:
                self._controller = PipelineController.for_executor(self)
        elif adaptive_credits:
            self._controller = PipelineController.adaptive_credits(self)
        self.stats.controller = self._controller

    def _read_loop(self):
        def wrap(raw, idx):
            # envelope metadata is computed host-side at read time
            key = (float(self._host_key_fn(raw))
                   if self._host_key_fn is not None else None)
            arrival = (self._arrival_fn(idx)
                       if self._arrival_fn is not None else None)
            self.stats.note_ingest(now=self.clock.monotonic())
            return _Envelope(raw, key, arrival)

        _pump_source(self._source, self._raw_q, self.stats.stages["read"],
                     self._stop, wrap=wrap, on_error=self._on_error,
                     clock=self.clock)

    # ---- knob actuators (PipelineController apply hooks) -----------------

    def set_credits(self, credits: int) -> None:
        """Resize the whole staging budget to ``credits``: every stage queue,
        the raw (read -> transform) queue included.  Grow / shrink counters
        move by one per call, as the controller moves one step at a time."""
        credits = max(1, int(credits))
        if credits == self.current_credits:
            return
        if credits > self.current_credits:
            self.stats.credit_grows += 1
        else:
            self.stats.credit_shrinks += 1
        self.current_credits = credits
        for q in (self._raw_q, self._packed_q, self._ready_q, self._sorted_q,
                  self._placed_q):
            if q is not None:
                q.set_capacity(credits)
        self.stats.raw_resizes += 1
        self.stats.knobs["credits"] = credits

    def set_prefetch_depth(self, depth: int) -> None:
        """Resize only the raw (read -> transform) queue: the prefetch-depth
        knob, independent of the downstream staging credits."""
        depth = max(1, int(depth))
        self._raw_q.set_capacity(depth)
        self.stats.knobs["prefetch_depth"] = depth

    def set_lookahead_window(self, window: int) -> None:
        """Resize the lookahead planning window (no-op without the
        lookahead stage)."""
        if self._lookahead_stage is not None:
            self._lookahead_stage.set_window(window)
            self.stats.knobs["lookahead_window"] = max(1, int(window))

    def swap_pipeline(self, pipeline) -> None:
        """Swap the transform program (the row-tile / fuse knobs' actuator:
        ``EtlJob`` recompiles with ``CompiledPipeline.with_knobs``, sharing
        the vocabulary state, and swaps the result in here).  A single
        attribute store: the transform stage reads ``self.pipeline`` once
        per batch, so the next batch runs the new program and a batch in
        flight finishes on the old one."""
        self.pipeline = pipeline

    def _adapt(self, wait_s: float) -> None:
        """One deliver-side observation, forwarded to the controller.
        Fullness is sampled at pop time (the item just taken plus the
        remaining depth), so it does not race the producer refilling."""
        if self._controller is None:
            return
        full_at_pop = len(self._ready_q) + 1 >= self._ready_q.capacity
        self._controller.on_delivery(wait_s=wait_s, ready_full=full_at_pop,
                                     now=self.clock.monotonic())

    # ---- public API ------------------------------------------------------

    def start(self) -> "StreamingExecutor":
        if not self._started:
            self.stats.t_start = self.clock.monotonic()
            self._reader.start()
            for s in self._stages:
                s.start()
            self._started = True
        return self

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            raise RuntimeError("ETL pipeline stage failed") from self._error

    def _deliver(self, item: _Envelope, wait: float):
        dst = self.stats.stages["deliver"]
        self.stats.consumer_wait_s += wait
        dst.wait_in_s += wait
        if item is _EOS or item is _STOPPED:
            self._raise_if_failed()
            return _EOS
        self.stats.consumed += 1
        dst.items += 1
        if item.arrival is not None:
            self.stats.note_delivered(item.arrival,
                                      now=self.clock.monotonic())
        self._adapt(wait)
        return transfer_lib.receive(item.payload, item.event)

    def __iter__(self):
        self.start()
        mono = self.clock.monotonic
        while True:
            w0 = mono()
            item = self._ready_q.get()
            batch = self._deliver(item, mono() - w0)
            if batch is _EOS:
                return
            yield batch

    def get_batch(self, timeout: Optional[float] = None):
        self.start()
        mono = self.clock.monotonic
        w0 = mono()
        item = self._ready_q.get(timeout=timeout)
        batch = self._deliver(item, mono() - w0)
        if batch is _EOS:
            raise StopIteration
        return batch

    def stop(self):
        """Prompt, non-blocking shutdown (stop-aware queues; a closeable
        Source is closed so the read thread cannot stay parked)."""
        self._stop.set()
        if isinstance(self._source, Source):
            self._source.close()
        for q in (self._raw_q, self._packed_q, self._sorted_q, self._placed_q,
                  self._ready_q):
            if q is not None:
                q.wake()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for all stage threads to exit; True if they all did."""
        deadline = (time.monotonic() + timeout) if timeout is not None else None
        threads = ([self._reader] + self._stages) if self._started else []
        for t in threads:
            rem = None if deadline is None else max(0.0, deadline - time.monotonic())
            t.join(rem)
        return all(not t.is_alive() for t in threads)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def stage_queues(self) -> dict:
        """Live stage queues in pipeline order (upstream -> downstream): the
        surface ``online/shed.py`` sweeps for global oldest-first freshness
        shedding.  With a lookahead stage the ready queue holds *planned*
        batches (their cache admits must execute in order), so shedders
        must not drop from it."""
        qs = {"raw": self._raw_q, "packed": self._packed_q}
        if self._sorted_q is not None:
            qs["sorted"] = self._sorted_q
        if self._placed_q is not None:
            qs["placed"] = self._placed_q
        qs["ready"] = self._ready_q
        return qs

    def queue_depths(self) -> dict:
        return {name: len(q) for name, q in self.stage_queues().items()}
