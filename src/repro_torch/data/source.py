"""First-class ingest sources with lazily-applied, chainable specs.

A ``Source`` is a declarative description of a raw columnar batch stream —
the ingest half of the paper's training-aware ETL abstraction (§3).  Instead
of hand-wiring a Python iterator into the executor, callers name *what* to
read and *how* (shard, projection, batch geometry, ordering key, arrival
times), and the planner/runtime consume those specs:

    src = (Source.columnar("/data/criteo")
               .shard(host_id, n_hosts)        # file-level shard selection
               .rebatch(65536))                # decouple shard size from batch
    job = EtlJob(pipeline, src)                # projection pushed automatically

Spec semantics
--------------
- ``.columns(names)``   projection: the columnar reader never materializes
  unrequested columns (``np.load`` is lazy per key); generated/stream sources
  filter the emitted dicts.  ``repro_torch.session.EtlJob`` pushes the pipeline's
  referenced-column set here automatically.
- ``.shard(i, n)``      reader *i* of *n*: shard-file-level for columnar
  datasets, round-robin by batch index for generated/stream sources.
- ``.rebatch(b)``       split / coalesce incoming batches to exactly ``b``
  rows, carrying remainders across source-batch (and shard) boundaries.
- ``.length_key(fn)``   host-side ordering key ``fn(raw_batch) -> float``
  computed at read time, so ``bucket_by_length`` ordering never syncs the
  transform stage's device futures (ROADMAP follow-on).
- ``.arrival(ts)``      per-batch arrival timestamps (sequence or
  ``fn(batch_index) -> float``) for freshness experiments; the runtime
  records the arrivals of delivered batches.

All specs are lazy: nothing moves until the Source is iterated.  Chaining
returns a new Source; a Source is re-iterable whenever its reader is
(columnar / synth always are, ``Source.stream`` over a bare iterator is
one-shot).
"""

from __future__ import annotations

import dataclasses
import queue as queue_lib
import threading
from typing import Callable, Iterator, Optional, Sequence, Union

import numpy as np

from repro_torch.core.schema import Schema
from repro_torch.data import columnar as columnar_lib
from repro_torch.data import synth as synth_lib


@dataclasses.dataclass(frozen=True)
class SourceSpec:
    """Lazily-applied ingest spec (see module docstring)."""

    columns: Optional[tuple] = None     # projection (None = all columns)
    shard_index: int = 0
    shard_count: int = 1
    rebatch_rows: Optional[int] = None
    drop_remainder: bool = False
    length_key: Optional[Callable] = None
    arrival: Optional[object] = None    # sequence of floats | fn(idx) -> float

    def arrival_fn(self) -> Optional[Callable[[int], Optional[float]]]:
        """Normalize ``arrival`` to an index -> timestamp lookup."""
        if self.arrival is None:
            return None
        if callable(self.arrival):
            return self.arrival
        seq = list(self.arrival)
        return lambda i: seq[i] if i < len(seq) else None


class _WAKE:
    """Sentinel a closing Source injects into its feed so a reader blocked
    on an empty queue wakes immediately instead of sleeping out its whole
    poll interval (shutdown-latency fix).  Readers discard it and re-check
    their close token, so a stale wake from a previous iteration's close is
    harmless."""


class _CloseChannel:
    """Close signal scoped to the *active* iteration of a blocking reader.

    ``token()`` hands each new iteration a fresh event, so closing one
    executor run (``Source.close``) never poisons a later re-iteration of
    the same Source (one active iteration at a time).  ``wake`` (optional)
    runs after the event is set to unblock a reader parked inside a blocking
    get — e.g. pushing ``_WAKE`` into a ``queue.Queue`` feed, or notifying a
    bus subscription's condition.
    """

    def __init__(self, wake: Optional[Callable[[], None]] = None):
        self._current: Optional[threading.Event] = None
        self._wake = wake

    def token(self) -> threading.Event:
        self._current = threading.Event()
        return self._current

    def set(self) -> None:
        if self._current is not None:
            self._current.set()
        if self._wake is not None:
            self._wake()


def _first_len(batch: dict) -> int:
    return int(next(iter(batch.values())).shape[0])


def rebatch(batches: Iterator[dict], batch_size: int, *,
            drop_remainder: bool = False) -> Iterator[dict]:
    """Re-slice a batch stream to a fixed row count.

    Rows carry across incoming batch boundaries (coalescing small shards,
    splitting large ones); the final partial batch is emitted unless
    ``drop_remainder``.
    """
    if batch_size <= 0:
        raise ValueError("rebatch size must be positive")
    carry: Optional[dict] = None
    for batch in batches:
        if carry is not None:
            batch = {k: np.concatenate([carry[k], batch[k]]) for k in batch}
        n = _first_len(batch)
        ofs = 0
        while n - ofs >= batch_size:
            yield {k: v[ofs:ofs + batch_size] for k, v in batch.items()}
            ofs += batch_size
        carry = ({k: v[ofs:] for k, v in batch.items()} if ofs < n else None)
    if carry is not None and not drop_remainder and _first_len(carry):
        yield carry


class Source:
    """Declarative raw-batch stream; see the module docstring.

    ``reader(spec)`` yields raw columnar dict batches with the *native*
    capabilities already applied; the generic wrapper applies whatever the
    reader does not handle itself (column filter, batch-index sharding,
    rebatching).
    """

    def __init__(self, reader: Callable[[SourceSpec], Iterator[dict]], *,
                 name: str = "source", spec: Optional[SourceSpec] = None,
                 native: frozenset = frozenset(),
                 schema: Optional[Schema] = None,
                 close_event: Optional[_CloseChannel] = None):
        self._reader = reader
        self.name = name
        self.spec = spec or SourceSpec()
        self._native = native
        self.schema = schema
        self._close_event = close_event

    # ---- chainable specs (each returns a new Source) ---------------------

    def _with(self, **changes) -> "Source":
        return Source(self._reader, name=self.name,
                      spec=dataclasses.replace(self.spec, **changes),
                      native=self._native, schema=self.schema,
                      close_event=self._close_event)

    def columns(self, names: Sequence[str]) -> "Source":
        """Project to ``names`` — pushed into the columnar reader so
        unreferenced columns are never materialized."""
        return self._with(columns=tuple(dict.fromkeys(names)))

    def shard(self, index: int, count: int) -> "Source":
        """Select this reader's 1/``count`` share of the stream."""
        if not 0 <= index < count:
            raise ValueError(f"shard index {index} not in [0, {count})")
        return self._with(shard_index=index, shard_count=count)

    def rebatch(self, batch_size: int, *,
                drop_remainder: bool = False) -> "Source":
        """Emit exactly ``batch_size`` rows per batch (micro-batch split /
        coalesce), decoupling source shard size from ``BatchingPolicy``."""
        if batch_size <= 0:
            raise ValueError("rebatch size must be positive")
        return self._with(rebatch_rows=batch_size,
                          drop_remainder=drop_remainder)

    def length_key(self, fn: Callable[[dict], float]) -> "Source":
        """Attach a host-side ordering key computed on the raw batch at read
        time; ``bucket_by_length`` then never syncs device futures."""
        return self._with(length_key=fn)

    def arrival(self, timestamps) -> "Source":
        """Attach per-batch arrival timestamps (freshness experiments)."""
        return self._with(arrival=timestamps)

    # ---- iteration -------------------------------------------------------

    def __iter__(self) -> Iterator[dict]:
        spec = self.spec
        it = self._reader(spec)
        if spec.columns is not None and "columns" not in self._native:
            cols = spec.columns
            it = ({k: b[k] for k in cols} for b in it)
        if spec.shard_count > 1 and "shard" not in self._native:
            idx, cnt = spec.shard_index, spec.shard_count
            it = (b for i, b in enumerate(it) if i % cnt == idx)
        if spec.rebatch_rows is not None:
            it = rebatch(it, spec.rebatch_rows,
                         drop_remainder=spec.drop_remainder)
        return it

    def close(self) -> None:
        """Unblock the *active* iteration of a blocking reader (queue
        streams) — the executor calls this on stop so shutdown never leaks
        a read thread parked on an empty feed.  A later re-iteration of the
        Source starts fresh; no-op for sources without a blocking reader."""
        if self._close_event is not None:
            self._close_event.set()

    def __repr__(self) -> str:
        return f"<Source {self.name} {self.spec}>"

    # ---- factories -------------------------------------------------------

    @staticmethod
    def columnar(path: str, *, batch_size: Optional[int] = None,
                 start_shard: int = 0) -> "Source":
        """Stream a ``repro-columnar-v1`` dataset directory.

        Projection and sharding are native: ``.columns`` reaches the
        ``np.load`` key access (unrequested columns stay on disk) and
        ``.shard(i, n)`` selects every n-th shard *file*.  ``batch_size``
        is sugar for ``.rebatch(batch_size)``.
        """
        def reader(spec: SourceSpec) -> Iterator[dict]:
            cols = list(spec.columns) if spec.columns is not None else None
            return columnar_lib.iter_shards(
                path, cols, start_shard,
                shard_index=spec.shard_index, shard_count=spec.shard_count)

        src = Source(reader, name=f"columnar:{path}",
                     native=frozenset({"columns", "shard"}),
                     schema=columnar_lib.load_schema(path))
        return src.rebatch(batch_size) if batch_size else src

    @staticmethod
    def synth(schema: Union[str, Schema], *, rows: int, batch_size: int,
              seed: int = 0, missing_rate: float = 0.02) -> "Source":
        """Synthetic dataset stream: ``schema`` is a paper dataset name
        ("I" | "II" | "III") or any ``Schema`` (generated via
        ``synth.gen_batch``).  Re-iterable and deterministic per seed."""
        if isinstance(schema, str):
            which = schema
            schema_obj = synth_lib.dataset_schema(which)

            def reader(spec: SourceSpec) -> Iterator[dict]:
                return synth_lib.dataset_batches(
                    which, rows=rows, batch_size=batch_size, seed=seed,
                    missing_rate=missing_rate)

            name = f"synth:{which}"
        else:
            schema_obj = schema

            def reader(spec: SourceSpec) -> Iterator[dict]:
                rng = np.random.default_rng(seed)
                emitted = 0
                while emitted < rows:
                    n = min(batch_size, rows - emitted)
                    yield synth_lib.gen_batch(schema_obj, n, rng,
                                              missing_rate=missing_rate)
                    emitted += n

            name = "synth:schema"
        return Source(reader, name=name, schema=schema_obj)

    @staticmethod
    def lm_events(seq_len: int, *, rows: int, batch_size: int, seed: int = 0,
                  id_universe: int = 1 << 22) -> "Source":
        """Raw LM event-log stream (unbounded ids; SigridHash bounds them)."""
        def reader(spec: SourceSpec) -> Iterator[dict]:
            return synth_lib.lm_event_batches(
                seq_len, rows=rows, batch_size=batch_size, seed=seed,
                id_universe=id_universe)

        return Source(reader, name=f"lm_events:{seq_len}",
                      schema=Schema.lm_events(seq_len))

    @staticmethod
    def stream(obj, *, poll_s: float = 0.2) -> "Source":
        """Wrap an online feed: a zero-arg callable returning a fresh
        iterator (re-iterable), a ``queue.Queue`` drained until a ``None``
        sentinel, or any iterable (one-shot).

        Queue readers poll with ``poll_s`` and end when ``close()`` is
        called (the executor does so on stop), so a producer that dies
        without sending the sentinel cannot leak the read thread.  Close is
        *immediate*: it also injects a wake sentinel into the queue, so a
        reader parked on an empty feed never sleeps out the rest of its
        poll interval before noticing.
        """
        if isinstance(obj, queue_lib.Queue):
            def wake() -> None:
                try:
                    obj.put_nowait(_WAKE)
                except queue_lib.Full:
                    # a full queue has no reader blocked on get(); the
                    # close event is observed at the next poll boundary
                    pass

            channel = _CloseChannel(wake=wake)

            def reader(spec: SourceSpec) -> Iterator[dict]:
                closed = channel.token()
                while not closed.is_set():
                    try:
                        item = obj.get(timeout=poll_s)
                    except queue_lib.Empty:
                        continue
                    if item is _WAKE:
                        continue  # close wake (maybe stale): re-check token
                    if item is None:
                        return
                    yield item

            return Source(reader, name="stream:queue", close_event=channel)
        if callable(obj):
            return Source(lambda spec: iter(obj()), name="stream:callable")
        return Source(lambda spec: iter(obj), name="stream:iterable")

    @staticmethod
    def events(bus, topic: str = "events", *,
               poll_s: float = 0.2) -> "Source":
        """Subscribe to an event bus topic (``bus.subscribe(topic)``) as a
        Source.

        The subscription is taken eagerly (no event published after this
        call is missed even if iteration starts later) and each event's bus
        arrival timestamp rides the ``Source.arrival`` spec, so the
        executor's freshness machinery — the delivered-staleness histogram
        and global oldest-first freshness shedding — sees true
        event ages.  ``close()`` wakes a blocked reader immediately; the
        stream ends when the bus closes.  Don't ``rebatch``/``shard`` an
        events source: arrival stamps are per published event, and respec'ing
        the geometry would misalign them.
        """
        sub = bus.subscribe(topic)
        channel = _CloseChannel(wake=sub.wake)
        arrivals: dict = {}   # emit index -> arrival; popped once consumed

        def reader(spec: SourceSpec) -> Iterator[dict]:
            closed = channel.token()
            idx = 0
            while not closed.is_set():
                ev = sub.get(timeout=poll_s, cancel=closed)
                if ev is None:
                    if sub.closed and not len(sub):
                        return  # bus closed and drained
                    continue    # timeout or close wake: re-check the token
                batch, arrival = ev
                arrivals[idx] = arrival
                idx += 1
                yield batch

        src = Source(reader, name=f"events:{topic}", close_event=channel)
        return src.arrival(lambda i: arrivals.pop(i, None))


def as_source(obj) -> Source:
    """Coerce anything batch-yielding into a Source (identity for one)."""
    return obj if isinstance(obj, Source) else Source.stream(obj)
