"""In-process event bus with bounded topics and a TCP transport.

A copy of the JAX package's bus (numpy only; the port imports nothing of
that package).

The online-training ingest surface: producers ``publish`` raw columnar
batches to named topics; consumers hold ``Subscription``s (every subscriber
of a topic sees every event published after it subscribed — the trainer and
the vocab-refit window can tap the same stream independently).  Each event
is stamped with an arrival timestamp at publish time; ``Source.events(bus)``
threads those stamps through the ``Source.arrival`` spec, so the runtime's
freshness machinery (delivered-staleness histogram, global shedding) sees
true event ages.

Topics are **bounded**: a subscription that falls behind sheds its oldest
queued events (drop-oldest, counted in ``Subscription.dropped``) instead of
blocking the producer — the bus-side half of the freshness contract; the
queue-side half is ``online/shed.py``.

The TCP transport (``BusServer`` / ``BusClient``) moves events between
processes as length-prefixed frames::

    u32 topic_len | topic utf-8 | u64 payload_len | npz(columns)

so a remote log tailer can feed a trainer with nothing but a socket.  It is
a demo-grade transport (no auth, trusted peers only), loopback by default.
"""

from __future__ import annotations

import collections
import io
import socket
import struct
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np


class Subscription:
    """One consumer's bounded view of a topic (drop-oldest on overflow)."""

    def __init__(self, topic: str, capacity: int):
        self.topic = topic
        self.capacity = max(1, capacity)
        self.dropped = 0          # events shed because this consumer lagged
        self.delivered = 0
        self._dq: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._closed = False

    def _publish(self, batch: dict, arrival: float) -> int:
        with self._cv:
            if self._closed:
                return 0
            shed = 0
            while len(self._dq) >= self.capacity:
                self._dq.popleft()
                self.dropped += 1
                shed += 1
            self._dq.append((batch, arrival))
            self._cv.notify_all()
            return shed

    def get(self, timeout: Optional[float] = None,
            cancel: Optional[threading.Event] = None
            ) -> Optional[Tuple[dict, float]]:
        """Next ``(batch, arrival)``; ``None`` when the bus closed (and the
        queue drained), the ``cancel`` event is set, or ``timeout`` elapsed.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not self._dq:
                if self._closed or (cancel is not None and cancel.is_set()):
                    return None
                if deadline is None:
                    self._cv.wait()
                else:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        return None
                    self._cv.wait(rem)
            self.delivered += 1
            return self._dq.popleft()

    def get_nowait(self) -> Optional[Tuple[dict, float]]:
        with self._cv:
            if not self._dq:
                return None
            self.delivered += 1
            return self._dq.popleft()

    def wake(self) -> None:
        """Wake a blocked ``get`` so it can observe its cancel event."""
        with self._cv:
            self._cv.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def __len__(self) -> int:
        with self._cv:
            return len(self._dq)

    def __iter__(self) -> Iterator[Tuple[dict, float]]:
        while True:
            ev = self.get()
            if ev is None:
                return
            yield ev


class _Topic:
    def __init__(self, name: str, capacity: int):
        self.name = name
        self.capacity = capacity
        self.published = 0
        self.unrouted = 0   # events published with no live subscriber
        self.subs: List[Subscription] = []


class EventBus:
    """Bounded in-process pub/sub; see module docstring.

    ``capacity`` bounds each *subscription* (per consumer, per topic).  The
    ``clock`` stamps arrivals and defaults to ``time.monotonic`` so ages are
    immune to wall-clock jumps; pass a fake for deterministic tests.
    """

    def __init__(self, capacity: int = 256, *,
                 clock: Callable[[], float] = time.monotonic):
        self.capacity = max(1, capacity)
        self.clock = clock
        self.closed = False
        self._lock = threading.Lock()
        self._topics: Dict[str, _Topic] = {}

    def _topic(self, name: str) -> _Topic:
        with self._lock:
            t = self._topics.get(name)
            if t is None:
                t = self._topics[name] = _Topic(name, self.capacity)
            return t

    def publish(self, topic: str, batch: dict, *,
                arrival: Optional[float] = None) -> int:
        """Fan ``batch`` out to every subscriber of ``topic``; returns the
        number of events shed from lagging subscriptions to make room.
        Publishing never blocks (bounded topics drop oldest instead)."""
        if self.closed:
            raise RuntimeError("publish on a closed EventBus")
        t = self._topic(topic)
        ts = self.clock() if arrival is None else arrival
        with self._lock:
            subs = list(t.subs)
            t.published += 1
            if not subs:
                t.unrouted += 1
        return sum(s._publish(batch, ts) for s in subs)

    def subscribe(self, topic: str,
                  capacity: Optional[int] = None) -> Subscription:
        """New bounded subscription seeing events published from now on."""
        t = self._topic(topic)
        sub = Subscription(topic, capacity or t.capacity)
        with self._lock:
            t.subs.append(sub)
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        t = self._topic(sub.topic)
        with self._lock:
            if sub in t.subs:
                t.subs.remove(sub)
        sub.close()

    def close(self) -> None:
        """End every subscription (consumers drain, then see the end)."""
        self.closed = True
        with self._lock:
            subs = [s for t in self._topics.values() for s in t.subs]
        for s in subs:
            s.close()

    def counts(self) -> dict:
        """Per-topic accounting: published / unrouted / per-sub drops."""
        with self._lock:
            return {name: {"published": t.published,
                           "unrouted": t.unrouted,
                           "subscribers": len(t.subs),
                           "dropped": sum(s.dropped for s in t.subs)}
                    for name, t in self._topics.items()}


# ---------------------------------------------------------------------------
# TCP transport: length-prefixed npz frames
# ---------------------------------------------------------------------------

def _encode_frame(topic: str, batch: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in batch.items()})
    payload = buf.getvalue()
    tb = topic.encode("utf-8")
    return struct.pack(">I", len(tb)) + tb + \
        struct.pack(">Q", len(payload)) + payload


def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 16))
        if not b:
            return None
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _decode_stream(sock: socket.socket) -> Iterator[Tuple[str, dict]]:
    while True:
        hdr = _read_exact(sock, 4)
        if hdr is None:
            return
        (tlen,) = struct.unpack(">I", hdr)
        topic = _read_exact(sock, tlen)
        plen_b = _read_exact(sock, 8)
        if topic is None or plen_b is None:
            return
        (plen,) = struct.unpack(">Q", plen_b)
        payload = _read_exact(sock, plen)
        if payload is None:
            return
        with np.load(io.BytesIO(payload)) as z:
            batch = {k: z[k] for k in z.files}
        yield topic.decode("utf-8"), batch


class BusServer:
    """Accept loop turning socket frames into ``bus.publish`` calls.

    Binds ``host:port`` (port 0 = ephemeral; read ``.address``) and runs a
    daemon accept thread plus one reader thread per connection.  Arrival is
    stamped at decode time on the receiving host — the bus clock, not the
    sender's.
    """

    def __init__(self, bus: EventBus, host: str = "127.0.0.1", port: int = 0):
        self.bus = bus
        self._sock = socket.create_server((host, port))
        self.address = self._sock.getsockname()
        self.frames = 0
        self._stop = threading.Event()
        self._conns: List[socket.socket] = []
        self._threads: List[threading.Thread] = []
        self._accept = threading.Thread(target=self._accept_loop,
                                        name="bus-accept", daemon=True)
        self._accept.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            self._conns.append(conn)
            t = threading.Thread(target=self._read_loop, args=(conn,),
                                 name="bus-conn", daemon=True)
            t.start()
            self._threads.append(t)

    def _read_loop(self, conn: socket.socket) -> None:
        try:
            for topic, batch in _decode_stream(conn):
                if self._stop.is_set():
                    return
                self.bus.publish(topic, batch)
                self.frames += 1
        except OSError:
            pass
        finally:
            conn.close()

    def close(self) -> None:
        self._stop.set()
        self._sock.close()
        for c in self._conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        for t in self._threads:
            t.join(timeout=2.0)


class BusClient:
    """Publisher end of the TCP transport (one connection, any topics)."""

    def __init__(self, address: Tuple[str, int]):
        self._sock = socket.create_connection(address)
        self._lock = threading.Lock()

    def publish(self, topic: str, batch: dict) -> None:
        frame = _encode_frame(topic, batch)
        with self._lock:
            self._sock.sendall(frame)

    def close(self) -> None:
        self._sock.close()


# ---------------------------------------------------------------------------
# producer helper (examples / benchmarks / tests)
# ---------------------------------------------------------------------------

def replay(bus: EventBus, topic: str, batches, *, rate_hz: float = 0.0,
           burst: int = 1, stop: Optional[threading.Event] = None) -> int:
    """Publish ``batches`` to ``topic``, optionally paced.

    ``rate_hz`` > 0 targets that many events/s on average; ``burst`` sends
    that many back-to-back per pacing interval (bursty arrivals are the
    interesting regime for shedding).  Blocking — wrap in a Thread for a
    background producer.  Returns the number of events published.
    """
    n = 0
    it = iter(batches)
    interval = (burst / rate_hz) if rate_hz > 0 else 0.0
    next_at = time.monotonic()
    while stop is None or not stop.is_set():
        sent = 0
        for b in it:
            bus.publish(topic, b)
            n += 1
            sent += 1
            if sent >= burst:
                break
        if sent < burst:
            return n  # source exhausted
        if interval:
            next_at += interval
            delay = next_at - time.monotonic()
            if delay > 0:
                if stop is not None:
                    if stop.wait(delay):
                        return n
                else:
                    time.sleep(delay)
    return n
