"""Clock seam for the streaming runtime (deterministic-time testing).

Every timing call in the staged executor — stage busy/wait accounting,
queue ``get`` deadlines, delivered-staleness stamps — goes through an
injected ``Clock`` instead of calling ``time.monotonic()`` directly.
Production code never notices (``SYSTEM_CLOCK`` delegates to ``time``),
but tests can inject a ``VirtualClock`` whose "now" only moves when the
test advances it, so timing-dependent behavior (overlap margins, adaptive
credits, the self-tuning controller's observation windows) is exercised
deterministically instead of through wall-clock sleeps.

``tests/simclock.py`` builds the full discrete-event pipeline simulation
on top of ``VirtualClock``; this module holds only the seam itself so the
runtime has no test-directory dependency.
"""

from __future__ import annotations

import threading
import time


class Clock:
    """Monotonic-time source. ``monotonic()`` returns seconds as a float
    (comparable only against the same clock); ``sleep(s)`` passes time."""

    def monotonic(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class SystemClock(Clock):
    """Wall-clock implementation: ``time.monotonic`` / ``time.sleep``."""

    monotonic = staticmethod(time.monotonic)
    sleep = staticmethod(time.sleep)


#: process-wide default; components take ``clock=None`` and fall back here
SYSTEM_CLOCK = SystemClock()


class VirtualClock(Clock):
    """Logical clock for deterministic tests: ``monotonic()`` returns the
    current logical time, which only moves via ``advance`` (or ``sleep``,
    which advances instead of blocking).  Thread-safe, so runtime threads
    reading timestamps while a test advances time never tear a read."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()

    def monotonic(self) -> float:
        with self._lock:
            return self._now

    def advance(self, seconds: float) -> float:
        """Move logical time forward by ``seconds`` (never backward)."""
        with self._lock:
            self._now += max(0.0, float(seconds))
            return self._now

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)
