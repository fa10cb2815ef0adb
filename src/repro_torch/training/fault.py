"""Fault tolerance: watchdog, restartable training, failure injection.

A copy of the JAX package's module (pure Python).

The 1000-node posture: node failures surface as (a) a hung collective (the
watchdog kills the step and the launcher restarts from the last committed
checkpoint), or (b) a clean process crash (the restart wrapper re-enters the
loop; checkpoint restore is elastic so the replacement topology may differ).
Straggler mitigation at the data layer lives in etl_runtime (reader timeout +
skip-and-refill); here we handle trainer-side hangs and crashes.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


class WatchdogTimeout(RuntimeError):
    pass


class Watchdog:
    """Arms a timer around each step; fires if a step exceeds the budget.

    On real hardware a hung all-reduce never returns — the watchdog thread
    raises in the coordinator so the launcher can tear down and restart.
    """

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self._deadline: Optional[float] = None
        self._fired = threading.Event()
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._stop = threading.Event()
        self._thread.start()

    def _run(self):
        while not self._stop.wait(0.05):
            with self._lock:
                dl = self._deadline
            if dl is not None and time.monotonic() > dl:
                self._fired.set()

    def arm(self):
        with self._lock:
            self._deadline = time.monotonic() + self.timeout_s
        self._fired.clear()

    def disarm(self):
        with self._lock:
            self._deadline = None

    def check(self):
        if self._fired.is_set():
            raise WatchdogTimeout(
                f"step exceeded {self.timeout_s}s watchdog budget")

    def close(self):
        self._stop.set()


@dataclass
class RestartStats:
    restarts: int = 0
    failures: list = field(default_factory=list)


def run_with_restarts(make_fn: Callable[[], Callable[[], None]],
                      max_restarts: int = 3,
                      retriable=(WatchdogTimeout, RuntimeError)) -> RestartStats:
    """Run fn() to completion, restarting after retriable failures.

    ``make_fn`` rebuilds the loop closure each attempt (fresh restore from the
    last committed checkpoint — the checkpoint/restart contract).
    """
    stats = RestartStats()
    attempt = 0
    while True:
        fn = make_fn()
        try:
            fn()
            return stats
        except retriable as e:
            stats.failures.append(repr(e))
            attempt += 1
            stats.restarts = attempt
            if attempt > max_restarts:
                raise
