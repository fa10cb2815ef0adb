"""Self-tuning pipeline controller: one owner for every runtime knob.

A copy of the JAX package's controller (pure Python; the port imports
nothing of that package).  Under the same seed it takes the same decisions.

The paper's end-to-end win depends on the ETL stages being balanced
against the training consumer; before this module that balance was spread
across hand-tuned knobs (staging credits, prefetch depth, the planner's
row tile, per-output fuse decisions, the lookahead window) plus one
ad-hoc actuator (the executor's adaptive-credits rule).  The
``PipelineController`` unifies them behind a declared-knob interface and
a single sensor → decision → actuator loop:

- **sensor**: per-delivery observations (trainer wait, ready-queue
  fullness) aggregated into epoch-aligned observation windows, each
  yielding one measured throughput sample (batches/sec on the injected
  ``Clock``).
- **decision**: per window, in priority order —

  1. *memory-pressure guard*: when the host-memory-pressure callable
     crosses the threshold, the optimizer is preempted (any in-flight
     probe is reverted) and queue-bytes knobs shrink first, largest
     estimated footprint first; compute knobs shrink only once every
     queue knob sits at its floor.
  2. *occupancy rule* (``mode="occupancy"``, the adaptive-credits
     successor): grow credits when the trainer starved on at least half
     the window's deliveries, shrink when the window saw zero starvation
     and every pop found the queue full — with hysteresis: reversing
     direction within ``hysteresis`` windows of the last resize is
     suppressed, so adjacent grow/shrink thresholds cannot oscillate.
  3. *hill climber* (``mode="throughput"``): seeded coordinate search
     over the declared knobs.  One knob moves one candidate step per
     window; the next window's measured throughput accepts the move
     (improvement beyond ``tolerance``) or reverts it.  An accepted move
     keeps climbing the same direction; a revert flips direction, and a
     knob dead in both directions is retired until a regime change
     (throughput drifting >10% off the converged baseline) reopens the
     search.

- **actuator**: each ``Knob`` carries its own apply callback (executor
  ``set_credits``/``set_prefetch_depth``/``set_lookahead_window``,
  ``EtlJob``'s recompile-and-swap for ``row_tile``/fuse, or a plain dict
  write in simulation).

Every decision is recorded (``decisions`` / ``decision_counts()``) and
every knob's live value is exported (``knob_values()``) — surfaced as
Prometheus gauges by ``etl_runtime.metrics``.  The loop is deterministic
under a fixed seed; ``tests/torch_simclock.py`` drives it against a simulated
pipeline so convergence tests run in milliseconds.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Optional

from repro_torch.etl_runtime.clock import SYSTEM_CLOCK, Clock

#: deliveries per occupancy-mode decision window (the legacy
#: adaptive-credits cadence; kept so pinned resize counters are exact)
OCCUPANCY_WINDOW = 4

#: a delivery that waited longer than this counts as trainer starvation
STARVED_EPS_S = 1e-3


@dataclasses.dataclass
class Knob:
    """One declared tunable: ordered candidate values + an actuator.

    ``candidates`` is the knob's legal domain in search order (ascending
    for numeric knobs); bounds are ``candidates[0]`` / ``candidates[-1]``
    and the controller never applies a value outside them.  ``kind`` is
    ``"queue"`` for knobs whose value holds batches in host/device memory
    (credits, prefetch depth, lookahead window) — the memory-pressure
    guard shrinks those first — and ``"compute"`` otherwise (row tile,
    fuse).  ``bytes_per_unit`` estimates queued bytes per unit of a
    numeric queue knob's value.
    """

    name: str
    candidates: tuple
    value: object = None
    apply: Optional[Callable] = None   # actuator: apply(value) -> None
    get: Optional[Callable] = None     # live read-back (defaults to .value)
    kind: str = "compute"              # "queue" | "compute"
    bytes_per_unit: int = 0

    def __post_init__(self):
        self.candidates = tuple(self.candidates)
        if not self.candidates:
            raise ValueError(f"knob {self.name!r} has no candidates")
        if self.value is None:
            self.value = self.candidates[0]
        if self.value not in self.candidates:
            raise ValueError(f"knob {self.name!r} initial value "
                             f"{self.value!r} not in candidates")

    def read(self):
        """Current live value (via ``get`` when bound, else the tracked
        one); clamped into the candidate domain."""
        v = self.get() if self.get is not None else self.value
        return v if v in self.candidates else min(
            self.candidates, key=lambda c: abs(_num(c) - _num(v)))

    def set(self, value) -> None:
        if value not in self.candidates:
            raise ValueError(f"knob {self.name!r}: {value!r} out of bounds")
        self.value = value
        if self.apply is not None:
            self.apply(value)

    def index(self) -> int:
        return self.candidates.index(self.read())

    def queued_bytes(self) -> int:
        """Estimated host/device bytes this knob's current value pins."""
        if self.kind != "queue":
            return 0
        v = self.read()
        return int(self.bytes_per_unit * (_num(v)))


def _num(v) -> float:
    """Numeric view of a knob value (bools/ints/floats pass through;
    anything else ranks by identity-ish hash — only used for clamping)."""
    if isinstance(v, (bool, int, float)):
        return float(v)
    return float(abs(hash(v)) % (1 << 16))


@dataclasses.dataclass
class Decision:
    """One controller action, for tests/metrics: what moved, when, why."""

    window: int
    knob: str
    action: str  # probe | accept | revert | grow | shrink | pressure-shrink
    value: object

    def as_tuple(self) -> tuple:
        return (self.window, self.knob, self.action, self.value)


class PipelineController:
    """Measured-throughput knob search with a memory-pressure guard.

    Parameters
    ----------
    knobs : declared ``Knob`` list (may be empty and bound later via
        ``bind_executor`` — the ``autotune=`` path).
    mode : ``"throughput"`` (hill climber over windowed throughput) or
        ``"occupancy"`` (the adaptive-credits successor: starvation/
        fullness rule over the first — usually only — knob).
    clock : timing source for window throughput; defaults to the system
        clock and adopts the executor's clock on ``bind_executor``.
    seed : RNG seed; the search is bit-deterministic under a fixed seed.
    window_deliveries : deliveries per observation window in
        ``on_delivery``-driven (real-runtime) operation.
    tolerance : relative throughput gain a probe must show to be accepted.
    hysteresis : minimum windows between direction-reversing resizes
        (occupancy mode's oscillation damper).
    memory_pressure : optional callable -> [0, 1] host-memory pressure,
        polled every window; ``pressure_threshold`` arms the guard.
    """

    def __init__(self, knobs: Optional[list] = None, *,
                 mode: str = "throughput",
                 clock: Optional[Clock] = None, seed: int = 0,
                 window_deliveries: int = 8, tolerance: float = 0.02,
                 hysteresis: int = 2,
                 memory_pressure: Optional[Callable[[], float]] = None,
                 pressure_threshold: float = 0.9,
                 starved_eps_s: float = STARVED_EPS_S):
        if mode not in ("throughput", "occupancy"):
            raise ValueError(f"unknown controller mode {mode!r}")
        self.knobs: list[Knob] = list(knobs or [])
        self.mode = mode
        self.clock = clock or SYSTEM_CLOCK
        self.seed = seed
        self.rng = random.Random(seed)
        self.window_deliveries = max(1, window_deliveries)
        self.tolerance = tolerance
        self.hysteresis = max(0, hysteresis)
        self.memory_pressure = memory_pressure
        self.pressure_threshold = pressure_threshold
        self.starved_eps_s = starved_eps_s
        self.decisions: list[Decision] = []
        self.suppressed_flips = 0      # hysteresis-suppressed reversals
        # per-delivery accumulation (real-runtime sensor)
        self._deliveries: list[tuple] = []   # (wait_s, ready_full)
        self._window_t0: Optional[float] = None
        # window counter + hill-climber state
        self._window = 0
        self._baseline: Optional[float] = None
        self._probe: Optional[tuple] = None       # (Knob, old_value)
        self._dir: dict[str, int] = {}
        self._flipped: dict[str, bool] = {}
        self._exhausted: set[str] = set()
        self._cursor = 0
        self._cursor_init = False
        self._best: Optional[tuple] = None        # (tput, {name: value})
        # occupancy-mode resize bookkeeping (hysteresis)
        self._last_resize_window: Optional[int] = None
        self._last_resize_dir = 0

    # ---- construction helpers -------------------------------------------

    @classmethod
    def for_executor(cls, executor, *, seed: int = 0,
                     window_deliveries: int = 8,
                     memory_pressure: Optional[Callable[[], float]] = None,
                     batch_bytes: int = 1 << 20,
                     **kw) -> "PipelineController":
        """Throughput-mode controller over an executor's runtime knobs."""
        ctrl = cls([], mode="throughput", clock=executor.clock, seed=seed,
                   window_deliveries=window_deliveries,
                   memory_pressure=memory_pressure, **kw)
        ctrl.bind_executor(executor, batch_bytes=batch_bytes)
        return ctrl

    @classmethod
    def adaptive_credits(cls, executor, *, hysteresis: int = 2,
                         memory_pressure: Optional[Callable[[], float]] = None
                         ) -> "PipelineController":
        """The ``adaptive_credits=True`` compatibility controller: the
        legacy occupancy rule (same thresholds, same 4-delivery window)
        on the credits knob only, plus hysteresis against grow/shrink
        oscillation.  Floor = the configured ``credits``, ceiling =
        ``max_credits`` — resize counters land in the executor's stats
        exactly as before."""
        lo, hi = executor.credits, executor.max_credits
        knob = Knob("credits", tuple(range(lo, hi + 1)),
                    value=min(max(executor.current_credits, lo), hi),
                    apply=executor.set_credits,
                    get=lambda: executor.current_credits,
                    kind="queue")
        return cls([knob], mode="occupancy", clock=executor.clock,
                   window_deliveries=OCCUPANCY_WINDOW,
                   hysteresis=hysteresis, memory_pressure=memory_pressure)

    def bind_executor(self, executor, *, batch_bytes: int = 1 << 20) -> None:
        """Attach executor-owned knobs (credits, prefetch depth, lookahead
        window) unless the caller already declared knobs with those names;
        adopts the executor's clock.  Called by ``StreamingExecutor`` when
        a controller instance is passed as ``autotune=``."""
        self.clock = executor.clock
        have = {k.name for k in self.knobs}
        n_queues = len(executor.stage_queues())
        if "credits" not in have:
            self.knobs.append(Knob(
                "credits", tuple(range(1, executor.max_credits + 1)),
                value=executor.current_credits,
                apply=executor.set_credits,
                get=lambda: executor.current_credits,
                kind="queue", bytes_per_unit=batch_bytes * n_queues))
        if "prefetch_depth" not in have:
            cands = tuple(sorted({1, 2, 4, executor.max_credits}))
            depth = min(cands, key=lambda c: abs(c - executor.credits))
            self.knobs.append(Knob(
                "prefetch_depth", cands, value=depth,
                apply=executor.set_prefetch_depth,
                kind="queue", bytes_per_unit=batch_bytes))
        if executor.lookahead is not None and "lookahead_window" not in have:
            w = max(1, executor.lookahead.window)
            cands = tuple(sorted({w, 2, 4, 8, 16}))
            self.knobs.append(Knob(
                "lookahead_window", cands, value=w,
                apply=executor.set_lookahead_window,
                kind="queue", bytes_per_unit=batch_bytes))

    # ---- sensors ---------------------------------------------------------

    def on_delivery(self, *, wait_s: float, ready_full: bool,
                    now: Optional[float] = None) -> list:
        """Per-delivery hook (the executor calls this from the consumer
        side).  Aggregates ``window_deliveries`` deliveries into one
        observation window and runs the decision step at each boundary.
        Returns the decisions taken (usually empty)."""
        now = self.clock.monotonic() if now is None else now
        if self._window_t0 is None:
            self._window_t0 = now - wait_s  # window opens at first wait
        self._deliveries.append((wait_s, ready_full))
        if len(self._deliveries) < self.window_deliveries:
            return []
        span = max(now - self._window_t0, 1e-9)
        throughput = len(self._deliveries) / span
        starved = sum(1 for w, _ in self._deliveries
                      if w > self.starved_eps_s)
        always_full = all(f for _, f in self._deliveries)
        self._deliveries.clear()
        self._window_t0 = now
        return self.observe_window(throughput, starved=starved,
                                   always_full=always_full)

    # ---- decision loop ---------------------------------------------------

    def observe_window(self, throughput: float, *, starved: int = 0,
                       always_full: bool = False) -> list:
        """One observation window: run the guard + the mode's policy.

        ``throughput`` is the window's measured delivery rate;
        ``starved``/``always_full`` feed the occupancy rule.  Returns the
        decisions taken this window (also appended to ``decisions``)."""
        self._window += 1
        out: list[Decision] = []
        if self._pressure_step(out):
            self.decisions.extend(out)
            return out
        if self.mode == "occupancy":
            self._occupancy_step(out, starved=starved,
                                 always_full=always_full)
        else:
            self._climb_step(out, throughput)
        self.decisions.extend(out)
        return out

    # -- memory-pressure guard --------------------------------------------

    def _pressure_step(self, out: list) -> bool:
        if self.memory_pressure is None:
            return False
        if self.memory_pressure() < self.pressure_threshold:
            return False
        # preempt the optimizer: an in-flight probe is reverted first so
        # the shrink below starts from known-good settings
        if self._probe is not None:
            knob, old = self._probe
            knob.set(old)
            out.append(Decision(self._window, knob.name, "revert", old))
            self._probe = None
            self._baseline = None  # re-measure once pressure clears
        # queue-bytes knobs first, largest estimated footprint first
        qknobs = [k for k in self.knobs
                  if k.kind == "queue" and k.index() > 0]
        qknobs.sort(key=lambda k: (-k.queued_bytes(), k.name))
        targets = qknobs or [k for k in self.knobs
                             if k.kind != "queue" and k.index() > 0]
        for k in targets:
            k.set(k.candidates[k.index() - 1])
            out.append(Decision(self._window, k.name, "pressure-shrink",
                                k.value))
        return True

    # -- occupancy rule (adaptive-credits successor) -----------------------

    def _occupancy_step(self, out: list, *, starved: int,
                        always_full: bool) -> None:
        knob = self.knobs[0]
        cur = knob.read()
        idx = knob.candidates.index(cur)
        want = 0
        if (starved >= self.window_deliveries // 2
                and idx < len(knob.candidates) - 1):
            want = 1
        elif starved == 0 and always_full and idx > 0:
            want = -1
        if want == 0:
            return
        # hysteresis: a direction reversal within the damper window is
        # suppressed — adjacent grow/shrink thresholds cannot ping-pong
        if (self._last_resize_dir and want != self._last_resize_dir
                and self._last_resize_window is not None
                and self._window - self._last_resize_window <= self.hysteresis):
            self.suppressed_flips += 1
            return
        knob.set(knob.candidates[idx + want])
        out.append(Decision(self._window, knob.name,
                            "grow" if want > 0 else "shrink", knob.value))
        self._last_resize_dir = want
        self._last_resize_window = self._window

    # -- throughput hill climber ------------------------------------------

    def _climb_step(self, out: list, throughput: float) -> None:
        if self._baseline is None:
            # settle window: measure before moving anything
            self._baseline = throughput
            self._note_best(throughput)
            self._begin_probe(out)
            return
        if self._probe is None:
            # converged (every knob retired): hold, but watch for a
            # regime change — >10% drift reopens the search
            self._note_best(throughput)
            if abs(throughput - self._baseline) > 0.10 * self._baseline:
                self._baseline = throughput
                self._exhausted.clear()
                self._flipped.clear()
            self._begin_probe(out)
            return
        knob, old = self._probe
        self._probe = None
        if throughput > self._baseline * (1.0 + self.tolerance):
            out.append(Decision(self._window, knob.name, "accept",
                                knob.value))
            self._baseline = throughput
            self._note_best(throughput)
            self._flipped[knob.name] = False  # keep climbing this way
        else:
            knob.set(old)
            out.append(Decision(self._window, knob.name, "revert", old))
            if self._flipped.get(knob.name):
                self._exhausted.add(knob.name)
                self._cursor += 1
            else:
                self._flipped[knob.name] = True
                self._dir[knob.name] = -self._dir.get(knob.name, 1)
        self._begin_probe(out)

    def _begin_probe(self, out: list) -> None:
        if not self.knobs:
            return
        if not self._cursor_init:
            # seeded start: which knob the search opens with is the RNG's
            # only job — every later step is order-deterministic
            self._cursor = self.rng.randrange(len(self.knobs))
            self._cursor_init = True
        for _ in range(len(self.knobs)):
            knob = self.knobs[self._cursor % len(self.knobs)]
            if (knob.name in self._exhausted
                    or len(knob.candidates) < 2):
                self._cursor += 1
                continue
            idx = knob.index()
            d = self._dir.setdefault(knob.name, 1)
            if not 0 <= idx + d < len(knob.candidates):
                if self._flipped.get(knob.name):
                    self._exhausted.add(knob.name)
                    self._cursor += 1
                    continue
                self._flipped[knob.name] = True
                d = self._dir[knob.name] = -d
                if not 0 <= idx + d < len(knob.candidates):
                    self._exhausted.add(knob.name)
                    self._cursor += 1
                    continue
            old = knob.candidates[idx]
            knob.set(knob.candidates[idx + d])
            self._probe = (knob, old)
            out.append(Decision(self._window, knob.name, "probe",
                                knob.value))
            return
        self._probe = None  # everything retired: converged

    def _note_best(self, throughput: float) -> None:
        if self._best is None or throughput > self._best[0]:
            self._best = (throughput, self.knob_values())

    # ---- observability / restore ----------------------------------------

    def knob_values(self) -> dict:
        return {k.name: k.read() for k in self.knobs}

    def decision_counts(self) -> dict:
        counts: dict[str, int] = {}
        for d in self.decisions:
            counts[d.action] = counts.get(d.action, 0) + 1
        return counts

    def total_queued_bytes(self) -> int:
        """Estimated bytes pinned by queue-kind knobs at current values."""
        return sum(k.queued_bytes() for k in self.knobs)

    def best_settings(self) -> Optional[dict]:
        """Knob values of the best window observed so far (None before
        the first measurement)."""
        return dict(self._best[1]) if self._best is not None else None

    def restore_best(self) -> dict:
        """Apply the best-known settings (reverting any in-flight probe)
        and return them — call at the end of a tuning run so the pipeline
        never finishes on a worse-than-start probe."""
        if self._probe is not None:
            knob, old = self._probe
            knob.set(old)
            self._probe = None
        best = self.best_settings()
        if best:
            for k in self.knobs:
                if k.name in best and k.read() != best[k.name]:
                    k.set(best[k.name])
        return best or self.knob_values()

    @property
    def window(self) -> int:
        return self._window

    def decision_log(self) -> list[tuple]:
        """The full decision history as plain tuples (determinism pin)."""
        return [d.as_tuple() for d in self.decisions]
