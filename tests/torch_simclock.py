"""Deterministic virtual-clock simulation harness for the port's runtime.

The twin of ``tests/simclock.py`` over ``repro_torch``'s ``VirtualClock``
and ``Knob`` (the same recurrence and workload, line for line), so the
port's controller tests import nothing of the JAX package.

Timing-dependent behavior (overlap margins, credit backpressure, the
self-tuning controller's observation windows) is untestable with wall-clock
sleeps: every margin is a race.  This module provides the thread-free
counterpart of ``StreamingExecutor``'s staged pipeline — a blocking-pipeline
recurrence over simulated per-item stage costs on a logical clock — so tests
compute exact makespans, utilizations and starvation patterns in
microseconds, bit-reproducibly.

- ``VirtualClock`` (re-exported from ``repro_torch.etl_runtime.clock``): the seam
  the real runtime accepts via ``clock=``; tests that drive actual executor
  threads inject it so ``StageStats`` timers read logical time.
- ``SimPipeline``: the analytic pipeline model.  Stage ``j`` mirrors a
  runtime stage thread (get → busy → put) feeding a credit queue of bounded
  capacity; the last implicit stage is the consumer.  The recurrence
  captures both starvation (consumer waits on an empty ready queue) and
  backpressure (a stage blocks its put until the downstream queue frees a
  credit), so ``throughput(settings)`` is exact, not sampled.
- ``SimWorkload``: the sweep-grid workload the controller convergence tests
  tune over — knob settings (credits, prefetch depth, row tile, fuse) map
  to deterministic stage costs; ``optimum()`` is the exhaustive sweep the
  acceptance criterion compares against.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional, Sequence

from repro_torch.etl_runtime.clock import VirtualClock  # noqa: F401
from repro_torch.etl_runtime.controller import Knob


def _cost_fn(c) -> Callable[[int], float]:
    return c if callable(c) else (lambda i, v=float(c): v)


@dataclasses.dataclass
class SimResult:
    """One simulated run: absolute times plus the derived signals tests
    assert on (all in logical seconds)."""

    makespan: float
    throughput: float            # items delivered per logical second
    consumer_waits: list         # per-delivery starvation wait
    consumer_busy_s: float       # total simulated train time
    stage_busy_s: list           # per-stage total busy time

    @property
    def utilization(self) -> float:
        """Trainer utilization: train time over total wall (logical)."""
        return self.consumer_busy_s / self.makespan if self.makespan else 0.0

    def starved(self, eps: float = 1e-9) -> int:
        return sum(1 for w in self.consumer_waits if w > eps)


class SimPipeline:
    """Blocking-pipeline recurrence over per-item stage costs.

    ``stage_costs``: one cost per ETL stage (float, or ``fn(i) -> float``),
    in pipeline order (e.g. read, transform, place).  ``capacities``: the
    credit-queue capacity downstream of each stage (the runtime sizes all
    of them from one credits budget; pass per-stage values to model the
    prefetch-depth knob separately).  ``consumer_cost``: the train step.

    Per item ``i`` and stage ``j`` (get → busy → put, exactly the runtime's
    stage loop):

        pop[j][i]  = max(put[j-1][i], put[j][i-1])          # get blocks
        busy_done  = pop[j][i] + cost[j](i)
        put[j][i]  = max(busy_done, pop[j+1][i - cap[j]])   # put blocks

    The put term is credit backpressure: the queue between ``j`` and
    ``j+1`` holds ``cap[j]`` items, so item ``i`` cannot be inserted until
    the consumer side popped item ``i - cap[j]``.  The consumer is the
    final stage; its pop-minus-previous-finish gaps are the starvation
    waits the adaptive-credits rule feeds on.
    """

    def __init__(self, stage_costs: Sequence, capacities: Sequence[int],
                 consumer_cost):
        if len(stage_costs) != len(capacities):
            raise ValueError("one capacity per stage (its downstream queue)")
        self.costs = [_cost_fn(c) for c in stage_costs]
        self.caps = [max(1, int(c)) for c in capacities]
        self.consumer = _cost_fn(consumer_cost)

    def run(self, n_items: int) -> SimResult:
        S = len(self.costs)
        # pop[j][i] / put[j][i]; consumer is stage S (pop = delivery start,
        # put = train-step finish)
        pop = [[0.0] * n_items for _ in range(S + 1)]
        put = [[0.0] * n_items for _ in range(S + 1)]
        busy = [0.0] * (S + 1)
        waits = []
        for i in range(n_items):
            # stage order ascending: pop[j] needs put[j-1] of the SAME item
            # (computed just before), the backpressure term needs pop[j+1]
            # of item i - cap[j] (strictly earlier, already computed)
            for j in range(S + 1):
                upstream = put[j - 1][i] if j > 0 else 0.0
                prev = put[j][i - 1] if i > 0 else 0.0
                pop[j][i] = max(upstream, prev)
                cost = (self.consumer(i) if j == S else self.costs[j](i))
                done = pop[j][i] + cost
                if j < S and i - self.caps[j] >= 0:
                    done = max(done, pop[j + 1][i - self.caps[j]])
                put[j][i] = done
                busy[j] += cost
            prev_done = put[S][i - 1] if i > 0 else 0.0
            waits.append(max(0.0, pop[S][i] - prev_done))
        makespan = put[S][n_items - 1] if n_items else 0.0
        return SimResult(makespan=makespan,
                         throughput=n_items / makespan if makespan else 0.0,
                         consumer_waits=waits,
                         consumer_busy_s=busy[S],
                         stage_busy_s=busy[:S])


class SimWorkload:
    """The simulated sweep grid for controller convergence tests.

    Stage model (logical seconds per batch): a read stage whose cost drops
    with prefetch depth, a transform whose cost has an interior row-tile
    optimum (``a/r + b*r``: small tiles pay per-tile overhead, big tiles
    spill) with a fuse multiplier that helps everywhere EXCEPT the largest
    tile (the budget-fallback interaction — fused 512-row tiles fall back
    staged), plus a periodic transform spike every ``spike_every`` batches
    that deeper credits absorb.  The consumer is a constant train step.

    Every cost is a pure function of (settings, batch index): the sweep in
    ``optimum()`` and the controller's probes see identical numbers, so
    "within 10% of the exhaustive optimum" is an exact assertion.
    """

    GRID = {
        "credits": (1, 2, 3, 4, 5, 6, 7, 8),
        "prefetch_depth": (1, 2, 4, 8),
        "row_tile": (64, 128, 256, 512),
        "fuse": (False, True),
    }
    DEFAULTS = {"credits": 2, "prefetch_depth": 1,
                "row_tile": 64, "fuse": False}

    def __init__(self, n_batches: int = 48, *, train_cost: float = 1.0,
                 spike_every: int = 7, spike_mult: float = 6.0):
        self.n_batches = n_batches
        self.train_cost = train_cost
        self.spike_every = spike_every
        self.spike_mult = spike_mult
        self.settings = dict(self.DEFAULTS)

    # -- cost model --------------------------------------------------------

    def _transform_cost(self, s: dict) -> Callable[[int], float]:
        r = s["row_tile"]
        base = 0.35 * (256.0 / r) + 0.0022 * r
        if s["fuse"]:
            base *= 1.05 if r >= 512 else 0.60
        every, mult = self.spike_every, self.spike_mult

        def cost(i: int) -> float:
            return base * (mult if every and (i % every == every - 1)
                           else 1.0)
        return cost

    def pipeline(self, settings: Optional[dict] = None) -> SimPipeline:
        s = dict(self.DEFAULTS, **(settings or self.settings))
        read = 0.25 + 1.2 / (1 + s["prefetch_depth"])
        place = 0.30
        caps = [max(s["credits"], s["prefetch_depth"]),
                s["credits"], s["credits"]]
        return SimPipeline([read, self._transform_cost(s), place],
                           caps, self.train_cost)

    def throughput(self, settings: Optional[dict] = None) -> float:
        return self.pipeline(settings).run(self.n_batches).throughput

    # -- exhaustive sweep (the acceptance baseline) ------------------------

    def optimum(self) -> tuple:
        """(best throughput, best settings) over the full grid."""
        best, best_s = -1.0, None
        names = sorted(self.GRID)
        for combo in itertools.product(*(self.GRID[n] for n in names)):
            s = dict(zip(names, combo))
            t = self.throughput(s)
            if t > best:
                best, best_s = t, s
        return best, best_s

    # -- controller binding ------------------------------------------------

    def make_knobs(self, *, batch_bytes: int = 1 << 20) -> list:
        """Declared knobs whose actuators write ``self.settings`` — the
        simulation counterpart of the executor/EtlJob apply hooks."""

        def setter(name):
            def apply(v, name=name):
                self.settings[name] = v
            return apply

        n_queues = 3
        return [
            Knob("credits", self.GRID["credits"],
                 value=self.settings["credits"], apply=setter("credits"),
                 kind="queue", bytes_per_unit=batch_bytes * n_queues),
            Knob("prefetch_depth", self.GRID["prefetch_depth"],
                 value=self.settings["prefetch_depth"],
                 apply=setter("prefetch_depth"),
                 kind="queue", bytes_per_unit=batch_bytes),
            Knob("row_tile", self.GRID["row_tile"],
                 value=self.settings["row_tile"], apply=setter("row_tile"),
                 kind="compute"),
            Knob("fuse", self.GRID["fuse"],
                 value=self.settings["fuse"], apply=setter("fuse"),
                 kind="compute"),
        ]
