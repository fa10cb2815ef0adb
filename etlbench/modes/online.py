"""Traffic mode ``online``: an open loop.  A producer thread of the
benchmark publishes events of ``batch_rows`` rows onto an ``EventBus`` at
``rate_hz``, each stamped with the time it was due on that schedule;
publishing never blocks.  Event ``k`` is pool batch ``k mod pool_batches``
with its first ``fresh_rows`` rows new (``gen.event``), so every refit
window brings ids the vocabulary has not seen; the producer makes the next
event while it waits for its due time.  An ``OnlineTrainer``
(incremental refits every ``refit_every`` steps over ``window_batches``
events, the freshness shedder at ``shed_max_staleness_s``) trains on them.

``event_age_p95_ms``: for every event due in the window, from its due time
to the end of the step that trained it (the host clock after the step's
loss has been read), the 95th percentile; an event shed, refused or not
trained by ``grace_s`` after the schedule's end counts in ``failed`` and beyond
any limit.

Set-up publishes ``setup_steps`` events one at a time and trains each
through the trainer's own ``run`` (``drive.first_steps``).  The refits are
read after the window from the trainer's own record of its states
(``OnlineTrainer.state_history``, in the order of ``stats.versions``); the
step function notes, at each step after which a refit runs, how many
events had been published and how many refits made (``drive.refit_checks``
works out each refit's window from them).
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np

from etlbench import drive, gen
from etlbench.devtrace import profiled, summarize


def run(r) -> None:
    from repro_torch.data.source import Source
    from repro_torch.online import EventBus, OnlineConfig, OnlineTrainer

    tr = r.traffic
    bus = EventBus(capacity=int(tr["bus_capacity"]))
    drive.prepare(r, Source.events(bus, "events"))
    model, params, state, step = drive.build_trainer(r)

    rate = float(tr["rate_hz"])
    r.fresh = gen.fresh_rows(
        r.seed, int(tr["setup_steps"]) + math.ceil(rate * r.seconds) + 1,
        int(tr["fresh_rows"]), tr, r.cards)
    r.phase("events")
    refit_every = int(tr["refit_every"])
    marks: list = []        # (events published, refits made) at refit steps
    due: dict = {}          # event -> due time (time.monotonic)
    event_of: dict = {}     # due time -> event
    trained: dict = {}      # event -> end of the step that trained it
    losses: list = []
    sample = drive.Sample(int(tr["check_batches"]), r.seed)
    setup = [True]

    published = [0]

    def publish(k: int, at: float, raw: dict) -> None:
        due[k], event_of[at] = at, k
        bus.publish("events", raw, arrival=at)
        published[0] = k + 1

    def step_fn(st, batch):
        st, m = step(st, batch)
        float(m["loss"])  # the trainer reads it too: the step has ended
        done = time.monotonic()
        k = event_of[trainer.executor.stats.delivered_arrivals[-1]]
        trained[k] = done
        if (trainer.stats.steps + 1) % refit_every == 0:
            marks.append((published[0], trainer.stats.swaps))
        losses.append(m["loss"])
        if setup[0]:
            r.keep(k, batch)
        else:
            sample.offer(k, batch)
        return st, m

    trainer = OnlineTrainer(r.job, state, step_fn, OnlineConfig(
        refit_every=refit_every,
        window_batches=int(tr["window_batches"]),
        shed_max_staleness_s=float(tr["shed_max_staleness_s"])),
        bus=bus, topic="events")

    def one_step():
        k = len(due)
        publish(k, time.monotonic(), r.raw(k))
        trainer.run(max_steps=k + 1)

    drive.first_steps(r, params, lambda: trainer.state.opt, one_step, losses)
    setup[0] = False
    r.setup_done()

    seconds = r.seconds
    k0 = len(due)
    stop = threading.Event()
    t_start = time.monotonic()

    def producer():
        j = 0
        while not stop.is_set():
            at = t_start + j / rate
            if at >= t_start + seconds:
                break
            raw = r.raw(k0 + j)
            wait = at - time.monotonic()
            if wait > 0 and stop.wait(wait):
                return
            publish(k0 + j, at, raw)
            j += 1
        # the window closes once every event due in it has been trained or
        # shed (else at grace_s past the schedule's end)
        while not stop.wait(0.01):
            done = sum(k in trained for k in range(k0, k0 + j))
            if done + trainer.executor.stats.dropped_stale >= j:
                trainer.stop()
                return

    thread = threading.Thread(target=producer, name="etlbench-producer")
    steps0 = trainer.stats.steps
    try:
        with profiled(r.trace) as prof:
            thread.start()
            trainer.run(deadline_s=seconds + float(tr["grace_s"]))
            r.sync()
            window_s = time.monotonic() - t_start
    finally:
        stop.set()
        if thread.ident is not None:
            thread.join(timeout=60.0)
        bus.close()
    if thread.is_alive():
        raise RuntimeError("the producer did not stop")
    if prof is not None:
        r.summary = summarize(prof, window_s)
    window = [k for k in due if k >= k0]
    ages = [trained[k] - due[k] if k in trained else math.inf
            for k in window]
    r.attempted = len(window)
    r.failed = sum(k not in trained for k in window)
    r.failed += sum(not math.isfinite(float(x)) for x in losses)
    p95 = drive.percentile(ages, 0.95) if ages else math.inf
    if math.isfinite(p95):
        r.e2e["event_age_p95_ms"] = 1e3 * p95
    ex = trainer.executor.stats
    r.readings.update(window_s=window_s, offered=len(window),
                      shed=ex.dropped_stale,
                      steps=trainer.stats.steps - steps0,
                      refits=trainer.stats.swaps,
                      refits_skipped=trainer.stats.refit_skipped)
    for index, batch in sample.kept:
        r.keep(index, batch)
    sample.kept.clear()
    r.program.update(
        refit_marks=marks, published=published[0],
        refit_tables=[np.asarray(table).copy() for v in trainer.stats.versions
                      for table in trainer.state_history[v].tables.values()])
    del model, state, params, step, trainer
