"""Traffic mode ``train``: a closed loop.  The fitted ``EtlJob``'s
executor feeds ``train_loop`` with the DLRM step (``make_train_step`` over
``dlrm.loss_fn``, AdamW), one delivered batch a step.

Set-up builds the model with the benchmark's weights from the seed and
drives it through ``setup_steps`` steps of the window's own call and
feed, each on a different pool batch (``drive.first_steps``); the window
then goes on with the same state and executor.  After each window step a
CUDA event is recorded on the trainer's stream; the gaps between them
give ``step_gap_p95_ms`` and, averaged, the device's time a step
(``device_step_s``, which the trainer's per-layer metrics read).
"""

from __future__ import annotations

import math
import time

import torch

from etlbench import drive
from etlbench.devtrace import profiled, summarize


def run(r) -> None:
    from repro_torch.training import train_loop as tl

    drive.prepare(r)
    model, params, state, step = drive.build_trainer(r)
    loop = tl.LoopConfig(total_steps=1 << 62, log_every=0)
    losses: list = []
    timing = r.device.type == "cuda"
    events: list = []
    sample = drive.Sample(int(r.traffic["check_batches"]), r.seed)

    with r.job.batches() as ex:
        feed = drive.Feed(ex)

        def setup_step(st, batch):
            st, m = step(st, batch)
            losses.append(m["loss"])
            r.keep(feed.index, batch)
            return st, m

        def window_step(st, batch):
            st, m = step(st, batch)
            if timing:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
            sample.offer(feed.index, batch)
            losses.append(m["loss"])
            return st, m

        def one_step():
            nonlocal state
            state = tl.train_loop(state, setup_step, feed.take(1), loop,
                                  device=r.device, async_ckpt=False)

        drive.first_steps(r, params, lambda: state.opt, one_step, losses)
        r.setup_done()

        wait0 = ex.stats.consumer_wait_s
        step0 = state.step
        t_start = time.perf_counter()
        with profiled(r.trace) as prof:
            state = tl.train_loop(state, window_step,
                                  feed.until(t_start + r.seconds), loop,
                                  device=r.device, async_ckpt=False)
            r.sync()
            window_s = time.perf_counter() - t_start
        steps = state.step - step0
        r.readings.update(window_s=window_s, steps=steps,
                          consumer_wait_s=ex.stats.consumer_wait_s - wait0)
    if prof is not None:
        r.summary = summarize(prof, window_s)
    for index, batch in sample.kept:
        r.keep(index, batch)
    sample.kept.clear()
    r.attempted = steps
    r.failed = sum(not math.isfinite(float(x)) for x in losses)
    r.e2e["train_rows_per_s"] = steps * r.rows / window_s
    if len(events) >= 2:
        gaps = [events[i - 1].elapsed_time(events[i])
                for i in range(1, len(events))]
        r.e2e["step_gap_p95_ms"] = drive.percentile(gaps, 0.95)
        r.readings["device_step_s"] = 1e-3 * sum(gaps) / len(gaps)
    del model, state, params, step, events
