"""Traffic mode ``etl``: the fitted ``EtlJob``'s executor alone.  The
consumer takes each delivered batch (its stream waits on the batch's
event, as a trainer's would) and drops it; set-up takes
``setup_batches`` batches first, the window then counts the batches
delivered until its time is up and ends in a device synchronize."""

from __future__ import annotations

import time

from etlbench import drive
from etlbench.devtrace import profiled, summarize


def run(r) -> None:
    drive.prepare(r)
    sample = drive.Sample(int(r.traffic["check_batches"]), r.seed)
    with r.job.batches() as ex:
        feed = drive.Feed(ex)
        for batch in feed.take(int(r.traffic["setup_batches"])):
            if feed.index < len(r.pool):
                r.keep(feed.index, batch)
        del batch
        r.setup_done()
        st = ex.stats.stages["transform"]
        busy0, items0, drop0 = st.busy_s, st.items, ex.stats.dropped_stale
        n = 0
        t_start = time.perf_counter()
        with profiled(r.trace) as prof:
            for batch in feed.until(t_start + r.seconds):
                sample.offer(feed.index, batch)
                n += 1
            r.sync()
            window_s = time.perf_counter() - t_start
        r.readings.update(window_s=window_s, delivered=n,
                          transform_busy_s=st.busy_s - busy0,
                          transform_items=st.items - items0)
        r.failed = ex.stats.dropped_stale - drop0
    if prof is not None:
        r.summary = summarize(prof, window_s)
    for index, batch in sample.kept:
        r.keep(index, batch)
    sample.kept.clear()
    r.attempted = n
    r.e2e["etl_rows_per_s"] = n * r.rows / window_s
