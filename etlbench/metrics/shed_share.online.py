"""% of the events offered in the window that the freshness shedder
dropped (``RuntimeStats.dropped_stale``); layer: the online service
(``online/service.py``, ``online/shed.py``)."""


def read(run):
    r = run.readings
    if not r.get("offered"):
        return None
    return 100.0 * r["shed"] / r["offered"]
