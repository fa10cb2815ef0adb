"""ms of host-to-device copies on the device a delivered batch (profiler
trace); layer: the handoff (``etl_runtime/transfer.py``)."""


def read(run):
    s = run.summary
    n = run.readings.get("delivered") or run.readings.get("steps")
    if s is None or not s["h2d_n"] or not n:
        return None
    return 1e3 * s["h2d_s"] / n
