"""% of the traced window the trainer waited for a delivered batch
(``RuntimeStats.consumer_wait_s``, host clock); layer: the executor."""


def read(run):
    r = run.readings
    if "consumer_wait_s" not in r or r["window_s"] <= 0:
        return None
    return 100.0 * r["consumer_wait_s"] / r["window_s"]
