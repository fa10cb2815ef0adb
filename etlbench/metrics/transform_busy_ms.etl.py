"""ms of the executor's transform stage a batch over the traced window
(``StageStats["transform"].busy_s / items``, host clock: the dispatch of
the batch's copies and kernels, not their device time)."""


def read(run):
    r = run.readings
    if not r.get("transform_items"):
        return None
    return 1e3 * r["transform_busy_s"] / r["transform_items"]
