"""% : a training step's least bytes (``work.step_least_bytes``) over the
HBM bandwidth (3.35 TB/s), against the device's time a step: the mean gap
between the CUDA events recorded on the trainer's stream after each step
of the traced window (``device_step_s``); layer: the trainer."""

from etlbench import work


def read(run):
    step_s = run.readings.get("device_step_s")
    if run.summary is None or not step_s:
        return None
    return 100.0 * work.step_least_bytes(run.shape, run.rows) \
        / work.HBM_BYTES_PER_S / step_s
