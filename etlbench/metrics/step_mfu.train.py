"""% of the H100 SXM's float32 peak (67 TFLOP/s, the rate outside the
tensor cores, which applies with TF32 off) that the traced window's
training steps reach: the model FLOPs a row (``work.step_flops_per_row``)
times the rows a step, over the device's time a step (the mean gap
between the CUDA events recorded on the trainer's stream after each step,
``device_step_s``); layer: the trainer."""

from etlbench import work


def read(run):
    step_s = run.readings.get("device_step_s")
    if run.summary is None or not step_s:
        return None
    return 100.0 * work.step_flops_per_row(run.shape) * run.rows / step_s \
        / work.FP32_FLOPS_PER_S
