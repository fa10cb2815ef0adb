"""% : the ETL kernels' roofline bound over their device time in a
training window (``readers.etl_kernel_roofline``); layer: the kernels."""

from etlbench import readers


def read(run):
    return readers.etl_kernel_roofline(run)
