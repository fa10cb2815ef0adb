"""% of the traced window with no kernel, copy or memset on the device
(``readers.idle_share``; profiler trace); layer: the device."""

from etlbench import readers


def read(run):
    return readers.idle_share(run)
