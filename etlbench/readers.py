"""Reductions that more than one per-layer metric reads (each metric's own
file under ``metrics/`` says which).  Each returns None where the run has
nothing to read: no trace, or no kernel of the kind on its path."""

from __future__ import annotations

import numpy as np

from etlbench import reference, work
from etlbench.devtrace import kernel_time


def mean_distinct(run) -> float:
    """The mean number of distinct ids (after the modulus) a pool batch
    looks up: what a vocabulary lookup's gather reads."""
    cap = int(run.cfg["assumed"]["vocab_capacity"])
    return float(np.mean([np.unique(reference.sparse_ids(
        raw, run.shape["n_sparse"], cap)).size for raw in run.pool]))


def etl_kernel_roofline(run):
    """% : the ETL kernels' summed roofline bound over their summed device
    time in the window, by kernel name."""
    if run.summary is None:
        return None
    table = work.etl_kernels(run.cfg, run.rows, mean_distinct(run))
    bound = spent = 0.0
    for name, (nbytes, ops) in table.items():
        sec, launches = kernel_time(run.summary, name)
        if launches:
            bound += launches * work.bound_s(nbytes, ops)
            spent += sec
    return 100.0 * bound / spent if spent > 0 else None


def idle_share(run):
    """% of the traced window in which no kernel, copy or memset ran."""
    if run.summary is None or run.summary["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.summary["busy_s"] / run.summary["window_s"])
