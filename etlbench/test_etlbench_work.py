"""The yardstick's arithmetic against the counts PERF.md's kernel table
was measured with (B = 65,536), and each configuration's model FLOPs."""

from __future__ import annotations

import numpy as np
import pytest

from etlbench import work
from etlbench.conftest import load

B = 65536


@pytest.mark.parametrize("row,got,want", [
    ("1", lambda: work.dataflow_bytes(B, 264, 196, 4 * 524288), 32243712),
    ("1a", lambda: work.dataflow_bytes(B, 56, 68), 8126464),
    ("3", lambda: work.fit_bytes(B, 26, 8, 524288), 17825792),
    ("4", lambda: work.stage_bytes(B, 26, 8), 20447232),
    ("5", lambda: work.packer_bytes(B, 26, 32), 15204352),
    ("6", lambda: work.build_bytes(B, 26, 4194304), 23592960),
    ("7", lambda: work.lookup_bytes(B, 26, 83876), 13966992),
])
def test_kernel_bytes_match_the_kernel_table(row, got, want):
    assert got() == want, row


def test_lowerings_name_their_kernels():
    grouped = work.etl_kernels(load("configs", "dlrm_mlperf"), B, 0)
    assert grouped == {"apply_kernel": (32243712, grouped["apply_kernel"][1])}
    staged = work.etl_kernels(load("configs", "dlrm_kaggle"), B, 83876)
    assert {k: v[0] for k, v in staged.items()} == {
        "apply_kernel": 8126464, "stage_kernel": 20447232,
        "lookup_kernel": 13966992, "packer_kernel": 15204352}


@pytest.mark.parametrize("name,flops,params", [
    # 3 x (2 x (MLP products) + 2 x 128 x 351 pairs)
    ("dlrm_mlperf", 3 * (2 * 2366720 + 2 * 128 * 351),
     26 * 524289 * 128 + 2366720 + 3713),
    ("dlrm_kaggle", 3 * (2 * 475904 + 2 * 16 * 351),
     26 * 4194305 * 16 + 475904 + 1617),
])
def test_step_flops_and_parameters(name, flops, params):
    shape = work.model_shape(load("configs", name))
    assert work.step_flops_per_row(shape) == flops
    assert sum(work.param_counts(shape)) == params
    least = work.step_least_bytes(shape, B)
    assert least > 32 * params  # AdamW's 28 B and the table gradient's 4


def test_roofline_bound_takes_the_larger_term():
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 67e12) == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["dlrm_mlperf", "dlrm_kaggle"])
def test_ids_lie_within_each_features_cardinality(name):
    from etlbench import gen, reference

    cfg = load("configs", name)
    cards = work.cardinalities(cfg)
    (raw,) = gen.batches(2 ** 33 + 1, 1, 1, 4096, load("traffic", "train"),
                         cards)
    ids = reference.sparse_ids(raw, len(cards), 2 ** 32)
    for i, card in enumerate(cards):
        seen = np.unique(ids[:, i])
        seen = seen[seen != 2 ** 31]          # the missing value
        assert seen.min() >= 1 and seen.max() <= card, (i, card)
    assert np.unique(ids[:, cards.index(3)]).size <= 4


def test_every_event_brings_new_ids():
    from etlbench import gen, reference

    cfg, traffic = load("configs", "dlrm_mlperf"), load("traffic", "online")
    cards, cap = work.cardinalities(cfg), int(cfg["max_ind_range"])
    pool = gen.batches(5, 1, 2, 2048, traffic, cards)
    fresh = gen.fresh_rows(5, 8, 128, traffic, cards)
    seen = np.zeros(cap, bool)
    for k in range(8):
        ids = reference.sparse_ids(gen.event(pool, fresh, k), 26, cap)
        assert not seen[ids].all(), k
        seen[ids] = True
