"""The plain reference agrees with the program's own plain path (the CUDA
kernels' plain versions, on the CPU) at a small size: the fitted
vocabulary and every packed output of pipeline III bit for bit (dense
within two ulps of log1p), and three DLRM + AdamW steps from the
same weights.  This test is the one place the reference meets the
program in one process."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from etlbench import drive, gen, reference, work
from etlbench.conftest import tiny_config, tiny_traffic


@pytest.mark.parametrize("name", ["dlrm_mlperf", "dlrm_kaggle"])
def test_pipeline_iii_matches_the_plain_path(name):
    from repro_torch.core.pipeline import paper_pipeline

    cfg, traffic = tiny_config(name), tiny_traffic("etl")
    a, shape = cfg["assumed"], work.model_shape(cfg)
    fit = gen.batches(7, 0, 2, 300, traffic, work.cardinalities(cfg))
    raw = gen.batches(7, 1, 2, 300, traffic, work.cardinalities(cfg))
    cap = int(a["vocab_capacity"])
    plain = paper_pipeline("III", large_vocab=cap, batch_size=300).compile(
        "cuda", device="cpu")
    plain.fit(iter(fit))
    (table,) = plain.state.tables.values()
    want = reference.etl_fit(fit, shape["n_sparse"], cap)
    np.testing.assert_array_equal(np.asarray(table), want)
    for b in raw:
        got = {k: v.numpy() for k, v in plain(b).items()}
        ref = reference.etl_apply(
            b, want, n_dense=shape["n_dense"], n_sparse=shape["n_sparse"],
            dense_padded=shape["dense_padded"],
            sparse_padded=int(a["sparse_padded"]))
        np.testing.assert_array_equal(got["sparse"], ref["sparse"])
        np.testing.assert_array_equal(got["label"], ref["label"])
        # log1p in float32: numpy's and torch's differ by two ulps at most
        np.testing.assert_array_max_ulp(got["dense"], ref["dense"], maxulp=2)


def test_three_dlrm_steps_match_the_program():
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import dlrm
    from repro_torch.training import train_loop as tl

    torch.manual_seed(0)
    cfg, traffic = tiny_config("dlrm_mlperf"), tiny_traffic("train")
    a, s = cfg["assumed"], work.model_shape(cfg)
    fit = gen.batches(3, 0, 2, 256, traffic, work.cardinalities(cfg))
    raw = gen.batches(3, 1, 3, 256, traffic, work.cardinalities(cfg))
    table = reference.etl_fit(fit, s["n_sparse"], int(a["vocab_capacity"]))
    batches = [reference.etl_apply(
        b, table, n_dense=s["n_dense"], n_sparse=s["n_sparse"],
        dense_padded=s["dense_padded"],
        sparse_padded=int(a["sparse_padded"])) for b in raw]
    ref = reference.train_three(s, a, 3, batches, "cpu")

    model = dlrm.DLRM(dlrm.DLRMConfig(
        n_dense=s["n_dense"], n_sparse=s["n_sparse"],
        vocab_size=s["rows_per_table"], d_emb=s["d_emb"],
        bot_mlp=tuple(s["bot_mlp"]), top_mlp=tuple(s["top_mlp"]),
        dense_padded=s["dense_padded"]), device="cpu")
    made = {n: (i, f) for i, (n, _, f) in
            enumerate(reference.leaf_shapes(s))}
    params = dict(model.named_parameters())
    for n, p in params.items():
        reference.init_leaf(p.data, 3, *made[n])
    tcfg = TrainConfig(lr=a["lr"], weight_decay=a["weight_decay"],
                       beta1=a["beta1"], beta2=a["beta2"], eps=a["eps"],
                       max_grad_norm=a["max_grad_norm"])
    state = tl.TrainState.create(model, tcfg)
    step = tl.make_train_step(dlrm.loss_fn, tcfg)
    losses, grads = [], None
    for i, b in enumerate(batches):
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        if i == 0:
            grads = {n: float(torch.linalg.vector_norm(mm)) / (1 - a["beta1"])
                     for n, mm in zip(params, state.opt["m"])}
    prog = {"losses": losses, "grad_norms": grads,
            "change_norms": reference.change_norms(params, s, 3)}
    gaps = drive.train_checks(prog, ref)
    for k, v in gaps.items():
        assert v <= cfg["limits"][k] / 10, (k, v)
