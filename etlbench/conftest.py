"""Fixtures of the benchmark's CPU tests: a configuration at a size a test
run holds (the published keys kept, the widths and rows cut), and the
card, decided inside a fixture."""

from __future__ import annotations

import copy
import json
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def tiny_config(name: str) -> dict:
    cfg = copy.deepcopy(load("configs", name))
    cfg["arch_sparse_feature_size"] = 8
    cfg["arch_mlp_bot"] = "13-16-8"
    cfg["arch_mlp_top"] = "16-8-1"
    cfg["max_ind_range"] = 1024
    cfg["assumed"]["vocab_capacity"] = 1024
    cfg["assumed"]["batch_rows"] = 128
    return cfg


def tiny_traffic(name: str) -> dict:
    tr = copy.deepcopy(load("traffic", name))
    tr["pool_batches"] = 3
    tr["fit_chunks"] = 2
    if "fresh_rows" in tr:
        tr["fresh_rows"] = 16
    return tr


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")
