"""Shared helpers of the LM parity tests: the same reduced config in both
packages, and the port's module loaded with the JAX init's parameters
(exported through numpy, ``models/api.params_from_jax``).  Imports JAX:
only the tests use it (``chip_smoke.py`` imports ``torch_parity`` alone).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as rreg
from repro.models import api as rapi
from repro_torch.configs import registry as treg
from repro_torch.models import api

# every arch of the zoo (dense, MoE, VLM, SSM, hybrid, enc-dec)
PORTED = ["llama3_2_3b", "chatglm3_6b", "qwen3_32b", "llama3_405b",
          "mixtral_8x7b", "kimi_k2", "internvl2_2b", "mamba2_370m",
          "zamba2_2_7b", "whisper_base"]


def cfgs(arch: str, **kw) -> tuple:
    """(ref cfg, port cfg) at the reduced config, ``kw`` replaced in both
    (``capacity_factor`` in the MoE config)."""
    rcfg, tcfg = rreg.get_reduced(arch), treg.get_reduced(arch)
    if "capacity_factor" in kw:
        cf = kw.pop("capacity_factor")
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=cf))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=cf))
    return dataclasses.replace(rcfg, **kw), dataclasses.replace(tcfg, **kw)


def pair(arch: str, seed: int = 0, **kw) -> tuple:
    """(ref Model, ref params, port Model, port module) with equal
    parameters, on the CPU."""
    rcfg, tcfg = cfgs(arch, **kw)
    rmodel, tmodel = rapi.build_model(rcfg), api.build_model(tcfg)
    params = rmodel.init(jax.random.key(seed))
    module = tmodel.init(device="cpu")
    api.params_from_jax(module, jax.tree_util.tree_map(np.asarray, params))
    return rmodel, params, tmodel, module


def tokens(vocab: int, rows: int, seq: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, vocab, (rows, seq)).astype(np.int32)


def logits_close(want, got, compute: str) -> None:
    """float32 compute: rtol 1e-4 with an absolute floor of 1e-4 x the
    largest magnitude; bfloat16: 3e-2 x the largest (ROADMAP's LM
    tolerances)."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert want.shape == got.shape, (want.shape, got.shape)
    scale = float(np.abs(want).max())
    if compute == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
    else:
        assert float(np.abs(got - want).max()) <= 3e-2 * scale


def cache_close(rcache, tcache, compute: str) -> None:
    """Every cache leaf: same path, shape and dtype; integer leaves (the
    positions) bit-equal, float leaves within ``logits_close``'s
    tolerance."""
    leaves = jax.tree_util.tree_leaves_with_path(rcache)
    assert len(leaves) == len(_flat(tcache))
    for path, want in leaves:
        got = tcache
        for p in path:
            got = got[p.key]
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, path
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=str(path))
        else:
            logits_close(want, got, compute)


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    return [tree]


def jb(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def tb(b: dict) -> dict:
    return {k: torch.tensor(v) for k, v in b.items()}
