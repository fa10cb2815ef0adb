"""Unified model API (the JAX package's ``models/api.py``): ``build_model(cfg)
-> Model`` with init / loss / forward entry points, ``input_specs`` per
shape cell, ``random_batch`` and ``params_from_jax``.

Ported: the dense and MoE families.  The others raise
``NotImplementedError`` naming their ROADMAP item (Queue A item 2: VLM,
SSM, hybrid, enc-dec).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import transformer

@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    init: Callable     # (seed=0, device=None) -> nn.Module
    loss: Callable     # (module, batch) -> scalar
    forward: Callable  # (module, batch) -> logits

    def init_cache(self, *args, **kwargs):
        transformer.not_ported("init_cache", "serving")

    def prefill(self, *args, **kwargs):
        transformer.not_ported("prefill", "serving")

    def decode_step(self, *args, **kwargs):
        transformer.not_ported("decode_step", "serving")


def _unported(cfg: ModelConfig):
    transformer.not_ported(f"family {cfg.family!r}",
                           transformer.FAMILY_ITEM.get(cfg.family, cfg.family))


def input_specs(cfg: ModelConfig, shape: ShapeCfg) -> dict:
    """``{name: (shape, torch dtype)}`` of every model input of a shape cell
    (the dense and MoE families': tokens and labels; decode: one token a
    row)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family not in transformer.PORTED_FAMILIES:
        _unported(cfg)
    if shape.kind == "decode":
        return {"tokens": ((B, 1), torch.int32)}
    return {"tokens": ((B, S), torch.int32),
            "labels": ((B, S), torch.int32)}


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in transformer.PORTED_FAMILIES:
        _unported(cfg)

    def init(seed: int = 0, device=None):
        return transformer.Transformer(cfg, device=device, seed=seed)

    return Model(cfg=cfg, init=init,
                 loss=lambda m, batch: m.loss_fn(batch),
                 forward=lambda m, batch: m(batch["tokens"],
                                            batch.get("patch_embeds")))


def random_batch(cfg: ModelConfig, shape: ShapeCfg, seed: int = 0,
                 device=None) -> dict:
    """A batch matching ``input_specs``, drawn from a numpy seed as the JAX
    package draws it (the same seed gives the same integers)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shp, dtype) in input_specs(cfg, shape).items():
        vals = rng.integers(0, cfg.vocab_size, size=shp)
        out[k] = torch.as_tensor(vals).to(dtype).to(dev)
    return out


def params_from_jax(model: transformer.Transformer, tree) -> \
        transformer.Transformer:
    """Load the JAX package's parameter tree (numpy arrays: stacked
    ``blocks/*`` and ``moe_blocks/*`` leaves of ``[L, ...]``, ``embed``
    with its padded rows) into ``model`` in place; returns it."""
    return model.load_jax_tree(tree)
