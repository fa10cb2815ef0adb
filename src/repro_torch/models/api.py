"""Unified model API (the JAX package's ``models/api.py``): ``build_model(cfg)
-> Model`` with init / loss / forward and the serving entry points
(``init_cache`` / ``prefill`` / ``decode_step``), ``input_specs`` per shape
cell, ``cache_specs``, ``random_batch`` and ``params_from_jax``.

Ported: the dense, MoE and VLM families (``models/transformer.py``) and
the SSM family (``models/ssm.py``).  Hybrid and enc-dec raise
``NotImplementedError`` naming their ROADMAP Queue A item.  As in the
reference, a VLM serves text only: ``prefill`` takes the prompt's tokens
and no patch embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import ssm, transformer

PORTED_FAMILIES = (*transformer.TRANSFORMER_FAMILIES, "ssm")


@dataclasses.dataclass
class Model:
    """The entry points of one config.  ``init(seed, device)`` builds the
    module; the others take it first, where the reference takes params."""
    cfg: ModelConfig
    init: Callable         # (seed=0, device=None) -> nn.Module
    loss: Callable         # (module, batch) -> scalar
    forward: Callable      # (module, batch) -> logits
    init_cache: Callable   # (batch, max_len, device=None) -> cache
    prefill: Callable      # (module, batch, max_len) -> (logits, cache)
    decode_step: Callable  # (module, cache, tokens, pos) -> (logits, cache)


def _unported(cfg: ModelConfig):
    transformer.not_ported(f"family {cfg.family!r}",
                           transformer.FAMILY_ITEM.get(cfg.family, cfg.family))


def input_specs(cfg: ModelConfig, shape: ShapeCfg) -> dict:
    """``{name: (shape, torch dtype)}`` of every model input of a shape
    cell: tokens and labels; a VLM trains on ``n_patches`` float32 patch
    embeddings and ``max(S - n_patches, 1)`` text tokens; decode takes one
    token a row (the cache is ``cache_specs``'s)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family not in PORTED_FAMILIES:
        _unported(cfg)
    if shape.kind == "decode":
        return {"tokens": ((B, 1), torch.int32)}
    if cfg.family == "vlm" and shape.kind == "train":
        text = max(S - cfg.n_patches, 1)
        return {"patch_embeds": ((B, cfg.n_patches, cfg.d_model),
                                 torch.float32),
                "tokens": ((B, text), torch.int32),
                "labels": ((B, text), torch.int32)}
    return {"tokens": ((B, S), torch.int32),
            "labels": ((B, S), torch.int32)}


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in PORTED_FAMILIES:
        _unported(cfg)
    cls = ssm.SSM if cfg.family == "ssm" else transformer.Transformer
    mod = ssm if cfg.family == "ssm" else transformer

    def init(seed: int = 0, device=None):
        return cls(cfg, device=device, seed=seed)

    def forward(m, batch):
        if cfg.family == "ssm":
            return m(batch["tokens"])
        return m(batch["tokens"], batch.get("patch_embeds"))

    return Model(cfg=cfg, init=init,
                 loss=lambda m, batch: m.loss_fn(batch),
                 forward=forward,
                 init_cache=lambda b, max_len, device=None: mod.init_cache(
                     cfg, b, max_len, device=device),
                 prefill=lambda m, batch, max_len: m.prefill(batch["tokens"],
                                                             max_len),
                 decode_step=lambda m, cache, tokens, pos: m.decode_step(
                     cache, tokens, pos))


def cache_specs(model: Model, shape: ShapeCfg) -> dict:
    """The decode cache of a shape cell as ``(shape, dtype)`` leaves, built
    on the ``meta`` device (nothing allocated)."""
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             device="meta")

    def spec(t):
        if isinstance(t, dict):
            return {k: spec(v) for k, v in t.items()}
        return (tuple(t.shape), t.dtype)
    return spec(cache)


def random_batch(cfg: ModelConfig, shape: ShapeCfg, seed: int = 0,
                 device=None) -> dict:
    """A batch matching ``input_specs``, drawn from a numpy seed as the JAX
    package draws it (keys in ``input_specs``' order; integers in
    ``[0, vocab_size)``, floats ``rng.normal`` as float32), so the same
    seed gives the same arrays."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shp, dtype) in input_specs(cfg, shape).items():
        if dtype.is_floating_point:
            vals = rng.normal(size=shp).astype(np.float32)
        else:
            vals = rng.integers(0, cfg.vocab_size, size=shp)
        out[k] = torch.as_tensor(vals).to(dtype).to(dev)
    return out


def params_from_jax(model: transformer.LM, tree) -> transformer.LM:
    """Load the JAX package's parameter tree (numpy arrays: stacked
    ``blocks/*`` and ``moe_blocks/*`` leaves of ``[L, ...]``, ``embed``
    with its padded rows) into ``model`` (a ``Transformer`` or an ``SSM``)
    in place; returns it."""
    return model.load_jax_tree(tree)
