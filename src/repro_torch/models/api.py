"""Unified model API (the JAX package's ``models/api.py``): ``build_model(cfg)
-> Model`` with init / loss / forward and the serving entry points
(``init_cache`` / ``prefill`` / ``decode_step``), ``input_specs`` per shape
cell, ``cache_specs``, ``random_batch`` and ``params_from_jax``.

Every family of the zoo: dense, MoE and VLM (``models/transformer.py``),
SSM (``models/ssm.py``), hybrid (``models/hybrid.py``) and enc-dec
(``models/encdec.py``).  As in the reference, a VLM serves text only
(``prefill`` takes the prompt's tokens and no patch embeddings), and an
enc-dec model trains and prefills on stub ``frames`` beside its tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import encdec, hybrid, ssm, transformer

# family -> (the module holding its ``init_cache``, its model class)
FAMILIES = {**{f: (transformer, transformer.Transformer)
               for f in transformer.TRANSFORMER_FAMILIES},
            "ssm": (ssm, ssm.SSM), "hybrid": (hybrid, hybrid.Hybrid),
            "encdec": (encdec, encdec.EncDec)}


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


def _family(cfg: ModelConfig) -> tuple:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return FAMILIES[cfg.family]


def input_specs(cfg: ModelConfig, shape: ShapeCfg) -> dict:
    """``{name: (shape, torch dtype)}`` of every model input of a shape
    cell: tokens and labels; an enc-dec model adds ``enc_seq`` float32
    frame embeddings first; a VLM trains on ``n_patches`` float32 patch
    embeddings and ``max(S - n_patches, 1)`` text tokens; decode takes one
    token a row (the cache is ``cache_specs``'s)."""
    B, S = shape.global_batch, shape.seq_len
    _family(cfg)
    if shape.kind == "decode":
        return {"tokens": ((B, 1), torch.int32)}
    if cfg.family == "encdec":
        return {"frames": ((B, cfg.enc_seq, cfg.d_model), torch.float32),
                "tokens": ((B, S), torch.int32),
                "labels": ((B, S), torch.int32)}
    if cfg.family == "vlm" and shape.kind == "train":
        text = max(S - cfg.n_patches, 1)
        return {"patch_embeds": ((B, cfg.n_patches, cfg.d_model),
                                 torch.float32),
                "tokens": ((B, text), torch.int32),
                "labels": ((B, text), torch.int32)}
    return {"tokens": ((B, S), torch.int32),
            "labels": ((B, S), torch.int32)}


def build_model(cfg: ModelConfig) -> Model:
    mod, cls = _family(cfg)
    fam = cfg.family

    def init(seed: int = 0, device=None):
        return cls(cfg, device=device, seed=seed)

    def forward(m, batch):
        if fam == "encdec":
            return m(batch["frames"], batch["tokens"])
        if fam in ("ssm", "hybrid"):
            return m(batch["tokens"])
        return m(batch["tokens"], batch.get("patch_embeds"))

    def init_cache(b, max_len, device=None):
        if fam == "encdec":
            return encdec.init_cache(cfg, b, max_len, cfg.enc_seq,
                                     device=device)
        return mod.init_cache(cfg, b, max_len, device=device)

    def prefill(m, batch, max_len):
        if fam == "encdec":
            return m.prefill(batch["frames"], batch["tokens"], max_len)
        return m.prefill(batch["tokens"], max_len)

    return Model(cfg=cfg, init=init,
                 loss=lambda m, batch: m.loss_fn(batch),
                 forward=forward, init_cache=init_cache, prefill=prefill,
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
    """Load the JAX package's parameter tree (numpy arrays: each layer
    group's leaves stacked ``[L, ...]``, unstacked subtrees as they are,
    ``embed`` with its padded rows) into ``model`` (an ``LM`` of any
    family) in place; returns it."""
    return model.load_jax_tree(tree)
