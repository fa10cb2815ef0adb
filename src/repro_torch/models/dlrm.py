"""DLRM (arXiv:1906.00091) — the paper's own trainer, as an ``nn.Module``.

The ETL engine's packed output feeds it directly:
  dense  : (B, dense_padded) f32 -> bottom MLP -> (B, d_emb)
  sparse : (B, >= n_sparse) int32 -> per-feature embedding gather
  label  : (B,) f32 click         -> BCE loss

Feature interaction = pairwise dots between the bottom-MLP output and every
embedding vector (upper triangle, in ``torch.triu_indices`` order, which is
``jnp.triu_indices`` order), concatenated with the dense vector into the top
MLP.  Embedding tables are stacked ``(n_sparse, vocab, d_emb)`` as in the JAX
package; the lookup is its plain per-feature gather (the multi-hot
``embedding_bag`` kernels are a later slice).

``params_from_jax`` maps the JAX package's parameter pytree (as numpy
arrays) to this module's ``state_dict``: JAX's ``x @ w`` stores ``w`` as
``(in, out)``, ``nn.Linear`` as ``(out, in)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm_criteo"
    n_dense: int = 13
    n_sparse: int = 26
    vocab_size: int = 524288  # per-feature (post VocabMap, +1 OOV)
    d_emb: int = 128
    bot_mlp: tuple = (512, 256, 128)
    top_mlp: tuple = (1024, 1024, 512, 256, 1)
    dense_padded: int = 16  # packer pads 13 -> 16
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    def param_count(self) -> int:
        emb = self.n_sparse * self.vocab_size * self.d_emb
        dims_b = (self.dense_padded,) + self.bot_mlp
        mb = sum(a * b + b for a, b in zip(dims_b[:-1], dims_b[1:]))
        n_pairs = (self.n_sparse + 1) * self.n_sparse // 2
        top_in = self.bot_mlp[-1] + n_pairs
        dims_t = (top_in,) + self.top_mlp
        mt = sum(a * b + b for a, b in zip(dims_t[:-1], dims_t[1:]))
        return emb + mb + mt


def _trunc_normal_(t: torch.Tensor, scale: float,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """In place: N(0, 1) truncated to [-2, 2], times ``scale`` (the JAX
    package's ``layers.truncated_normal``; other random bits, same law)."""
    with torch.no_grad():
        nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0, generator=generator)
        return t.mul_(scale)


class DLRM(nn.Module):
    def __init__(self, cfg: DLRMConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        dt = getattr(torch, cfg.param_dtype)
        self.tables = nn.Parameter(torch.empty(
            cfg.n_sparse, cfg.vocab_size, cfg.d_emb, dtype=dt, device=dev))
        n_pairs = (cfg.n_sparse + 1) * cfg.n_sparse // 2
        dims_b = (cfg.dense_padded,) + tuple(cfg.bot_mlp)
        dims_t = (cfg.bot_mlp[-1] + n_pairs,) + tuple(cfg.top_mlp)
        self.bot_mlp = nn.ModuleList(
            nn.Linear(a, b, dtype=dt, device=dev)
            for a, b in zip(dims_b[:-1], dims_b[1:]))
        self.top_mlp = nn.ModuleList(
            nn.Linear(a, b, dtype=dt, device=dev)
            for a, b in zip(dims_t[:-1], dims_t[1:]))
        iu, ju = torch.triu_indices(cfg.n_sparse + 1, cfg.n_sparse + 1, 1,
                                    device=dev)
        self.register_buffer("_iu", iu, persistent=False)
        self.register_buffer("_ju", ju, persistent=False)
        self.register_buffer("_feat", torch.arange(cfg.n_sparse, device=dev),
                             persistent=False)
        _trunc_normal_(self.tables, 1.0 / math.sqrt(cfg.d_emb), generator)
        for lin in list(self.bot_mlp) + list(self.top_mlp):
            _trunc_normal_(lin.weight, 1.0 / math.sqrt(lin.in_features),
                           generator)
            with torch.no_grad():
                lin.bias.zero_()

    @staticmethod
    def _mlp(layers, x, *, final_linear: bool = True):
        for i, lin in enumerate(layers):
            x = lin(x)
            if i < len(layers) - 1 or not final_linear:
                x = torch.relu(x)
        return x

    def forward(self, batch: dict) -> torch.Tensor:
        """Logits (B,)."""
        cfg = self.cfg
        dense = batch["dense"].to(getattr(torch, cfg.compute_dtype))
        sparse = batch["sparse"][:, :cfg.n_sparse].long()  # drop pad lanes
        bot = self._mlp(self.bot_mlp, dense, final_linear=False)  # (B, d)
        emb = self.tables[self._feat, sparse].to(bot.dtype)  # (B, F, d)
        z = torch.cat([bot[:, None, :], emb], dim=1)  # (B, F+1, d)
        inter = torch.bmm(z, z.transpose(1, 2))
        pairs = inter[:, self._iu, self._ju]
        top_in = torch.cat([bot, pairs.to(bot.dtype)], dim=1)
        return self._mlp(self.top_mlp, top_in)[:, 0]


def loss_fn(model: DLRM, batch: dict) -> torch.Tensor:
    """Numerically stable mean BCE with logits (the JAX package's form)."""
    logit = model(batch).to(torch.float32)
    y = batch["label"].to(torch.float32)
    per = (torch.clamp(logit, min=0) - logit * y
           + torch.log1p(torch.exp(-logit.abs())))
    return per.mean()


def params_from_jax(tree: dict) -> dict:
    """The JAX package's ``dlrm.init`` pytree (leaves as numpy arrays) ->
    a ``state_dict`` for ``DLRM.load_state_dict``."""
    out = {"tables": torch.tensor(np.asarray(tree["tables"]))}
    for name in ("bot_mlp", "top_mlp"):
        for i, layer in enumerate(tree[name]):
            out[f"{name}.{i}.weight"] = torch.tensor(np.asarray(layer["w"]).T)
            out[f"{name}.{i}.bias"] = torch.tensor(np.asarray(layer["b"]))
    return out
