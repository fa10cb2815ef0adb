"""DLRM (arXiv:1906.00091) — the paper's own trainer, as an ``nn.Module``.

The ETL engine's packed output feeds it directly:
  dense  : (B, dense_padded) f32 -> bottom MLP -> (B, d_emb)
  sparse : (B, >= n_sparse) int32 -> per-feature embedding gather
  label  : (B,) f32 click         -> BCE loss

Feature interaction = pairwise dots between the bottom-MLP output and every
embedding vector (upper triangle, in ``torch.triu_indices`` order, which is
``jnp.triu_indices`` order), concatenated with the dense vector into the top
MLP.  Embedding tables are stacked ``(n_sparse, vocab, d_emb)`` as in the JAX
package.  The lookup is its plain per-feature gather, unless the batch
carries a lookahead plan (``emb_cache``, from ``EmbedCache.advance``): then
all features resolve through one launch of the two-level
``embedding_bag_cached`` kernel, hot rows from the cache and cold rows from
the table, written as the ``(B, F, d)`` embeddings, and the backward
scatter-adds into the tables at the original ids, so the gradient is the
uncached one bit for bit.  On a "model" mesh axis the tables are
row-sharded (rank r holds rows ``[r V/m, (r+1) V/m)`` of every feature)
and both lookups sum the ranks' parts.

``params_from_jax`` maps the JAX package's parameter pytree (as numpy
arrays) to this module's ``state_dict``: JAX's ``x @ w`` stores ``w`` as
``(in, out)``, ``nn.Linear`` as ``(out, in)``.  ``state_to_jax_leaves`` /
``load_jax_leaves`` carry a whole train state (model, AdamW moments, step)
across as the JAX package's ``TrainState`` leaf list, so a checkpoint
written by either package restores in the other.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.embedding_bag import cached_embedding_lookup
from repro_torch.models import layers as L


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
            x = _linear(lin, x)
            if i < len(layers) - 1 or not final_linear:
                x = torch.relu(x)
        return x

    def _lookup(self, sparse):
        """The (B, F, d) embeddings of ``sparse``: a table whose rows are
        sharded over the model axis reads the ids in its rows (0
        elsewhere), and the ranks' parts are summed."""
        rows = self.tables.shape[1]
        if not tp.split(rows, self.cfg.vocab_size):
            return self.tables[self._feat, sparse]
        ax = tp.active()
        ids = sparse - ax.rank * rows
        mine = (ids >= 0) & (ids < rows)
        emb = self.tables[self._feat, ids.clamp(0, rows - 1)]
        return tp.reduce_out(torch.where(mine[..., None], emb, torch.zeros(
            (), dtype=emb.dtype, device=emb.device)), ax)

    def _cached_lookup(self, cache, slot, cold, sparse):
        """The lookahead path's (B, F, d) embeddings.  On a table whose rows
        are sharded over the model axis, each rank's cache holds the rows
        in its range (zero elsewhere, ``EmbedCache``), its cold ids and the
        gradient's ids are shifted into its rows (an id outside them reads
        zero and takes no gradient), and the ranks' parts are summed: one
        rank contributes each (b, f)'s row, so the sum is exact."""
        rows = self.tables.shape[1]
        if not tp.split(rows, self.cfg.vocab_size):
            return cached_embedding_lookup(self.tables, cache, slot, cold,
                                           sparse)
        ax = tp.active()
        first = ax.rank * rows
        return tp.reduce_out(cached_embedding_lookup(
            self.tables, cache, slot, cold - first, sparse - first), ax)

    def forward(self, batch: dict) -> torch.Tensor:
        """Logits (B,)."""
        cfg = self.cfg
        dense = batch["dense"].to(getattr(torch, cfg.compute_dtype))
        sparse = batch["sparse"][:, :cfg.n_sparse].long()  # drop pad lanes
        bot = self._mlp(self.bot_mlp, dense, final_linear=False)  # (B, d)
        n = cfg.n_sparse
        if "emb_cache" in batch:
            emb = self._cached_lookup(batch["emb_cache"][:n],
                                      batch["emb_slot"][:, :n],
                                      batch["emb_cold"][:, :n], sparse)
        else:
            emb = self._lookup(sparse)
        emb = emb.to(bot.dtype)  # (B, F, d)
        z = torch.cat([bot[:, None, :], emb], dim=1)  # (B, F+1, d)
        inter = torch.bmm(z, z.transpose(1, 2))
        pairs = inter[:, self._iu, self._ju]
        top_in = torch.cat([bot, pairs.to(bot.dtype)], dim=1)
        return self._mlp(self.top_mlp, top_in)[:, 0]


def _linear(lin: nn.Linear, x):
    """``lin(x)``; with its output features sharded over the model axis
    (the JAX ``w``'s ``(None, "model")``, dim 0 of ``lin.weight``), the
    rank's columns from ``x`` through ``tp.copy_in`` and the bias' slice,
    gathered for the next layer."""
    if not tp.split(lin.weight.shape[0], lin.out_features):
        return lin(x)
    ax = tp.active()
    y = F.linear(tp.copy_in(x, ax), lin.weight, tp.scatter(lin.bias, 0, ax))
    return tp.gather(y, -1, ax)


def loss_fn(model: DLRM, batch: dict) -> torch.Tensor:
    """Numerically stable mean BCE with logits (the JAX package's form);
    within ``layers.label_count`` the sum over the count set there (the
    rows of the whole data-parallel batch)."""
    logit = model(batch).to(torch.float32)
    y = batch["label"].to(torch.float32)
    per = (torch.clamp(logit, min=0) - logit * y
           + torch.log1p(torch.exp(-logit.abs())))
    count = L.global_label_count()
    return per.mean() if count is None else per.sum() / count


def predict(model: DLRM, batch: dict) -> torch.Tensor:
    """Click probabilities: the sigmoid of the logits."""
    return torch.sigmoid(model(batch))


def params_from_jax(tree: dict) -> dict:
    """The JAX package's ``dlrm.init`` pytree (leaves as numpy arrays) ->
    a ``state_dict`` for ``DLRM.load_state_dict``."""
    out = {"tables": torch.tensor(np.asarray(tree["tables"]))}
    for name in ("bot_mlp", "top_mlp"):
        for i, layer in enumerate(tree[name]):
            out[f"{name}.{i}.weight"] = torch.tensor(np.asarray(layer["w"]).T)
            out[f"{name}.{i}.bias"] = torch.tensor(np.asarray(layer["b"]))
    return out


def _jax_leaf_order(model: DLRM) -> list:
    """``(index into model.parameters(), transposed)`` in the JAX package's
    flatten order of its parameter pytree: dict keys sorted (``bot_mlp``,
    ``tables``, ``top_mlp``), each layer's ``b`` before its ``w``."""
    index = {n: i for i, (n, _) in enumerate(model.named_parameters())}
    order = []
    for name in ("bot_mlp", "tables", "top_mlp"):
        if name == "tables":
            order.append((index["tables"], False))
            continue
        for i in range(len(getattr(model, name))):
            order += [(index[f"{name}.{i}.bias"], False),
                      (index[f"{name}.{i}.weight"], True)]
    return order


def jax_named_leaves(model: DLRM) -> list:
    """``(JAX path, JAX shape, parameter name, transposed)`` of each
    parameter in the JAX package's flatten order (``bot_mlp/0/w`` is
    ``bot_mlp.0.weight``, transposed)."""
    named = list(model.named_parameters())
    out = []
    for i, tr in _jax_leaf_order(model):
        name, p = named[i]
        parts = name.split(".")
        path = name if len(parts) == 1 else \
            f"{parts[0]}/{parts[1]}/{'w' if tr else 'b'}"
        out.append((path, tuple(p.shape)[::-1] if tr else tuple(p.shape),
                    name, tr))
    return out


def state_model_dims(state) -> list:
    """Beside each leaf of ``state_to_jax_leaves(state)``: ``(dim,
    ModelAxis)`` of its model shard in the leaf's (JAX) layout, or
    ``(None, None)``; Adafactor's state is whole over the model axis."""
    params = list(state.model.parameters())
    order = _jax_leaf_order(state.model)
    mine = [tp.shard_of(params[i]) for i, _ in order]
    flip = lambda d, tr: 1 - d if tr and d is not None else d
    per = [(flip(d, tr), ax) for (_, tr), (d, ax) in zip(order, mine)]
    dims = per * (1 if "f" in state.opt else 3)
    dims += [(None, None)] * sum(len(st) for st in state.opt.get("f", ()))
    return dims + [(None, None)]


def state_to_jax_leaves(state) -> list:
    """A train state (``model``: a ``DLRM``, ``opt``: AdamW ``{"m", "v"}``
    or Adafactor ``{"f"}`` in ``model.parameters()`` order, ``step``) as
    the JAX package's ``TrainState(params, opt, step)`` leaves, in its
    flatten order: the parameters, then ``m``, then ``v`` (each ``w`` as
    ``[in, out]``: a transposed view, no copy) or each leaf's ``vc`` and
    ``vr`` (or ``v``), then ``step`` as an int32 scalar."""
    order = _jax_leaf_order(state.model)
    leaves = []
    groups = [list(state.model.parameters())]
    if "f" not in state.opt:
        groups += [state.opt["m"], state.opt["v"]]
    for group in groups:
        leaves += [group[i].detach().t() if tr else group[i].detach()
                   for i, tr in order]
    for i, tr in order if "f" in state.opt else ():
        st = state.opt["f"][i]  # Adafactor: one leaf per parameter
        if "v" in st:
            leaves.append(st["v"].t() if tr else st["v"])
        else:  # a transposed w's row factor is the reference's column one
            leaves += [st["vr"], st["vc"]] if tr else [st["vc"], st["vr"]]
    leaves.append(torch.tensor(state.step, dtype=torch.int32))
    return leaves


@torch.no_grad()
def load_jax_leaves(state, leaves) -> object:
    """The inverse of ``state_to_jax_leaves``: copy ``leaves`` (arrays or
    tensors in that order and layout) into ``state``'s parameters and
    moments in place, on their devices, and set its step.  Returns
    ``state``."""
    want = state_to_jax_leaves(state)
    if len(leaves) != len(want):
        raise ValueError(f"{len(leaves)} leaves for a state of {len(want)}")
    for dst, src in zip(want[:-1], leaves[:-1]):
        if not isinstance(src, torch.Tensor):
            src = torch.as_tensor(np.asarray(src))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"leaf shape {tuple(src.shape)} != "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)  # dst may be a transposed view: copy_ writes through
    state.step = int(np.asarray(leaves[-1]))
    return state
