"""Sharding rules: which dim of each parameter, cache and batch tensor a
mesh axis splits (the JAX package's ``distributed/sharding.py``).

Rules are path-based and *adaptive*: a dimension is only sharded over an axis
when divisible by it (e.g. whisper's 8 heads cannot split 16-way; the rule
falls back to replication for that tensor while the big matmul dims still
shard).  Data-parallel axes are ("pod", "data"); tensor/expert-parallel is
"model".

FSDP (ZeRO-3) mode additionally shards every parameter's largest non-model
dim over the data axes.

The rules are pure functions of a path string, a shape and the mesh's axis
sizes: a mesh is a ``torch.distributed`` ``DeviceMesh`` (with
``mesh_dim_names``) or a plain ``{axis: size}`` mapping, so the specs of a
256-rank mesh are computed without one.  Parameters are keyed by the JAX
tree's paths (``LM.jax_tree()``: ``"blocks/attn/wq"``, a stacked leaf the
list of its per-layer tensors, shaped ``[L, ...]``).  A spec is a
``PartitionSpec``: a tuple with one entry a dim, ``None``, an axis name or a
tuple of axis names.  ``placements`` turns one into the DTensor placements
of a ``DeviceMesh``.

The reference's ``shard_hint`` (a sharding constraint on activations) has
no one counterpart: under data parallelism each rank's activations are its
own rows of the batch already, so on the data axes the constraint is the
identity; on the "model" axis the layers place their activations by
explicit collectives (``distributed/tensor_parallel.py``), the parameters
whose specs name "model" cut to each rank's slice.
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Optional

# the mesh the launcher trains on (read by the MoE layer's token groups)
_ACTIVE_MESH = None
# how many row shards of the batch one rank's activations are (set by the
# data-parallel train step around its forward / backward, or by a caller
# serving a replicated batch); None: not set, a whole batch
_ROW_SHARDS = None


class PartitionSpec(tuple):
    """One entry per dim: ``None``, a mesh axis name, or a tuple of them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def set_active_mesh(mesh) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_active_mesh():
    return _ACTIVE_MESH


def axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` or of a mapping."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def data_axes(mesh) -> tuple:
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def data_degree(mesh) -> int:
    """The product of the data axes' sizes (1 without a mesh)."""
    if mesh is None:
        return 1
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh))


@contextlib.contextmanager
def row_shards(n: int):
    """Within: each rank's activations are one of ``n`` row shards of the
    batch (``n = 1``: the whole batch, as a replicated one is)."""
    global _ROW_SHARDS
    prev, _ROW_SHARDS = _ROW_SHARDS, n
    try:
        yield
    finally:
        _ROW_SHARDS = prev


def get_row_shards() -> int:
    return _ROW_SHARDS or 1


def row_shards_set() -> bool:
    """Whether a ``row_shards`` context is open."""
    return _ROW_SHARDS is not None


# ---------------------------------------------------------------------------
# parameter sharding rules
# ---------------------------------------------------------------------------

# (regex on param path, spec builder). Specs name logical roles; `_resolve`
# turns them into mesh axes with divisibility fallback.
_RULES = [
    (r"embed$", ("model", None)),
    (r"(lm_head|head)$", (None, "model")),
    (r"(wq|w1|w3|wi)$", (None, "model")),
    (r"(wk|wv)$", (None, "model")),
    (r"(wo|w2)$", ("model", None)),
    (r"(bi)$", ("model",)),
    (r"(bo)$", (None,)),
    (r"router$", (None, None)),
    # MoE experts: (E, D, F) / (E, F, D) — expert-parallel on E
    (r"experts/.*(w1|w3)$", ("expert", None, "model_in_expert")),
    (r"experts/.*w2$", ("expert", "model_in_expert", None)),
    # Mamba/SSM (per-stream projections; see ssm.mixer_init)
    (r"(z_proj|x_proj|b_proj|c_proj|dt_proj)$", (None, "model")),
    (r"out_proj$", ("model", None)),
    (r"conv_w[xbc]$", (None, "model")),
    (r"conv_b[xbc]$", ("model",)),
    (r"norm_w$", ("model",)),
    # DLRM
    (r"tables$", (None, "model", None)),
    (r"(bot_mlp|top_mlp)/.*w$", (None, "model")),
]


def _resolve(spec, shape, mesh, *, fsdp: bool, n_experts: int = 0):
    sizes = axis_sizes(mesh)
    model = sizes.get("model", 1)
    daxes = data_axes(sizes)
    dsize = math.prod(sizes[a] for a in daxes) if daxes else 1
    out = []
    for dim, role in zip(shape, spec):
        if role is None:
            out.append(None)
        elif role == "model":
            out.append("model" if dim % model == 0 else None)
        elif role == "expert":
            out.append("model" if n_experts and dim % model == 0 else None)
        elif role == "model_in_expert":
            # used when experts themselves can't shard (E < model axis)
            out.append("model" if (n_experts % model != 0 and dim % model == 0)
                       else None)
        else:
            out.append(None)
    if fsdp and daxes:
        # shard the largest still-unsharded dim over the data axes (ZeRO-3)
        cands = [i for i, r in enumerate(out) if r is None]
        cands.sort(key=lambda i: -shape[i])
        for i in cands:
            if shape[i] % dsize == 0:
                out[i] = daxes if len(daxes) > 1 else daxes[0]
                break
    return P(*out)


def param_spec(path: str, shape, mesh, *, fsdp: bool = False,
               n_experts: int = 0) -> PartitionSpec:
    """The spec of one leaf at ``path`` (``"blocks/attn/wq"``) of
    ``shape``."""
    shape = tuple(shape)
    for pat, spec in _RULES:
        if re.search(pat, path):
            if len(spec) == len(shape):
                return _resolve(spec, shape, mesh, fsdp=fsdp,
                                n_experts=n_experts)
            if len(spec) == len(shape) - 1:
                # stacked-layer leading dim (scan-over-layers params)
                return _resolve((None,) + tuple(spec), shape, mesh,
                                fsdp=fsdp, n_experts=n_experts)
            if len(spec) == len(shape) - 2:
                # stacked under two axes (hybrid grouped layers)
                return _resolve((None, None) + tuple(spec), shape, mesh,
                                fsdp=fsdp, n_experts=n_experts)
            break
    # default: FSDP-shard biggest dim if requested, else replicate
    return _resolve((None,) * len(shape), shape, mesh, fsdp=fsdp)


def leaf_shape(leaf) -> tuple:
    """The JAX shape of a leaf: a shape tuple, anything with ``.shape``, or
    a list of per-layer tensors (the stacked ``[L, ...]`` leaf)."""
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(leaf[0].shape)
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    return tuple(leaf)


def _map_with_path(fn, tree, prefix: str = ""):
    if isinstance(tree, dict) or hasattr(tree, "items") and \
            not hasattr(tree, "shape"):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(prefix, leaf_shape(tree))


def param_specs(params, mesh, *, fsdp: bool = False, n_experts: int = 0):
    """The tree of ``params`` (nested dicts keyed as the JAX tree is; a leaf
    is a tensor, a shape tuple or a stacked leaf's per-layer list) with a
    ``PartitionSpec`` at every leaf."""
    return _map_with_path(
        lambda path, shape: param_spec(path, shape, mesh, fsdp=fsdp,
                                       n_experts=n_experts), params)


def cache_specs(cache, mesh):
    """Decode-cache sharding: batch over data; heads over model; for GQA
    caches whose kv-head count can't split, the sequence axis takes the model
    axis (flash-decoding style sharded-KV attention)."""
    sizes = axis_sizes(mesh)
    daxes = data_axes(sizes)
    dax = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)
    dsize = math.prod(sizes[a] for a in daxes) if daxes else 1
    msize = sizes.get("model", 1)

    def one(pstr, shape):
        spec = [None] * len(shape)
        if re.search(r"pos", pstr) or len(shape) < 3:
            return P(*spec)
        # layouts: kv (L,B,S,KV,hd) | ssm (L,B,H,N,P) | conv (L,B,K,C)
        if shape[1] % dsize == 0:
            spec[1] = dax
        if re.search(r"(^|/)(k|v)$", pstr) and len(shape) == 5:
            if shape[3] % msize == 0:
                spec[3] = "model"      # kv heads
            elif shape[2] % msize == 0:
                spec[2] = "model"      # sequence-parallel KV
        elif re.search(r"ssm", pstr) and len(shape) >= 4:
            if shape[2] % msize == 0:
                spec[2] = "model"      # ssm heads
        elif re.search(r"conv", pstr) and len(shape) == 4:
            if shape[3] % msize == 0:
                spec[3] = "model"      # conv channels
        return P(*spec)

    return _map_with_path(one, cache)


def batch_specs(batch, mesh):
    """Row-shard every batch tensor over the data axes (dim 0) when they
    divide its rows; replicate it otherwise."""
    sizes = axis_sizes(mesh)
    daxes = data_axes(sizes)
    ax = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)
    dsize = math.prod(sizes[a] for a in daxes) if daxes else 1

    def one(_, shape):
        first = ax if shape and shape[0] % max(dsize, 1) == 0 else None
        return P(*((first,) + (None,) * (len(shape) - 1)))

    return _map_with_path(one, batch)


def data_dim(spec) -> Optional[int]:
    """The dim of ``spec`` the data axes shard, or None."""
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if any(a in ("pod", "data") for a in names):
            return d
    return None


def placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    per mesh dim, ``Shard(d)`` for the tensor dim whose entry names it,
    else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dim = None
        for d, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            if name in names:
                dim = d
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def local_part(full, like):
    """This rank's part of the whole tensor ``full`` as the DTensor ``like``
    lays it out (``torch.chunk`` along each sharded dim, as DTensor's
    ``Shard`` does); no communication."""
    mesh = like.device_mesh
    for i, pl in enumerate(like.placements):
        if pl.is_shard():
            parts = full.chunk(mesh.size(i), pl.dim)
            r = mesh.get_local_rank(i)
            # an uneven split has fewer chunks than ranks: the rest hold none
            full = parts[r] if r < len(parts) else \
                full.narrow(pl.dim, full.shape[pl.dim], 0)
    return full
