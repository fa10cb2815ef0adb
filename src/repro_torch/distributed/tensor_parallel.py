"""The "model" mesh axis: tensor, sequence and expert parallelism by
explicit collectives on plain local tensors (Megatron-LM's scheme; the JAX
package gets the same placement from ``sharding.shard_hint`` and GSPMD).

A parameter whose spec (``sharding.param_spec``) names ``"model"`` on a dim
is held on each rank as its part of that dim (``torch.chunk`` order: rank
r of m holds the r-th of m equal slices; ``shard_model``).  Each layer that
reads one computes its part and meets the other model ranks of its data
coordinate in the collectives below; the layers see from a parameter's
shape whether it is sharded (``split``), and find the group in the active
mesh (``active``).  FSDP on the data axes then shards the local tensors
further, unchanged.  For serving, ``shard_for_serving`` cuts a model the
same way, and each decode cache is allocated as this rank's shard of it
(``local_cache``, the layout of ``sharding.cache_specs``); weight-gathered
serving also cuts each parameter over the data axes (``shard_data``) and
gathers a block's parameters whole just before it runs (``gathered``).

The regions, as Megatron-LM names them (each an autograd function over
the model group):

- ``copy_in``: identity forward, all-reduce backward.  Every tensor that
  is the same on all model ranks (replicated) and feeds a computation that
  differs per rank passes through it, so its gradient, a partial sum on
  each rank, is summed: the input of a column-parallel product, the combine
  weights of an expert-parallel MoE layer, a norm's weight applied to a
  rank's own heads or sequence shard.
- ``reduce_out``: all-reduce forward, identity backward: the partial sums
  of a row-parallel product (or a vocabulary- or expert-parallel lookup).
- ``gather``: all-gather forward, slice backward: a sharded result that a
  replicated computation consumes.
- ``gather_to_shards``: all-gather forward, reduce-scatter backward: a
  sharded result that every rank's shard of a computation reads whole
  (the SSM's B and C, split on the state dim, read by each rank's heads).
- ``scatter``: slice forward, all-gather backward.
- ``reduce_scatter``: reduce-scatter forward, all-gather backward (a
  sequence-parallel block's output).
- ``enter`` of a sequence shard: one all-gather forward, whose two outputs
  (replicated use, the rank's weight shards) meet again in the backward:
  the replicated one's gradient sliced, plus the shards' one
  reduce-scattered (a sequence-parallel block's input).

A replicated tensor keeps the same gradient on every model rank, so a
replicated parameter's gradient needs no reduction over the group and its
value stays bit-equal across the ranks.  Only ``all_reduce``,
``all_gather_single`` and ``reduce_scatter_single`` (the older
``*_into_tensor`` / ``*_tensor`` names where those are missing) are used,
on every backend alike: gloo carries all three on CUDA tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's view of a mesh's "model" axis: its process group, its
    index along the axis and the axis' size."""

    group: object
    rank: int
    size: int


def model_axis(mesh) -> Optional[ModelAxis]:
    """The "model" axis of the ``DeviceMesh`` ``mesh``, or None (no mesh,
    no such axis, or one of size 1)."""
    if mesh is None or "model" not in getattr(mesh, "mesh_dim_names", ()):
        return None
    size = shd.axis_sizes(mesh)["model"]
    if size == 1:
        return None
    return ModelAxis(mesh.get_group("model"), mesh.get_local_rank("model"),
                     size)


def data_axis(mesh) -> Optional[ModelAxis]:
    """The data axes of the ``DeviceMesh`` ``mesh`` flattened into one
    (``train_loop.data_group``'s group), as the same triple: its group,
    this rank's index along it and its size; None where their degree is
    1."""
    if shd.data_degree(mesh) == 1:
        return None
    from repro_torch.training.train_loop import data_group
    group, sub = data_group(mesh)
    return ModelAxis(group, sub.get_local_rank(), sub.size())


def active() -> Optional[ModelAxis]:
    """The model axis of the active mesh (``sharding.set_active_mesh``)."""
    return model_axis(shd.get_active_mesh())


def split(local: int, whole: int) -> bool:
    """Whether a dim of ``whole`` entries held as ``local`` is a model
    shard; raises where there is no model axis to hold the rest."""
    if local == whole:
        return False
    ax = active()
    if ax is None or local * ax.size != whole:
        raise ValueError(f"a dim of {whole} held as {local} entries: no "
                         f"active model axis splits it so ({ax})")
    return True


# ---------------------------------------------------------------------------
# the collectives (plain, no autograd)
# ---------------------------------------------------------------------------

# bytes and calls of each collective over the model axis since the last
# reset_traffic() (the whole tensor: all-reduced, gathered, or before its
# reduce-scatter), of weight-gathered serving's gathers over the data axes
# ("data_all_gather": the gathered tensors) and of the lookahead cache's
# rows from FSDP-sharded tables over the data axes ("embed_cache_gather":
# the requests gathered and the rows before their reduce-scatter)
TRAFFIC = {"all_reduce": [0, 0], "all_gather": [0, 0],
           "reduce_scatter": [0, 0], "data_all_gather": [0, 0],
           "embed_cache_gather": [0, 0]}


def reset_traffic() -> None:
    for v in TRAFFIC.values():
        v[:] = [0, 0]


def _count(kind: str, t) -> None:
    TRAFFIC[kind][0] += t.numel() * t.element_size()
    TRAFFIC[kind][1] += 1


_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def all_reduce(x, ax: ModelAxis, op=dist.ReduceOp.SUM):
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=ax.group)
    _count("all_reduce", y)
    return y


def all_gather(x, dim: int, ax: ModelAxis, kind: str = "all_gather"):
    """The ranks' ``x`` concatenated along ``dim`` in rank order (counted
    in ``TRAFFIC[kind]``)."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((ax.size * x.shape[0],) + tuple(x.shape[1:]))
    _gather_single(out, x, group=ax.group)
    _count(kind, out)
    return out.movedim(0, dim)


def part(x, dim: int, ax: ModelAxis):
    """This rank's slice of ``x`` along ``dim`` (``torch.chunk`` order)."""
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.rank * n, n)


def reduce_scatter_sum(x, dim: int, ax: ModelAxis,
                       kind: str = "reduce_scatter"):
    """This rank's slice along ``dim`` of the ranks' ``x`` summed (counted
    in ``TRAFFIC[kind]``)."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // ax.size,) + tuple(x.shape[1:]))
    _reduce_scatter_single(out, x, group=ax.group)
    _count(kind, x)
    return out.movedim(0, dim)


# ---------------------------------------------------------------------------
# the regions (autograd functions)
# ---------------------------------------------------------------------------

class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return part(g, ctx.dim, ctx.ax).contiguous(), None, None


class _GatherToShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_sum(g, ctx.dim, ctx.ax), None, None


class _EnterSeq(torch.autograd.Function):
    """A sequence shard gathered whole once, as two outputs: for replicated
    use (its gradient is the same on every rank: sliced) and for the
    rank's weight shards (partial on each rank: summed over the group and
    sliced in one reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        out = all_gather(x, 1, ax)
        return out, out.view_as(out)

    @staticmethod
    def backward(ctx, g_rep, g_shards):
        return (part(g_rep, 1, ctx.ax)
                + reduce_scatter_sum(g_shards, 1, ctx.ax)), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return part(x, dim, ax).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.ax), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return reduce_scatter_sum(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.ax), None, None


def copy_in(x, ax: ModelAxis):
    return _CopyIn.apply(x, ax)


def reduce_out(x, ax: ModelAxis):
    return _ReduceOut.apply(x, ax)


def gather(x, dim: int, ax: ModelAxis):
    return _Gather.apply(x, dim % x.dim(), ax)


def gather_to_shards(x, dim: int, ax: ModelAxis):
    return _GatherToShards.apply(x, dim % x.dim(), ax)


def scatter(x, dim: int, ax: ModelAxis):
    return _Scatter.apply(x, dim % x.dim(), ax)



def reduce_scatter(x, dim: int, ax: ModelAxis):
    return _ReduceScatter.apply(x, dim % x.dim(), ax)


def enter(x, ax: ModelAxis, seq_sharded: bool) -> tuple:
    """A tensor-parallel region's input: ``(replicated, for_shards)``, the
    whole-sequence activations for replicated use and the same through
    ``copy_in`` for the rank's shards of the weights.  ``seq_sharded``: ``x``
    is the rank's sequence shard (dim 1), gathered once; the backward
    reduce-scatters the shards' gradient (``_EnterSeq``), as GSPMD
    transposes the reference's ``shard_hint``, where a gather and a
    ``copy_in`` would all-reduce the whole sequence, then slice it."""
    if seq_sharded:
        return _EnterSeq.apply(x, ax)
    return x, copy_in(x, ax)


def leave(y, ax: ModelAxis, partial: bool, seq_sharded: bool):
    """A region's output: ``partial`` sums are reduced (onto the rank's
    sequence shard when ``seq_sharded``); a replicated ``y`` is sliced to
    that shard, or kept."""
    if partial:
        return reduce_scatter(y, 1, ax) if seq_sharded else reduce_out(y, ax)
    return scatter(y, 1, ax) if seq_sharded else y


# ---------------------------------------------------------------------------
# sharding a model
# ---------------------------------------------------------------------------

def model_dim(spec) -> Optional[int]:
    """The dim of ``spec`` the "model" axis shards, or None."""
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if "model" in names:
            return d
    return None


@torch.no_grad()
def shard_model(model, dims: dict, ax: ModelAxis) -> None:
    """Keep, of each parameter named in ``dims`` (``{name: model dim}``, as
    ``model.named_parameters()`` names them), this rank's slice along that
    dim, in place (the parameter object stays), and record the dims on
    ``model.model_shards``."""
    params = dict(model.named_parameters())
    for name, d in dims.items():
        p = params[name]
        p.data = part(p.data, d, ax).clone()
    model.model_shards = (dict(dims), ax)
    mark(model)


def mark(model) -> None:
    """Tag each sharded parameter of ``model`` (after any wrapping that
    replaced the parameter objects) with ``tp_shard = (dim, ModelAxis)``,
    which the optimizer and the checkpoint read."""
    dims, ax = getattr(model, "model_shards", ({}, None))
    for name, p in model.named_parameters():
        if name in dims:
            p.tp_shard = (dims[name], ax)


def shard_of(p) -> tuple:
    """``(model dim, ModelAxis)`` of a parameter, or ``(None, None)``."""
    return getattr(p, "tp_shard", (None, None))


def padded_part(x, dim: int, ax: ModelAxis):
    """This rank's slice of ``x`` along ``dim`` where ``ax.size`` need not
    divide it: ``x`` zero-padded to a multiple of it, then sliced, as
    FSDP2's ``Shard`` lays out an uneven split (a copy)."""
    n = -(-x.shape[dim] // ax.size)
    pad = n * ax.size - x.shape[dim]
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim)
    return x.narrow(dim, ax.rank * n, n).clone()


@torch.no_grad()
def shard_data(model, dims: dict, dax: ModelAxis) -> None:
    """Keep, of each parameter named in ``dims`` (``{name: data dim}``),
    this rank's slice along that dim over the data axes ``dax``
    (``padded_part``: zero-padded where they do not divide it), in place,
    and tag it ``dp_shard = (dim, dax, whole size)`` (``gathered``
    reads it)."""
    params = dict(model.named_parameters())
    for name, d in dims.items():
        p = params[name]
        whole = p.shape[d]
        p.data = padded_part(p.data, d, dax)
        p.dp_shard = (d, dax, whole)


@contextlib.contextmanager
def gathered(*parts):
    """Within: each data-sharded parameter (``shard_data``) of ``parts``
    (modules or parameters; a parameter named twice is gathered once)
    holds its whole local tensor, all-gathered over the data axes
    (``TRAFFIC["data_all_gather"]``, padding included) and its padding
    dropped; after it, its shard again and the gathered copy dropped.
    Parameters without a data shard are left as they are, so a model that
    is not weight-gathered passes through."""
    params = {}
    for x in parts:
        for p in (x.parameters() if isinstance(x, torch.nn.Module)
                  else (x,)):
            if hasattr(p, "dp_shard"):
                params[id(p)] = p
    shards = []
    try:
        for p in params.values():
            d, dax, whole = p.dp_shard
            shards.append((p, p.data))
            p.data = all_gather(p.data, d, dax, kind="data_all_gather"
                                ).narrow(d, 0, whole)
        yield
    finally:
        for p, shard in shards:
            p.data = shard


@torch.no_grad()
def shard_for_serving(model, mesh, *, fsdp: bool = False):
    """Shard ``model`` (an LM) over ``mesh`` for serving, in place, as the
    reference's serving cells place parameters (``param_specs(...,
    fsdp=fsdp)``; no optimizer state), and make ``mesh`` the active one.
    Each spec's model dim is cut to this rank's slice (``shard_model``).
    Its ``prefill`` and ``decode_step`` then take this rank's rows (a data
    degree dp > 1: its row shard of a batch dp divides, as ``batch_specs``
    places it; the whole of one it does not, within
    ``sharding.row_shards(1)``) and keep this rank's shard of each cache
    (``sharding.cache_specs``).  Returns ``model``.

    ``fsdp`` is the cells' weight-gathered serving (``serve_fsdp``): each
    parameter whose spec also names the data axes keeps only this rank's
    data shard on the dim ``train_loop._shard_dims(..., fsdp=True)`` gives
    (the rule training shards by: a stacked leaf's layers each on a dim of
    their own where the spec takes the layer dim), and the serving paths
    gather a block's parameters whole over the data group just before the
    block runs and drop them after it
    (``gathered``), the embedding and the head alike.  This is not FSDP2:
    the gathers are this module's own explicit collectives around each
    block's forward (serving has no backward to reshard for), which gloo
    carries on the card where ranks share one (NCCL cannot)."""
    from repro_torch.training.train_loop import _shard_dims
    shd.set_active_mesh(mesh)
    ax = model_axis(mesh)
    dax = data_axis(mesh) if fsdp else None
    if ax is None and dax is None:
        return model
    moe = getattr(model.cfg, "moe", None)
    dims = _shard_dims(model, shd.axis_sizes(mesh), fsdp=fsdp,
                       n_experts=moe.n_experts if moe else 0)
    if ax is not None:
        shard_model(model, {n: md for n, (md, _) in dims.items()
                            if md is not None}, ax)
    if dax is not None:
        shard_data(model, {n: dd for n, (_, dd) in dims.items()
                           if dd is not None}, dax)
    return model


def local_cache(cache: dict, ax: ModelAxis, device) -> dict:
    """This rank's shard of the decode cache ``cache`` (nested dicts of
    tensors, e.g. on the meta device: only shapes and dtypes are read), as
    ``sharding.cache_specs`` splits it over a model axis ``ax`` (the rows
    are the caller's), newly allocated on ``device``: zeros, and -1 (an
    empty slot) in each ``pos``."""
    specs = shd.cache_specs(cache, {"model": ax.size})

    def alloc(c, spec, key):
        if isinstance(c, dict):
            return {k: alloc(c[k], spec[k], k) for k in c}
        shape = list(c.shape)
        d = model_dim(spec)
        if d is not None:
            shape[d] //= ax.size
        return torch.full(shape, -1 if key == "pos" else 0, dtype=c.dtype,
                          device=device)

    return alloc(cache, specs, "")


def whole(t, dim: Optional[int], ax: Optional[ModelAxis]):
    """``t`` gathered over the model axis along ``dim`` (a collective);
    ``t`` itself where ``dim`` is None."""
    if dim is None or ax is None:
        return t
    return all_gather(t.detach(), dim, ax)
