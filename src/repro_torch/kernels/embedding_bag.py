"""The embedding-bag kernels: sum-pooled embedding lookup, plain and cached.

Counterparts of ``src/repro/kernels/embedding_bag.py``; the CUDA kernels are
in ``csrc/embedding_bag.cu``.  The TPU kernels cut the table into VMEM-sized
partitions walked by a sequential grid (``partitions=``) and the batch into
blocks (``block_batch=``); here the rows are read from device memory where
they lie, so both arguments are dropped.

- ``embedding_bag`` <- ``embedding_bag`` / ``_gather_kernel`` (l.113 /
  l.94): ``out[b] = sum_k table[indices[b, k]]``; an index outside
  ``[0, vocab)`` (the ``-1`` sentinel among them) contributes zero.
- ``embedding_bag_cached`` <- ``embedding_bag_cached`` (l.187), with
  ``_cache_gather_kernel`` (l.143) and ``_two_level_kernel`` (l.154): an
  entry reads ``cache[slot]`` where ``0 <= slot < cache_rows``, else
  ``table[cold]`` where ``slot < 0`` and ``0 <= cold < vocab``, else zero;
  ``cold_idx=None`` never reads the table.

``cached_embedding_lookup`` runs the cached kernel over every feature of a
lookahead plan at once (``_stacked_cached_bag``: stacked ``tables [T,
vocab, dim]`` and ``cache [T, cache_rows, dim]``, single-hot ``[batch, T]``
slot and cold ids), writing the ``(batch, T, dim)`` result in one launch,
counted as an ``embedding_bag_cached`` launch.  The JAX package runs this
lookup as one ``embedding_bag_cached`` call per feature and stacks the
results (``etl_runtime/lookahead.py``, l.513-517); here ``out[:, t]`` is
``embedding_bag_cached`` of feature ``t`` bit for bit.  Its kernel
(``cached_row_kernel``) needs the plan's size to fill the card, so the
single-feature call keeps the warp-per-bag kernel.

Both bag kernels pool through one routine, summing over ``nnz`` in order,
as the plain versions (``kernels/ref.py``) do: cached and uncached bags are
bit-identical when the cache rows mirror the table rows.  Tables may be
float32, float16 or bfloat16 (the JAX package's bags take any float table
and return its dtype): rows are summed in float32 and the result rounded to
the table's dtype once, as the plain versions do; any other dtype (float64,
integers) raises, and a cached bag's cache and table share one dtype.  The
index arrays are int32 ``[batch, nnz]`` whose rows may be strided (a column
slice of a wider plan matrix), but each row must be contiguous.

Each function runs its plain version (also reachable as ``fn.plain``) for
CPU tensors, launches its kernel for CUDA tensors, and raises for anything
else; ``LAUNCHES[name]`` counts the launches.

``cached_embedding_lookup`` is differentiable: its backward is plain
PyTorch, as the JAX package's is ``jnp`` outside any kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import backend
from repro_torch.kernels import ref as kref
from repro_torch.kernels.backend import count_launch

embedding_bag_plain = kref.embedding_bag
embedding_bag_cached_plain = kref.embedding_bag_cached


# table dtypes and their codes in csrc/embedding_bag.cu (BagDtype)
DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _table(x: torch.Tensor, what: str, ndim: int = 2) -> None:
    if x.dim() != ndim or x.dtype not in DTYPES:
        shape = "[rows, dim]" if ndim == 2 else "[T, rows, dim]"
        raise ValueError(f"{what}: want a float16, bfloat16 or float32 "
                         f"{shape} tensor, got {x.dtype}{list(x.shape)}")


def _same_dtype(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if a.dtype != b.dtype:
        raise ValueError(f"{what}: cache {a.dtype} and table {b.dtype} "
                         "differ")


def _ids(x: torch.Tensor, device: torch.device, what: str) -> int:
    """Check an int32 [batch, nnz] index array on ``device`` whose rows are
    contiguous; return its row stride."""
    if x.dim() != 2 or x.dtype != torch.int32 or x.device != device:
        raise ValueError(f"{what}: want int32 [batch, nnz] on {device}, got "
                         f"{x.dtype}{list(x.shape)} on {x.device}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"{what}: each row must be contiguous, strides "
                         f"{x.stride()}")
    return x.stride(0)


def _aligned(*xs: torch.Tensor) -> int:
    """1 when the 4-element path applies: dim % 4 == 0, row bases aligned
    to 4 elements (16 bytes of float32, 8 of a 16-bit type)."""
    return int(all(x.shape[-1] % 4 == 0
                   and x.data_ptr() % (4 * x.element_size()) == 0
                   for x in xs))


def embedding_bag(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """table: T[vocab, dim] (T float32, float16 or bfloat16), indices:
    int32[batch, nnz] -> T[batch, dim]."""
    _table(table, "embedding_bag table")
    if backend.on_cpu(indices):
        return embedding_bag_plain(table, indices)
    backend.require(table, table.dtype, "embedding_bag table")
    stride = _ids(indices, table.device, "embedding_bag indices")
    (batch, nnz), (vocab, dim) = indices.shape, table.shape
    out = torch.empty(batch, dim, dtype=table.dtype, device=table.device)
    lib = backend.load_library()
    backend.check_launch(lib, lib.launch_embedding_bag(
        table.data_ptr(), indices.data_ptr(), stride, out.data_ptr(), batch,
        nnz, vocab, dim, _aligned(table), DTYPES[table.dtype],
        backend.stream_of(table.device)), "embedding_bag", table.device)
    count_launch("embedding_bag")
    return out


def embedding_bag_cached(table: torch.Tensor, cache: torch.Tensor,
                         slot_idx: torch.Tensor,
                         cold_idx: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """table: T[vocab, dim], cache: T[cache_rows, dim] (T float32, float16
    or bfloat16), slot_idx and cold_idx: int32[batch, nnz] -> T[batch,
    dim]."""
    _table(table, "embedding_bag_cached table")
    _table(cache, "embedding_bag_cached cache")
    if cold_idx is not None:
        _same_dtype(cache, table, "embedding_bag_cached")
    if backend.on_cpu(slot_idx):
        return embedding_bag_cached_plain(table, cache, slot_idx, cold_idx)
    backend.require(cache, cache.dtype, "embedding_bag_cached cache")
    dev = cache.device
    slot_stride = _ids(slot_idx, dev, "embedding_bag_cached slot_idx")
    batch, nnz = slot_idx.shape
    dim = cache.shape[1]
    cold_ptr, cold_stride, vec = None, 0, _aligned(cache)
    if cold_idx is not None:
        backend.require(table, table.dtype, "embedding_bag_cached table")
        if cold_idx.shape != slot_idx.shape or table.shape[1] != dim \
                or table.device != dev:
            raise ValueError(
                f"embedding_bag_cached: cold_idx {list(cold_idx.shape)} and "
                f"table {list(table.shape)} on {table.device} do not match "
                f"slot_idx {list(slot_idx.shape)} and cache "
                f"{list(cache.shape)} on {dev}")
        cold_stride = _ids(cold_idx, dev, "embedding_bag_cached cold_idx")
        cold_ptr = cold_idx.data_ptr()
        vec = _aligned(cache, table)
    out = torch.empty(batch, dim, dtype=cache.dtype, device=dev)
    lib = backend.load_library()
    backend.check_launch(lib, lib.launch_embedding_bag_cached(
        cache.data_ptr(), table.data_ptr(), slot_idx.data_ptr(), slot_stride,
        cold_ptr, cold_stride, out.data_ptr(), batch, nnz, cache.shape[0],
        table.shape[0], dim, vec, DTYPES[cache.dtype],
        backend.stream_of(dev)), "embedding_bag_cached", dev)
    count_launch("embedding_bag_cached")
    return out


def _stacked_cached_bag(tables: torch.Tensor, cache: torch.Tensor,
                        slot_idx: torch.Tensor,
                        cold_idx: torch.Tensor) -> torch.Tensor:
    """tables: D[T, vocab, dim], cache: D[T, cache_rows, dim] (D float32,
    float16 or bfloat16), slot_idx and cold_idx: int32[batch, T] (any
    strides) -> D[batch, T, dim]."""
    _table(tables, "stacked embedding_bag_cached tables", 3)
    _table(cache, "stacked embedding_bag_cached cache", 3)
    _same_dtype(cache, tables, "stacked embedding_bag_cached")
    if backend.on_cpu(slot_idx):
        return kref.embedding_bag_cached_stacked(tables, cache, slot_idx,
                                                 cold_idx)
    backend.require(tables, tables.dtype,
                    "stacked embedding_bag_cached tables")
    backend.require(cache, cache.dtype,
                    "stacked embedding_bag_cached cache")
    dev = cache.device
    n_feat, _, dim = tables.shape
    for x, what in ((slot_idx, "slot_idx"), (cold_idx, "cold_idx")):
        if x.dtype != torch.int32 or x.dim() != 2 or x.device != dev \
                or x.shape[1] != n_feat:
            raise ValueError(
                f"stacked embedding_bag_cached {what}: want int32 "
                f"[batch, {n_feat}] on {dev}, got {x.dtype}{list(x.shape)} "
                f"on {x.device}")
    if cold_idx.shape != slot_idx.shape or tables.device != dev \
            or cache.shape[0] != n_feat or cache.shape[2] != dim:
        raise ValueError(
            f"stacked embedding_bag_cached: tables {list(tables.shape)} on "
            f"{tables.device}, cache {list(cache.shape)} on {dev}, slot_idx "
            f"{list(slot_idx.shape)} and cold_idx {list(cold_idx.shape)} do "
            "not match")
    batch = slot_idx.shape[0]
    out = torch.empty(batch, n_feat, dim, dtype=cache.dtype, device=dev)
    lib = backend.load_library()
    backend.check_launch(lib, lib.launch_embedding_bag_cached_stacked(
        cache.data_ptr(), cache.stride(0), tables.data_ptr(),
        tables.stride(0), slot_idx.data_ptr(), slot_idx.stride(0),
        slot_idx.stride(1), cold_idx.data_ptr(), cold_idx.stride(0),
        cold_idx.stride(1), out.data_ptr(), batch, n_feat, cache.shape[1],
        tables.shape[1], dim, _aligned(cache, tables), DTYPES[cache.dtype],
        backend.stream_of(dev)), "embedding_bag_cached", dev)
    count_launch("embedding_bag_cached")
    return out


embedding_bag.plain = embedding_bag_plain
embedding_bag_cached.plain = embedding_bag_cached_plain
_stacked_cached_bag.plain = kref.embedding_bag_cached_stacked


class _CachedLookup(torch.autograd.Function):
    """Forward: one ``_stacked_cached_bag`` launch, written in place as
    ``(B, T, d)``.  Backward: the table gradient through
    ``kref.scatter_add_rows`` at the original ids — the computation the
    uncached gather's autograd runs, so the two gradients are bit-equal,
    and deterministic on CUDA — and none for the cache, whose rows mirror
    table rows."""

    @staticmethod
    def forward(ctx, tables, cache, slot, cold, orig):
        ctx.save_for_backward(orig)
        ctx.tables_shape = tables.shape
        return _stacked_cached_bag(tables, cache, slot, cold)

    @staticmethod
    def backward(ctx, g):
        (orig,) = ctx.saved_tensors
        feat = torch.arange(ctx.tables_shape[0], device=g.device)
        d_tables = kref.scatter_add_rows(ctx.tables_shape, orig, g, (feat,))
        return d_tables, None, None, None, None


def cached_embedding_lookup(tables: torch.Tensor, cache: torch.Tensor,
                            slot: torch.Tensor, cold: torch.Tensor,
                            orig: torch.Tensor) -> torch.Tensor:
    """Differentiable per-feature cached lookup: ``(B, T)`` single-hot
    indices against stacked ``tables [T, V, d]`` and ``cache [T, C, d]``,
    returning ``(B, T, d)``.  ``slot`` / ``cold`` are the lookahead plan's
    int32 remap, ``orig`` the original row ids (their gradient target)."""
    return _CachedLookup.apply(tables, cache, slot, cold, orig)
