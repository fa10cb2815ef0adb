"""Plain PyTorch oracles for the operations the ETL main path needs.

Each function mirrors its twin in the JAX package's ``kernels/ref.py`` bit
for bit on integers (the tests pin this on seeded inputs).  They run on any
device.  PyTorch has no shifts or remainders on ``uint32`` on the CPU, so
32-bit unsigned arithmetic is emulated in ``int64`` with ``& 0xFFFFFFFF``.
"""

from __future__ import annotations

import torch

ABSENT32 = 2 ** 31 - 1
INT_MISSING = -(2 ** 31)
MASK32 = 0xFFFFFFFF


def to_int32(u: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 bit pattern -> int32 (two's complement)."""
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for uint32 patterns held in int64, split in
    16-bit halves so no product leaves int64's range."""
    lo = (x * (c & 0xFFFF)) & MASK32
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer on uint32 patterns (int64 in, int64 out)."""
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hex2int_digit_major(x: torch.Tensor) -> torch.Tensor:
    """uint8[w, ...] ASCII-hex digit planes -> int32[...] (two's complement).

    Bytes that are not hex digits decode as the reference does
    (``c-87`` / ``c-55`` / ``c-48``, possibly negative, OR'd in as uint32);
    all-zero strings (missing) map to ``INT_MISSING``."""
    missing = (x == 0).all(dim=0)
    c = torch.where(x == 0, 48, x.to(torch.int64))
    dig = torch.where(c >= 97, c - 87, torch.where(c >= 65, c - 55, c - 48))
    dig = dig & MASK32
    val = torch.zeros(x.shape[1:], dtype=torch.int64, device=x.device)
    for i in range(x.shape[0]):
        val = ((val << 4) & MASK32) | dig[i]
    return torch.where(missing, INT_MISSING, to_int32(val))


# ---------------------------------------------------------------------------
# vocabulary build / lookup
# ---------------------------------------------------------------------------

def vocab_build_chunk(values: torch.Tensor, capacity: int) -> torch.Tensor:
    """First-occurrence position of each value within one flat chunk
    (int32[capacity], ``ABSENT32`` = absent).  Values outside
    ``[0, capacity)`` are dropped."""
    pos = torch.arange(values.numel(), dtype=torch.int32,
                       device=values.device)
    values = values.reshape(-1)
    ok = (values >= 0) & (values < capacity)
    out = torch.full((capacity,), ABSENT32, dtype=torch.int32,
                     device=values.device)
    return out.scatter_reduce_(0, values[ok].long(), pos[ok], "amin")


def vocab_counts_chunk(values: torch.Tensor, capacity: int) -> torch.Tensor:
    """Occurrence counts of one chunk (int32[capacity])."""
    values = values.reshape(-1)
    ok = (values >= 0) & (values < capacity)
    return torch.bincount(values[ok].long(),
                          minlength=capacity).to(torch.int32)


def vocab_state_init(capacity: int, device=None) -> tuple:
    """Global fit state: (first_chunk, pos_in_chunk, counts), all int32."""
    return (torch.full((capacity,), ABSENT32, dtype=torch.int32, device=device),
            torch.full((capacity,), ABSENT32, dtype=torch.int32, device=device),
            torch.zeros(capacity, dtype=torch.int32, device=device))


def vocab_merge(state: tuple, chunk_first_pos: torch.Tensor, chunk_idx: int,
                chunk_counts: torch.Tensor = None) -> tuple:
    """Merge one chunk's first positions (+counts).  Chunks arrive in
    increasing order, so only slots absent so far are filled."""
    first_chunk, pos, counts = state
    newly = (first_chunk == ABSENT32) & (chunk_first_pos != ABSENT32)
    first_chunk = torch.where(newly, chunk_idx, first_chunk)
    pos = torch.where(newly, chunk_first_pos, pos)
    if chunk_counts is not None:
        counts = counts + chunk_counts
    return first_chunk, pos, counts


def vocab_finalize(state: tuple, min_count: int = 1) -> torch.Tensor:
    """(first_chunk, pos, counts) -> int32 rank table (-1 = absent).

    The reference sorts with ``lexsort((pos, chunk))``; here one int64 key
    ``chunk << 32 | pos`` sorts the same way (present entries have distinct
    keys, and every absent one sorts after them), so ranks are exact."""
    first_chunk, pos, counts = state
    capacity = first_chunk.shape[0]
    present = first_chunk != ABSENT32
    if min_count > 1:
        present = present & (counts >= min_count)
    key_chunk = torch.where(present, first_chunk, ABSENT32).to(torch.int64)
    key = (key_chunk << 32) | pos.to(torch.int64)
    order = torch.argsort(key)
    rank = torch.empty(capacity, dtype=torch.int32, device=first_chunk.device)
    rank[order] = torch.arange(capacity, dtype=torch.int32,
                               device=first_chunk.device)
    return torch.where(present, rank, -1).to(torch.int32)


def vocab_lookup(x: torch.Tensor, table: torch.Tensor,
                 n_unique: int) -> torch.Tensor:
    """Map x through table; absent (-1) entries map to OOV index n_unique."""
    hit = table[x.long()]
    return torch.where(hit >= 0, hit, n_unique).to(torch.int32)


def vocab_lookup_masked(x: torch.Tensor, table: torch.Tensor,
                        n_unique: int) -> torch.Tensor:
    """The staged lookup kernel's rule (the masked ``_lookup_kernel`` of the
    JAX package): ids outside ``[0, capacity)`` map to ``n_unique`` like
    absent entries, where ``vocab_lookup`` would wrap a negative id."""
    ok = (x >= 0) & (x < table.shape[0])
    hit = table[torch.where(ok, x, 0).long()]
    return torch.where(ok & (hit >= 0), hit, n_unique).to(torch.int32)


# ---------------------------------------------------------------------------
# embedding bag (DLRM trainer-side hot spot)
# ---------------------------------------------------------------------------
#
# The masking is the Pallas kernels' (``kernels/embedding_bag.py``), where it
# differs from the JAX ``ref``: an index outside ``[0, vocab)`` and a slot
# outside ``[0, cache_rows)`` contribute zero (the JAX ``ref`` would
# clamp-gather them), and a slot ``>= cache_rows`` never falls through to
# the table.  Rows are pooled over ``nnz`` in order, as the CUDA kernels do.

def _pool(rows: torch.Tensor) -> torch.Tensor:
    """[batch, nnz, dim] -> [batch, dim], summed over nnz in order in
    float32 and rounded once to the rows' dtype (the shared epilogue that
    makes cached and uncached bags bit-identical; the JAX package's sum of
    a 16-bit bag runs in float32 too)."""
    out = torch.zeros(rows.shape[0], rows.shape[2], dtype=torch.float32,
                      device=rows.device)
    for k in range(rows.shape[1]):
        out = out + rows[:, k].float()
    return out.to(rows.dtype)


def _gather_rows(table: torch.Tensor, idx: torch.Tensor,
                 ok: torch.Tensor) -> torch.Tensor:
    """table[idx] where ``ok``, zero elsewhere: [batch, nnz, dim]."""
    rows = table[torch.where(ok, idx, 0).long()]
    return torch.where(ok[..., None], rows, 0)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor = None) -> torch.Tensor:
    """out[b] = sum_k w[b,k] * table[idx[b,k]]; indices outside
    ``[0, vocab)`` (the ``-1`` sentinel among them) contribute zero."""
    ok = (indices >= 0) & (indices < table.shape[0])
    rows = _gather_rows(table, indices, ok)
    if weights is not None:
        rows = rows * weights[..., None].to(rows.dtype)
    return _pool(rows)


def embedding_bag_cached(table: torch.Tensor, cache: torch.Tensor,
                         slot_idx: torch.Tensor,
                         cold_idx: torch.Tensor = None) -> torch.Tensor:
    """Two-level bag: ``cache[slot]`` where ``0 <= slot < cache_rows``, else
    ``table[cold]`` where ``slot < 0`` and ``0 <= cold < vocab``, else zero.
    ``cold_idx=None`` never reads the table."""
    hot = (slot_idx >= 0) & (slot_idx < cache.shape[0])
    rows = _gather_rows(cache, slot_idx, hot)
    if cold_idx is not None:
        cold = (slot_idx < 0) & (cold_idx >= 0) & (cold_idx < table.shape[0])
        rows = torch.where(cold[..., None],
                           _gather_rows(table, cold_idx, cold), rows)
    return _pool(rows)


def embedding_bag_cached_stacked(tables: torch.Tensor, cache: torch.Tensor,
                                 slot_idx: torch.Tensor,
                                 cold_idx: torch.Tensor) -> torch.Tensor:
    """``embedding_bag_cached`` of every feature at once, single-hot:
    ``tables [T, vocab, dim]``, ``cache [T, cache_rows, dim]``, ``slot_idx``
    / ``cold_idx [batch, T]`` -> ``[batch, T, dim]``, where ``out[:, t]`` is
    ``embedding_bag_cached(tables[t], cache[t], slot_idx[:, t:t+1],
    cold_idx[:, t:t+1])`` bit for bit."""
    feat = torch.arange(tables.shape[0], device=tables.device)
    hot = (slot_idx >= 0) & (slot_idx < cache.shape[1])
    rows = cache[feat, torch.where(hot, slot_idx, 0).long()]
    rows = torch.where(hot[..., None], rows, 0)
    cold = (slot_idx < 0) & (cold_idx >= 0) & (cold_idx < tables.shape[1])
    rows = torch.where(cold[..., None],
                       tables[feat, torch.where(cold, cold_idx, 0).long()],
                       rows)
    # _pool's 0.0 + row (-0.0 -> +0.0), in float32, rounded back
    return (torch.zeros_like(rows, dtype=torch.float32)
            + rows.float()).to(rows.dtype)


def scatter_add_rows(shape, indices: torch.Tensor, grad: torch.Tensor,
                     lead: tuple = ()) -> torch.Tensor:
    """``zeros(shape)`` with each row of ``grad`` added at its row index
    (dim -2, after the ``lead`` index tensors); indices outside
    ``[0, shape[-2])`` add nothing.  One ``index_put_(accumulate=True)``:
    the scatter the gather's autograd runs, deterministic on CUDA (sorted,
    no float atomics)."""
    ok = (indices >= 0) & (indices < shape[-2])
    out = torch.zeros(shape, dtype=grad.dtype, device=grad.device)
    return out.index_put_((*lead, torch.where(ok, indices, 0).long()),
                          torch.where(ok[..., None], grad, 0),
                          accumulate=True)


def embedding_bag_grad_table(table_shape, indices: torch.Tensor,
                             grad_out: torch.Tensor,
                             weights: torch.Tensor = None) -> torch.Tensor:
    """Gradient of ``embedding_bag`` with respect to the table
    (``scatter_add_rows``).  Indices outside ``[0, vocab)`` add nothing."""
    g = grad_out[:, None, :].expand(-1, indices.shape[1], -1)
    if weights is not None:
        g = g * weights[..., None].to(g.dtype)
    return scatter_add_rows(tuple(table_shape), indices, g)


# ---------------------------------------------------------------------------
# format-aware packer
# ---------------------------------------------------------------------------

def pack_blocks(blocks, out_dtype: torch.dtype,
                pad_cols_to: int = 1) -> torch.Tensor:
    """Concat [rows, c_i] blocks along axis 1, cast, zero-pad the width to a
    multiple of ``pad_cols_to``."""
    cat = torch.cat([b.to(out_dtype) for b in blocks], dim=1)
    total = cat.shape[1]
    padded = -(-total // pad_cols_to) * pad_cols_to
    if padded != total:
        cat = torch.nn.functional.pad(cat, (0, padded - total))
    return cat
