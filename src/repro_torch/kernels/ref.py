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
