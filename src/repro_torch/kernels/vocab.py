"""The staged vocabulary kernels: chunk build (VocabGen) and lookup (VocabMap).

Counterparts of ``src/repro/kernels/vocab.py``; the CUDA kernels are in
``csrc/vocab.cu``.  The TPU kernels split the table into VMEM-sized
partitions walked by a sequential grid (``partitions=``); the table here
stays whole in device memory, so the split and its argument are dropped.

- ``vocab_build_chunk`` <- ``vocab_build_chunk`` / ``_build_kernel``
  (l.86 / l.58): first-occurrence position of each value of a flat int32
  chunk, ``ABSENT32`` where absent.  Values outside ``[0, capacity)`` (the
  ``-1`` padding among them) are ignored.  Each block folds its positions
  into a shared-memory table and flushes one ``atomicMin`` per distinct
  value (skipped where the table already holds a smaller position); min is
  order-independent, so the result is bit-exact.
- ``vocab_lookup`` <- ``vocab_lookup`` / ``_lookup_kernel`` (l.137 / l.118):
  ``table[x]`` where ``0 <= x < capacity`` and ``table[x] >= 0``, else
  ``n_unique`` (the OOV index).  It takes the raw table and ``n_unique``, as
  the reference's staged path does.  The kernel reads the ids as 16-byte
  vectors, 8 ids a thread with every table read in flight at once; an ``x``
  at any 4-byte offset and of any length is taken.

Each function runs its plain version (``*_plain``, also reachable as
``fn.plain``) for CPU tensors, launches its kernel for CUDA tensors, and
raises for anything else; ``LAUNCHES[name]`` counts the launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels import ref as kref
from repro_torch.kernels.backend import count_launch

ABSENT32 = kref.ABSENT32


vocab_build_chunk_plain = kref.vocab_build_chunk
vocab_lookup_plain = kref.vocab_lookup_masked


def vocab_build_chunk(values: torch.Tensor, capacity: int) -> torch.Tensor:
    """values: flat int32[n] -> first_pos int32[capacity]."""
    if backend.on_cpu(values):
        return vocab_build_chunk_plain(values, capacity)
    backend.require(values, torch.int32, "vocab_build_chunk values")
    n = values.numel()
    if values.dim() != 1 or n >= 2 ** 31:
        raise ValueError(f"vocab_build_chunk: want a flat stream of fewer "
                         f"than 2**31 values, got {list(values.shape)}")
    out = torch.empty(int(capacity), dtype=torch.int32, device=values.device)
    lib = backend.load_library()
    backend.check_launch(lib, lib.launch_vocab_build(
        values.data_ptr(), out.data_ptr(), n, int(capacity),
        backend.stream_of(values.device)), "vocab_build_chunk", values.device)
    count_launch("vocab_build_chunk")
    return out


def vocab_lookup(x: torch.Tensor, table: torch.Tensor,
                 n_unique: int) -> torch.Tensor:
    """x: int32[...] ids, table: raw int32[capacity] ranks (-1 = absent)
    -> int32[...] ranks, ``n_unique`` for absent or out-of-range ids."""
    if backend.on_cpu(x):
        return vocab_lookup_plain(x, table, n_unique)
    backend.require(x, torch.int32, "vocab_lookup ids")
    backend.require(table, torch.int32, "vocab_lookup table")
    if table.dim() != 1 or table.device != x.device:
        raise ValueError(f"vocab_lookup: want a flat table on {x.device}, "
                         f"got {list(table.shape)} on {table.device}")
    # the kernel takes x and the output at the same address modulo 16
    # bytes: for an x off a 16-byte boundary (a view) the output is a view
    # at that phase into a slightly longer allocation
    dev = x.device
    phase = (x.data_ptr() & 15) // 4
    if phase == 0:
        out = torch.empty(x.shape, dtype=torch.int32, device=dev)
    else:
        out = torch.empty(x.numel() + phase, dtype=torch.int32,
                          device=dev)[phase:].view(x.shape)
    lib = backend.load_library()
    backend.check_launch(lib, lib.launch_vocab_lookup(
        x.data_ptr(), table.data_ptr(), out.data_ptr(), x.numel(),
        table.numel(), int(n_unique), backend.stream_of(dev)),
        "vocab_lookup", dev)
    count_launch("vocab_lookup")
    return out


vocab_build_chunk.plain = vocab_build_chunk_plain
vocab_lookup.plain = vocab_lookup_plain
