"""Software-defined ETL operators (paper Table 1) with fit/apply semantics.

Each operator carries three things:

1. ``numpy(x)``      — the pure-numpy oracle (the CPU pandas-baseline
   semantics), copied from the JAX package;
2. ``torch_expr(x)`` — a plain PyTorch expression of the identical
   transform (the ``torch`` backend's eager path);
3. ``encode(in_dtype)`` — the instruction the CUDA tile-program
   interpreter runs (``kernels/csrc/dataflow.cu``): an opcode plus integer
   and float parameters.  The kernels' plain versions interpret the same
   encoding with PyTorch ops, so the encoding itself is under test.

plus planner metadata (category, statefulness, fusability, per-element
cost and state size for the table-placement decision).

Stateful vocabulary operators (VocabGen/VocabMap) expose the streaming fit
protocol ``init_state() -> update(state, batch, row_offset) -> finalize`` in
numpy; the compiled fit path lives in ``kernels/`` (chunk build -> merge ->
finalize).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import ref as kref

# Sentinel used for "missing" in integer columns (dense columns use NaN).
INT_MISSING = np.int32(-(2 ** 31))

DENSE, SPARSE, BOTH = "dense", "sparse", "both"

# Opcodes of the tile-program interpreter; the values are mirrored by the
# ``enum Op`` in kernels/csrc/dataflow.cu.
OP_FILL_F32 = 1
OP_FILL_I32 = 2
OP_CLAMP = 3
OP_LOG1P = 4
OP_BUCKET_F32 = 5
OP_BUCKET_I32 = 6
OP_ONEHOT = 7
OP_HEX2INT = 8
OP_MOD = 9
OP_SIGRID = 10
OP_CROSS = 11
OP_LOOKUP = 12


@dataclasses.dataclass(frozen=True)
class Encoded:
    """One interpreter instruction's operator part (slots are added by the
    program encoder).  ``params`` are int32 bit patterns (float boundaries
    are stored as their float32 bits)."""

    op: int
    i0: int = 0
    i1: int = 0
    f0: float = 0.0
    f1: float = 0.0
    params: tuple = ()


def _mix32_np(x: np.ndarray) -> np.ndarray:
    """lowbias32 finalizer (32-bit splitmix analogue). uint32 -> uint32."""
    x = x.astype(np.uint32)
    x ^= x >> 16
    x = (x * np.uint32(0x7FEB352D)).astype(np.uint32)
    x ^= x >> 15
    x = (x * np.uint32(0x846CA68B)).astype(np.uint32)
    x ^= x >> 16
    return x


def _is_float(dtype) -> bool:
    return np.issubdtype(np.dtype(dtype), np.floating)


@dataclasses.dataclass
class Operator:
    """Base class. Subclasses are cheap, declarative dataclasses."""

    category: str = dataclasses.field(default=BOTH, init=False)
    stateful: bool = dataclasses.field(default=False, init=False)
    # fusable: elementwise + shape-preserving -> can join a fused stage
    fusable: bool = dataclasses.field(default=True, init=False)
    flops_per_elem: float = dataclasses.field(default=1.0, init=False)

    @property
    def name(self) -> str:
        return type(self).__name__

    def out_dtype(self, in_dtype: np.dtype) -> np.dtype:
        return np.dtype(in_dtype)

    def width_factor(self) -> int:
        return 1

    def numpy(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def torch_expr(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def encode(self, in_dtype) -> Encoded:
        raise NotImplementedError(f"{self.name} has no kernel encoding")

    def validate(self, in_dtype: np.dtype) -> None:
        del in_dtype

    def state_bytes(self) -> int:
        return 0


# --------------------------------------------------------------------------
# Dense stateless operators
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Clamp(Operator):
    """Restrict values to [lo, hi]; paper default clips negatives to zero.
    NaN propagates (written as comparisons, like ``jnp.maximum``)."""

    lo: float = 0.0
    hi: float = float("inf")

    def __post_init__(self):
        self.category = DENSE

    def numpy(self, x):
        return np.clip(x, self.lo, None if np.isinf(self.hi) else self.hi)

    def torch_expr(self, x):
        lo = torch.tensor(self.lo, dtype=x.dtype, device=x.device)
        y = torch.where(x < lo, lo, x)
        if not np.isinf(self.hi):
            hi = torch.tensor(self.hi, dtype=x.dtype, device=x.device)
            y = torch.where(y > hi, hi, y)
        return y

    def encode(self, in_dtype):
        return Encoded(OP_CLAMP, i0=int(not np.isinf(self.hi)),
                       f0=float(self.lo), f1=float(self.hi))

    def validate(self, in_dtype):
        if not _is_float(in_dtype):
            raise TypeError(f"Clamp expects float input, got {in_dtype}")


@dataclasses.dataclass
class Logarithm(Operator):
    """log(x + 1): reduces skew / compresses heavy tails."""

    def __post_init__(self):
        self.category = DENSE
        self.flops_per_elem = 10.0  # transcendental

    def numpy(self, x):
        return np.log1p(x)

    def torch_expr(self, x):
        return torch.log1p(x)

    def encode(self, in_dtype):
        return Encoded(OP_LOG1P)

    def validate(self, in_dtype):
        if not _is_float(in_dtype):
            raise TypeError(f"Logarithm expects float input, got {in_dtype}")


@dataclasses.dataclass
class FillMissing(Operator):
    """Impute NaNs (float) or INT_MISSING sentinels (int) with a default."""

    default: float = 0.0

    def numpy(self, x):
        if np.issubdtype(x.dtype, np.floating):
            return np.where(np.isnan(x), np.asarray(self.default, x.dtype), x)
        return np.where(x == INT_MISSING, np.asarray(int(self.default), x.dtype), x)

    def torch_expr(self, x):
        if x.dtype.is_floating_point:
            return torch.where(torch.isnan(x), torch.tensor(
                self.default, dtype=x.dtype, device=x.device), x)
        return torch.where(x == int(INT_MISSING), int(self.default), x)

    def encode(self, in_dtype):
        if _is_float(in_dtype):
            return Encoded(OP_FILL_F32, f0=float(self.default))
        return Encoded(OP_FILL_I32, i0=int(self.default))


@dataclasses.dataclass
class Bucketize(Operator):
    """Discretize a scalar by bin boundaries: x=37, bins=[10,20,40] -> 3.

    sum(x >= b_i) with compile-time constant boundaries, cast to the input
    dtype first (as ``jnp.asarray(b, x.dtype)`` does)."""

    boundaries: Sequence[float] = ()

    def __post_init__(self):
        self.boundaries = tuple(float(b) for b in self.boundaries)
        if list(self.boundaries) != sorted(self.boundaries):
            raise ValueError("Bucketize boundaries must be sorted")
        self.flops_per_elem = float(len(self.boundaries))

    def out_dtype(self, in_dtype):
        return np.dtype(np.int32)

    def numpy(self, x):
        out = np.zeros(x.shape, np.int32)
        for b in self.boundaries:
            out += (x >= b).astype(np.int32)
        return out

    def _cast_bounds(self, in_dtype) -> np.ndarray:
        return np.asarray(self.boundaries, np.float64).astype(np.dtype(in_dtype))

    def torch_expr(self, x):
        out = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
        for b in self._cast_bounds(str(x.dtype).replace("torch.", "")):
            out = out + (x >= torch.tensor(b.item(), dtype=x.dtype,
                                           device=x.device)).to(torch.int32)
        return out

    def encode(self, in_dtype):
        bounds = self._cast_bounds(in_dtype)
        if _is_float(in_dtype):
            bits = bounds.astype(np.float32).view(np.int32)
            return Encoded(OP_BUCKET_F32, i1=len(bits),
                           params=tuple(int(b) for b in bits))
        return Encoded(OP_BUCKET_I32, i1=len(bounds),
                       params=tuple(int(b) for b in bounds.astype(np.int32)))


@dataclasses.dataclass
class OneHot(Operator):
    """Encode small-cardinality bins as K-wide indicators (expands width):
    ``out[r, c*depth + j] = float(x[r, c] == j)``; out of range -> zeros."""

    depth: int = 2

    def __post_init__(self):
        self.fusable = False  # expands the column axis
        self.flops_per_elem = float(self.depth)

    def width_factor(self) -> int:
        return self.depth

    def out_dtype(self, in_dtype):
        return np.dtype(np.float32)

    def numpy(self, x):
        x = x.astype(np.int64)
        eye = np.eye(self.depth, dtype=np.float32)
        flat = np.clip(x, 0, self.depth - 1).reshape(-1)
        out = eye[flat].reshape(x.shape + (self.depth,))
        mask = ((x >= 0) & (x < self.depth)).astype(np.float32)[..., None]
        out = out * mask
        return out.reshape(x.shape[:-1] + (x.shape[-1] * self.depth,))

    def torch_expr(self, x):
        k = torch.arange(self.depth, dtype=x.dtype, device=x.device)
        out = (x[..., None] == k).to(torch.float32)
        return out.reshape(x.shape[:-1] + (x.shape[-1] * self.depth,))

    def encode(self, in_dtype):
        return Encoded(OP_ONEHOT, i0=self.depth)

    def validate(self, in_dtype):
        if not np.issubdtype(in_dtype, np.integer):
            raise TypeError(f"OneHot expects integer input, got {in_dtype}")


# --------------------------------------------------------------------------
# Sparse stateless operators
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Hex2Int(Operator):
    """Fixed-width ASCII-hex column -> int32 (two's complement on overflow).

    The numpy oracle takes a trailing hex-digit axis uint8[rows, cols, w];
    the torch expression and the kernel take digit-major uint8[w, rows,
    cols].  All-0x00 strings are missing and map to INT_MISSING."""

    width: int = 8

    def __post_init__(self):
        self.category = SPARSE
        self.flops_per_elem = 4.0 * self.width

    def out_dtype(self, in_dtype):
        return np.dtype(np.int32)

    @staticmethod
    def _digit_np(c: np.ndarray) -> np.ndarray:
        c = c.astype(np.int64)
        return np.where(c >= 97, c - 87, np.where(c >= 65, c - 55, c - 48))

    def numpy(self, x):
        assert x.shape[-1] == self.width and x.dtype == np.uint8
        missing = np.all(x == 0, axis=-1)
        dig = self._digit_np(np.where(x == 0, np.uint8(48), x))
        val = np.zeros(x.shape[:-1], np.uint64)
        for i in range(self.width):
            val = (val << np.uint64(4)) | dig[..., i].astype(np.uint64)
        out = (val & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        return np.where(missing, INT_MISSING, out)

    def torch_expr(self, x):
        return kref.hex2int_digit_major(x)

    def encode(self, in_dtype):
        return Encoded(OP_HEX2INT, i0=self.width)

    def validate(self, in_dtype):
        if np.dtype(in_dtype) != np.uint8:
            raise TypeError(f"Hex2Int expects uint8 ASCII input, got {in_dtype}")


@dataclasses.dataclass
class Modulus(Operator):
    """Positive modulus: (-7) mod 5 -> 3. Bounds ids to [0, m)."""

    m: int = 65536

    def __post_init__(self):
        self.category = SPARSE
        if self.m <= 0:
            raise ValueError("Modulus m must be positive")

    def numpy(self, x):
        return np.mod(x.astype(np.int64), self.m).astype(np.int32)

    def torch_expr(self, x):
        return torch.remainder(x, self.m).to(torch.int32)

    def encode(self, in_dtype):
        return Encoded(OP_MOD, i0=self.m)

    def validate(self, in_dtype):
        if not np.issubdtype(in_dtype, np.integer):
            raise TypeError(f"Modulus expects integer input, got {in_dtype}")


@dataclasses.dataclass
class SigridHash(Operator):
    """Bound categorical ids: hash(id) % m (32-bit mix)."""

    m: int = 65536

    def __post_init__(self):
        self.category = SPARSE
        self.flops_per_elem = 12.0

    def numpy(self, x):
        h = _mix32_np(x.astype(np.int64).astype(np.uint32) if x.dtype != np.uint32 else x)
        return np.mod(h, np.uint32(self.m)).astype(np.int32)

    def torch_expr(self, x):
        return kref.to_int32(kref.mix32(x) % self.m)

    def encode(self, in_dtype):
        return Encoded(OP_SIGRID, i0=self.m)

    def validate(self, in_dtype):
        if not np.issubdtype(in_dtype, np.integer):
            raise TypeError(f"SigridHash expects integer input, got {in_dtype}")


@dataclasses.dataclass
class Cartesian(Operator):
    """Cross two categorical columns into a new bounded key (binary)."""

    m: int = 65536

    def __post_init__(self):
        self.category = SPARSE
        self.fusable = False  # binary: joins two streams (broadcast edge)
        self.flops_per_elem = 16.0

    GOLDEN = 0x9E3779B1

    def numpy2(self, a, b):
        ha = _mix32_np(a.astype(np.int64).astype(np.uint32))
        hb = _mix32_np(b.astype(np.int64).astype(np.uint32))
        h = _mix32_np(ha ^ (hb * np.uint32(self.GOLDEN)).astype(np.uint32))
        return np.mod(h, np.uint32(self.m)).astype(np.int32)

    def torch_expr2(self, a, b):
        ha, hb = kref.mix32(a), kref.mix32(b)
        h = kref.mix32(ha ^ kref.mul32(hb, self.GOLDEN))
        return kref.to_int32(h % self.m)

    def encode(self, in_dtype):
        return Encoded(OP_CROSS, i0=self.m)

    def numpy(self, x):  # pragma: no cover - binary op uses numpy2
        raise TypeError("Cartesian is a binary operator; use numpy2(a, b)")

    def torch_expr(self, x):  # pragma: no cover
        raise TypeError("Cartesian is a binary operator; use torch_expr2(a, b)")


# --------------------------------------------------------------------------
# Stateful vocabulary operators
# --------------------------------------------------------------------------

_POS_INF = np.int64(2 ** 62)


@dataclasses.dataclass
class VocabGen(Operator):
    """Build a value -> first-appearance-rank table over a bounded key space.

    Fit: first_pos[v] = min global position of v; counts[v] = occurrences.
    Finalize: values with counts >= min_count ranked by first_pos;
    table[v] = rank, filtered/absent = -1 (OOV at apply time)."""

    capacity: int = 65536
    min_count: int = 1

    def __post_init__(self):
        self.category = SPARSE
        self.stateful = True
        self.fusable = False

    def state_bytes(self) -> int:
        return 16 * self.capacity

    def table_bytes(self) -> int:
        return 4 * self.capacity  # frozen int32 table

    def init_state(self):
        return (np.full(self.capacity, _POS_INF, np.int64),
                np.zeros(self.capacity, np.int64))

    def update(self, state, x: np.ndarray, row_offset: int):
        first_pos, counts = state
        flat = x.reshape(-1).astype(np.int64)
        if flat.size and (flat.min() < 0 or flat.max() >= self.capacity):
            raise ValueError("VocabGen input out of [0, capacity) — add Modulus first")
        pos = row_offset + np.arange(flat.size, dtype=np.int64)
        np.minimum.at(first_pos, flat, pos)
        np.add.at(counts, flat, 1)
        return first_pos, counts

    def finalize(self, state) -> np.ndarray:
        first_pos, counts = state
        present = first_pos < _POS_INF
        if self.min_count > 1:
            present = present & (counts >= self.min_count)
        keyed = np.where(present, first_pos, _POS_INF)
        order = np.argsort(keyed, kind="stable")
        rank = np.empty(self.capacity, np.int64)
        rank[order] = np.arange(self.capacity)
        return np.where(present, rank, -1).astype(np.int32)

    @staticmethod
    def n_unique(table) -> int:
        return int((np.asarray(table) >= 0).sum())

    def numpy(self, x):  # identity in the apply phase (table already built)
        return x

    def torch_expr(self, x):
        return x


@dataclasses.dataclass
class VocabMap(Operator):
    """Map values through a frozen vocabulary table; unseen -> OOV index
    (= n_unique, so the embedding table needs n_unique + 1 rows)."""

    capacity: int = 65536

    def __post_init__(self):
        self.category = SPARSE
        self.stateful = True
        self.fusable = False
        self.flops_per_elem = 2.0

    def state_bytes(self) -> int:
        return 4 * self.capacity

    def numpy_apply(self, x: np.ndarray, table: np.ndarray) -> np.ndarray:
        n_unique = VocabGen.n_unique(table)
        hit = table[x.astype(np.int64)]
        return np.where(hit >= 0, hit, n_unique).astype(np.int32)

    def encode(self, in_dtype, table: int = 0):
        """Gather through the OOV-resolved table ``table`` (index into the
        program's table list), after clipping into ``[0, capacity)``."""
        return Encoded(OP_LOOKUP, i0=table)

    def numpy(self, x):  # pragma: no cover
        raise TypeError("VocabMap requires a table; use numpy_apply(x, table)")


ALL_OPERATORS = [Clamp, Logarithm, FillMissing, Bucketize, OneHot,
                 Hex2Int, Modulus, SigridHash, Cartesian, VocabGen, VocabMap]
