"""Streaming dataflow kernels on Hopper (paper §3: the full FPGA pipeline).

The JAX package lowers each ``DataflowGroup`` / fused ``PackOutput`` / fused
``VocabFit`` to one Pallas kernel whose body is *traced* from per-operator
jnp expressions.  CUDA C++ has no tracer, so the port compiles ONE
interpreter kernel (``csrc/dataflow.cu``) and hands it each pipeline's
program as data:

- ``encode_program`` turns the compiler's ``TileStep`` list into a
  ``TileProgram``: slots (one per tile buffer: stream inputs first, then
  every step output), instructions (opcode + slots + parameters, from
  ``Operator.encode``), the packer epilogue's terminals, and for the fit the
  value slot and capacity.
- The kernel: a persistent grid of blocks walks the row tiles
  (``TileProgram.tile_rows``: the plan's ``row_tile``, halved until one
  block's shared memory fits ``SMEM_TARGET``).  Each block
  keeps a two-stage ring of source tiles in shared memory, the next tile's
  sources in flight as bulk async copies while the current one runs; the
  instructions run with a barrier only where ``encode_program`` marks one
  (``TileProgram.sync``).  Then it either writes every packed output from
  a column map it expands from the terminals once per block
  (``TileProgram.colmap``: per output column a (slot, column) pair or
  padding; zeros in padding columns, cast to the output dtype) or folds the tile's values into a shared-memory table of (value,
  count, first position) and flushes each entry to global
  ``first_pos``/``counts`` with one ``atomicAdd`` and one ``atomicMin``
  (fit; both combiners are order-independent, so the result
  is bit-exact).
- The plain version of each kernel (``*_plain``) interprets the *same*
  ``TileProgram`` with PyTorch ops on whole tensors, so the tests check the
  encoding too.  A wrapper runs the plain version only for tensors on the
  CPU; for CUDA tensors it launches the kernel or raises.

Kernels and the TPU kernels they replace (``src/repro/kernels/dataflow.py``):

- ``group_dataflow``  <- ``make_group_dataflow`` (l.367): several outputs of
  one ``DataflowGroup`` from one launch.
- ``output_dataflow`` <- ``make_output_dataflow`` (l.299): the one-output case
  of the same kernel.
- ``fit_dataflow``    <- ``make_fit_dataflow`` (l.440): decode + bound + chunk
  first-occurrence/count build.  The TPU kernel's ``partitions`` split of
  the accumulators is a VMEM artefact and is dropped.

The staged lowering's two elementwise kernels (``csrc/stage.cu``; the
stage takes the same opcode encoding):

- ``fused_stage`` <- ``make_fused_stage`` (l.93): one stage's elementwise
  chain (a ``StageProgram``) over a whole buffer, cast to the output dtype;
  16 hex elements (one 16-byte load per digit plane) or 4 words a thread.
- ``packer``      <- ``make_packer`` (l.149): concatenate column blocks,
  cast, zero-pad the width; one block of threads per tile of rows
  (``pack_tile``), the blocks' rows copied into shared memory and the
  output gathered through a column map, 16 bytes a store.

Sizes and dtypes: a program within ``NARROW`` (8 sources, 24 slots, 32
instructions, 4 tables, 4 outputs, 16 terminals, 64 parameters) travels in
the kernel's ``Program`` struct, under 4 KiB; a larger one, up to ``WIDE``,
in ``WideProgram`` (25 KB of parameters, which CUDA 12.1+ allows); past
that ``encode_program`` raises and names the limit.  A packer takes up to
``MAX_WIDE_BLOCK`` blocks.  Buffers inside a program are float32 or int32;
an output may be of any dtype the JAX package's kernels return (float32,
int32, float16, bfloat16, int8, uint8, int16, uint16, uint32, bool), cast
once at the store as torch's ``.to`` casts.

What bounds them on an H100: bytes.  Per row they read the raw sources once
and write the packed outputs once, with a few integer operations per byte,
far below the card's operations-per-byte balance.  The design keeps every
intermediate in shared memory (no HBM tensor between operators, as on the
TPU); the vocabulary table (2 MiB at capacity 524288) is gathered from global
memory through L2 rather than staged per tile.  The fit's shared-memory
table takes the hottest ids (synthetic ids are Zipf(1.3): one id is a
quarter of a chunk's values) off the global atomics.  The launch struct is
built once per program; a call copies it and sets its pointers and row
count.

Every runner a factory returns carries ``runner.plain``, its plain version
as a function of the same arguments, so a caller can hold ``runner(*args)``
against ``runner.plain(*args)`` on the card.  Launch counts: each wrapper
adds one to ``LAUNCHES[name]`` (``kernels/backend.py``) where it launches
its CUDA kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import operators as ops_lib
from repro_torch.kernels import backend
from repro_torch.kernels import ref as kref
from repro_torch.kernels.backend import (  # noqa: F401
    LAUNCHES, count_launch, reset_launch_counts)

ABSENT32 = kref.ABSENT32

# buffer kinds (a program's buffers are f32 or i32, or raw hex sources) and
# the further kinds an output may take (mirrored by ``Kind`` in ops.cuh)
KIND_F32, KIND_I32, KIND_HEX = 0, 1, 2
KIND_F16, KIND_BF16, KIND_I8, KIND_U8 = 3, 4, 5, 6
KIND_I16, KIND_U16, KIND_U32, KIND_BOOL = 7, 8, 9, 10
_KIND_DTYPE = {KIND_F32: torch.float32, KIND_I32: torch.int32,
               KIND_HEX: torch.uint8, KIND_F16: torch.float16,
               KIND_BF16: torch.bfloat16, KIND_I8: torch.int8,
               KIND_U8: torch.uint8, KIND_I16: torch.int16,
               KIND_U16: torch.uint16, KIND_U32: torch.uint32,
               KIND_BOOL: torch.bool}
# output dtypes by name: every dtype the JAX package's kernels return (it
# refuses float64 and the 64-bit integers)
_OUT_KIND = {"float32": KIND_F32, "int32": KIND_I32, "float16": KIND_F16,
             "bfloat16": KIND_BF16, "int8": KIND_I8, "uint8": KIND_U8,
             "int16": KIND_I16, "uint16": KIND_U16, "uint32": KIND_U32,
             "bool": KIND_BOOL}


@dataclasses.dataclass(frozen=True)
class Limits:
    """Maxima of one instantiation of the kernel's by-value program struct
    (``ProgramT`` in dataflow.cu)."""

    src: int
    slot: int
    instr: int
    table: int
    out: int
    term: int
    param: int


# ``Program``: within these the struct stays under the classic 4 KiB of
# kernel parameters; ``WideProgram`` (25 KB) takes every larger program up
# to its own maxima, through CUDA 12.1's 32,764 bytes of parameters
NARROW = Limits(src=8, slot=24, instr=32, table=4, out=4, term=16, param=64)
WIDE = Limits(src=128, slot=384, instr=384, table=128, out=16, term=128,
              param=512)
MAX_INSTR, MAX_PARAM = NARROW.instr, NARROW.param  # a staged chain's maxima
FIT_SLOTS = 1024  # entries of the fit's shared-memory table
MAX_TERM_WIDTH = 1 << 14  # a terminal's row pitch (4 B a column) fits 16 bits
# column blocks of one packer: PackArgs takes up to MAX_BLOCK, WidePackArgs
# up to MAX_WIDE_BLOCK (mirrored in stage.cu; both under 4 KiB)
MAX_BLOCK, MAX_WIDE_BLOCK = 32, 128
THREADS = 256
# shared memory one block asks for: ~64 KiB lets three blocks share an SM
SMEM_TARGET = 64 * 1024
SMEM_MAX = 227 * 1024
# the plan's default row tile (the planner's DATAFLOW_BLOCK_ROWS): the most
# rows a tile of the dataflow kernels has
ROW_TILE = 256

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# uint16 / uint32 outputs of the plain versions are built as their signed
# twins' bits and viewed at the end: PyTorch's CUDA indexing does not take
# the unsigned dtypes (index_cuda is not implemented for UInt16 / UInt32)
_STORE_AS = {KIND_U16: torch.int16, KIND_U32: torch.int32}


def _cast(x: torch.Tensor, kind: int) -> torch.Tensor:
    """An f32 / i32 tensor cast to output kind ``kind`` as the kernels cast
    (``cast_out`` in csrc/ops.cuh: torch's ``.to``), held in ``_STORE_AS``'s
    dtype for uint16 / uint32 (in range the same bits; float -> uint32
    truncates through int64)."""
    if kind == KIND_U32:
        x = x.to(torch.int64) if x.is_floating_point() else x
        return x.to(torch.int32)
    if kind == KIND_U16:
        return x.to(torch.int32).to(torch.int16)
    return x.to(_KIND_DTYPE[kind])


def _as_kind(x: torch.Tensor, kind: int) -> torch.Tensor:
    """The tensor ``_cast`` built, in the output kind's dtype."""
    return x.view(_KIND_DTYPE[kind]) if kind in _STORE_AS else x


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _kind_of(dtype) -> int:
    """The kind of a buffer inside a program: float32 or int32."""
    kind = _OUT_KIND.get(_dtype_name(dtype))
    if kind not in (KIND_F32, KIND_I32):
        raise NotImplementedError(
            f"the dataflow kernels carry float32/int32 buffers, not {dtype}")
    return kind


def _out_kind_of(dtype) -> int:
    """The kind of an output: any dtype the JAX package's kernels return."""
    kind = _OUT_KIND.get(_dtype_name(dtype))
    if kind is None:
        raise NotImplementedError(
            f"the kernels write {sorted(_OUT_KIND)} outputs, not {dtype}")
    return kind


# ---------------------------------------------------------------------------
# the compiler's side: streamed inputs, tables, steps, outputs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamInput:
    """One raw column block streamed through the kernel, row-tiled."""

    name: str
    width: int
    dtype: np.dtype
    hex_width: int = 0  # > 0: digit-major uint8[hex_width, rows, width]


@dataclasses.dataclass(frozen=True)
class TableInput:
    """One frozen, OOV-resolved vocabulary table (int32[capacity])."""

    vocab_id: str
    capacity: int


@dataclasses.dataclass(frozen=True)
class TileStep:
    """One operator application inside the kernel body.

    kind:
      "map"    — a chain of unary operators (``ops``; a hex input must start
                 with ``Hex2Int``), or a lone ``OneHot``.
      "join"   — ``Cartesian`` of two buffers (``ops == (Cartesian,)``).
      "lookup" — gather through ``tables[table]`` (rank lookup; the OOV rule
                 is pre-folded into the table, so a miss gathers n_unique).
    """

    kind: str
    out: str
    args: tuple
    ops: tuple = ()
    table: int = -1


@dataclasses.dataclass(frozen=True)
class GroupOutput:
    """The packer epilogue of one output: terminals at static offsets."""

    name: str
    terminals: tuple  # ((buffer_name, width), ...) in pack order
    out_dtype: np.dtype
    pad_cols_to: int = 1


# ---------------------------------------------------------------------------
# the encoded program
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Slot:
    name: str
    kind: int
    width: int
    hex_width: int = 0

    @property
    def bytes_per_row(self) -> int:
        return self.width * (self.hex_width if self.kind == KIND_HEX else 4)


@dataclasses.dataclass(frozen=True)
class Instr:
    op: int
    dst: int
    a: int
    b: int = -1
    i0: int = 0
    i1: int = 0
    f0: float = 0.0
    f1: float = 0.0


@dataclasses.dataclass
class TileProgram:
    """What the interpreter kernel runs: slots ``[0, n_src)`` are the stream
    inputs in order; ``sync[k]`` says a barrier follows instruction k;
    ``terms`` are ``(output, slot, column, width)``."""

    slots: list
    n_src: int
    instrs: list
    params: list
    capacities: list
    sync: list = dataclasses.field(default_factory=list)
    out_kinds: list = dataclasses.field(default_factory=list)
    out_cols: list = dataclasses.field(default_factory=list)
    terms: list = dataclasses.field(default_factory=list)
    value_slot: int = -1
    capacity: int = 0
    wide: bool = False  # past NARROW: the kernel takes ``WideProgram``
    row_tile: int = ROW_TILE  # the plan's row tile: caps ``tile_rows``
    # the call-independent launch struct, built on the first launch
    template: Optional[ctypes.Structure] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def bytes_per_row(self) -> int:
        return sum(s.bytes_per_row for s in self.slots)

    @property
    def counts(self) -> Limits:
        """What the program needs of a ``Limits``."""
        return Limits(self.n_src, len(self.slots), len(self.instrs),
                      len(self.capacities), len(self.out_cols),
                      len(self.terms), len(self.params))

    @property
    def colmap(self) -> list:
        """Every output's columns in order, each a ``(slot, column)`` pair
        or ``(-1, 0)`` for padding: what the kernel expands the terminals
        into, and what the plain version packs from."""
        cmap: list = []
        for o, n_cols in enumerate(self.out_cols):
            cols = [(s, c) for t, s, _, w in self.terms if t == o
                    for c in range(w)]
            cmap += cols + [(-1, 0)] * (n_cols - len(cols))
        return cmap

    def tile_rows(self) -> int:
        """Rows per tile: the largest power of two up to ``row_tile`` whose
        shared memory (``layout``) fits ``SMEM_TARGET`` bytes."""
        t = 1 << (max(1, self.row_tile).bit_length() - 1)
        while t > 1 and self.smem_bytes(t) > SMEM_TARGET:
            t //= 2
        if self.smem_bytes(t) > SMEM_MAX:
            raise ValueError(f"one row needs {self.bytes_per_row} bytes of "
                             f"shared memory, over the {SMEM_MAX} a block has")
        return t

    def layout(self, tile_rows: int) -> tuple:
        """``(offsets, stage_bytes, aux_off, smem_bytes)`` of one block's
        shared memory: two ring stages of the source slots (``offsets`` of a
        source are in stage 0, ``stage_bytes`` before stage 1), one copy of
        every other slot, then the apply's expanded column map and a zero
        word (8 B a column + 16) or the fit's table (12 B an entry)."""
        offs, at = [], 0
        for s in self.slots[:self.n_src]:
            offs.append(at)
            at += _round_up(tile_rows * s.bytes_per_row, 16)
        stage_bytes = at
        at = 2 * stage_bytes
        for s in self.slots[self.n_src:]:
            offs.append(at)
            at += _round_up(tile_rows * s.bytes_per_row, 16)
        aux = (12 * FIT_SLOTS if self.value_slot >= 0
               else _round_up(8 * sum(self.out_cols), 16) + 16)
        return offs, stage_bytes, at, at + aux

    def smem_bytes(self, tile_rows: int) -> int:
        return self.layout(tile_rows)[3]


_ELEMENTWISE = frozenset(range(1, 13)) - {ops_lib.OP_ONEHOT}


_LIMIT_NAMES = ("sources", "slots", "instructions", "tables", "outputs",
                "terminals", "parameters")


def _within(need: Limits, lim: Limits) -> bool:
    return all(n <= m for n, m in zip(dataclasses.astuple(need),
                                       dataclasses.astuple(lim)))


def _barriers(slots: list, instrs: list) -> list:
    """``sync[k]``: a barrier follows instruction k.  A thread writes the
    elements i, i + THREADS, ... of its instruction's output, so a reader
    may go on without a barrier only if it is an elementwise opcode over an
    output of the same width (it reads each element at the index the same
    thread wrote).  ONEHOT and CROSS always end with one, and so does the
    last instruction: the epilogue and the fit's fold read any element.
    (Every step writes a slot of its own, and a chain keeps its width, so
    no instruction overwrites what another thread still reads.)"""
    sync = [False] * len(instrs)
    written: dict = {}  # slot -> width of its writer, since the last barrier
    for j, ins in enumerate(instrs):
        width = slots[ins.dst].width
        srcs = [ins.a] + ([ins.b] if ins.op == ops_lib.OP_CROSS else [])
        if j and any(s in written and (ins.op not in _ELEMENTWISE
                                       or written[s] != width) for s in srcs):
            sync[j - 1] = True
            written.clear()
        written[ins.dst] = width
        if ins.op in (ops_lib.OP_ONEHOT, ops_lib.OP_CROSS):
            sync[j] = True
            written.clear()
    if instrs:
        sync[-1] = True
    return sync


def _instr(enc: ops_lib.Encoded, params: list, dst: int, a: int,
           b: int = -1) -> Instr:
    """One instruction; bucket boundaries go to the program's parameter
    pool as (offset, count)."""
    i0 = enc.i0
    if enc.params:
        i0 = len(params)
        params.extend(enc.params)
    return Instr(enc.op, dst, a, b, i0, enc.i1, enc.f0, enc.f1)


def encode_program(inputs: Sequence[StreamInput],
                   tables: Sequence[TableInput],
                   steps: Sequence[TileStep], *,
                   outputs: Sequence[GroupOutput] = (),
                   value_buf: Optional[str] = None,
                   capacity: int = 0,
                   row_tile: int = ROW_TILE) -> TileProgram:
    """Lower a TileStep program to the interpreter's slot/instruction form
    (``row_tile`` caps the kernel's rows per tile)."""
    slots: list = []
    index: dict = {}

    def add_slot(name: str, kind: int, width: int, hexw: int = 0) -> int:
        index[name] = len(slots)
        slots.append(Slot(name, kind, int(width), int(hexw)))
        return index[name]

    for inp in inputs:
        if inp.hex_width:
            add_slot(inp.name, KIND_HEX, inp.width, inp.hex_width)
        else:
            add_slot(inp.name, _kind_of(inp.dtype), inp.width)
    instrs: list = []
    params: list = []

    def emit(enc: ops_lib.Encoded, dst: int, a: int, b: int = -1) -> None:
        instrs.append(_instr(enc, params, dst, a, b))

    for st in steps:
        if st.kind == "map":
            a = index[st.args[0]]
            src = slots[a]
            ops = list(st.ops)
            if src.kind == KIND_HEX:
                if not ops or not isinstance(ops[0], ops_lib.Hex2Int):
                    raise TypeError("hex source must be consumed by Hex2Int first")
                dtype = np.dtype(np.uint8)
            else:
                dtype = np.dtype(np.float32 if src.kind == KIND_F32
                                 else np.int32)
            width = src.width * int(np.prod([op.width_factor() for op in ops]))
            out_dtype = dtype
            for op in ops:
                out_dtype = op.out_dtype(out_dtype)
            dst = add_slot(st.out, _kind_of(out_dtype), width)
            cur = a
            for op in ops:  # first op reads the input; the rest run in place
                emit(op.encode(dtype), dst, cur)
                dtype = op.out_dtype(dtype)
                cur = dst
        elif st.kind == "join":
            (op,) = st.ops
            a, b = index[st.args[0]], index[st.args[1]]
            dst = add_slot(st.out, KIND_I32, slots[a].width)
            emit(op.encode(np.int32), dst, a, b)
        elif st.kind == "lookup":
            a = index[st.args[0]]
            dst = add_slot(st.out, KIND_I32, slots[a].width)
            emit(ops_lib.VocabMap(tables[st.table].capacity).encode(
                np.int32, table=st.table), dst, a)
        else:
            raise NotImplementedError(st.kind)

    prog = TileProgram(slots=slots, n_src=len(inputs), instrs=instrs,
                       params=params,
                       capacities=[t.capacity for t in tables],
                       sync=_barriers(slots, instrs), row_tile=int(row_tile))
    for o, g in enumerate(outputs):
        widths = [int(w) for _, w in g.terminals]
        prog.out_kinds.append(_out_kind_of(g.out_dtype))
        prog.out_cols.append(_round_up(max(sum(widths), 1),
                                       max(g.pad_cols_to, 1)))
        col = 0
        for (name, w) in g.terminals:
            s = index[name]
            if slots[s].kind == KIND_HEX:
                raise NotImplementedError(f"terminal {name} is a raw hex block")
            if slots[s].width != w:
                raise ValueError(f"terminal {name}: width {slots[s].width} "
                                 f"!= declared {w}")
            if w >= MAX_TERM_WIDTH:
                raise NotImplementedError(
                    f"terminal {name}: {w} columns, over the kernel's "
                    f"{MAX_TERM_WIDTH - 1} (its row pitch is 16 bits)")
            prog.terms.append((o, s, col, int(w)))
            col += int(w)
    if value_buf is not None:
        prog.value_slot = index[value_buf]
        prog.capacity = int(capacity)
    over = [f"{n} {what} (at most {m})" for what, n, m in zip(
        _LIMIT_NAMES, dataclasses.astuple(prog.counts),
        dataclasses.astuple(WIDE)) if n > m]
    if over:
        raise NotImplementedError(
            "program exceeds the kernel's maxima: " + ", ".join(over))
    prog.wide = not _within(prog.counts, NARROW)
    return prog


# ---------------------------------------------------------------------------
# plain versions: the same program, interpreted with PyTorch ops
# ---------------------------------------------------------------------------

def _bits_to_f32(bits) -> np.ndarray:
    return np.asarray(bits, np.int32).view(np.float32)


def _run_instr(ins: Instr, env: list, prog: TileProgram, tables) -> torch.Tensor:
    x = env[ins.a]
    op = ins.op
    if op == ops_lib.OP_FILL_F32:
        return torch.where(torch.isnan(x), torch.tensor(
            ins.f0, dtype=torch.float32, device=x.device), x)
    if op == ops_lib.OP_FILL_I32:
        return torch.where(x == kref.INT_MISSING, ins.i0, x)
    if op == ops_lib.OP_CLAMP:
        lo = torch.tensor(ins.f0, dtype=torch.float32, device=x.device)
        y = torch.where(x < lo, lo, x)
        if ins.i0:
            hi = torch.tensor(ins.f1, dtype=torch.float32, device=x.device)
            y = torch.where(y > hi, hi, y)
        return y
    if op == ops_lib.OP_LOG1P:
        return torch.log1p(x)
    if op in (ops_lib.OP_BUCKET_F32, ops_lib.OP_BUCKET_I32):
        raw = prog.params[ins.i0:ins.i0 + ins.i1]
        bounds = (_bits_to_f32(raw) if op == ops_lib.OP_BUCKET_F32
                  else np.asarray(raw, np.int32))
        out = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
        for b in bounds:
            out += (x >= torch.tensor(b.item(), dtype=x.dtype,
                                      device=x.device)).to(torch.int32)
        return out
    if op == ops_lib.OP_ONEHOT:
        k = torch.arange(ins.i0, dtype=x.dtype, device=x.device)
        return (x[..., None] == k).to(torch.float32).reshape(
            x.shape[0], x.shape[1] * ins.i0)
    if op == ops_lib.OP_HEX2INT:
        return kref.hex2int_digit_major(x)
    if op == ops_lib.OP_MOD:
        return torch.remainder(x, ins.i0).to(torch.int32)
    if op == ops_lib.OP_SIGRID:
        return kref.to_int32(kref.mix32(x) % ins.i0)
    if op == ops_lib.OP_CROSS:
        h = kref.mix32(kref.mix32(x) ^ kref.mul32(kref.mix32(env[ins.b]),
                                                   ops_lib.Cartesian.GOLDEN))
        return kref.to_int32(h % ins.i0)
    if op == ops_lib.OP_LOOKUP:
        cap = prog.capacities[ins.i0]
        return tables[ins.i0][x.clamp(0, cap - 1).long()]
    raise NotImplementedError(f"opcode {op}")


def run_program_plain(prog: TileProgram, srcs, tables) -> list:
    """Interpret the program's instructions over whole tensors."""
    env: list = [None] * len(prog.slots)
    env[:prog.n_src] = list(srcs)
    for ins in prog.instrs:
        env[ins.dst] = _run_instr(ins, env, prog, tables)
    return env


def apply_dataflow_plain(prog: TileProgram, srcs, tables) -> tuple:
    """Plain version of the apply kernel (group and output dataflow): each
    output gathers its columns through the program's column map."""
    env = run_program_plain(prog, srcs, tables)
    rows = _rows(prog, srcs)
    outs, at = [], 0
    for kind, n_cols in zip(prog.out_kinds, prog.out_cols):
        cmap = prog.colmap[at:at + n_cols]
        at += n_cols
        used = sorted({s for s, _ in cmap if s >= 0})
        first, blocks, width = {}, [], 0
        for s in used:
            first[s] = width
            blocks.append(_cast(env[s], kind))
            width += env[s].shape[1]
        blocks.append(_cast(torch.zeros(rows, 1, dtype=torch.int32,
                                        device=srcs[0].device), kind))
        idx = [first[s] + c if s >= 0 else width for s, c in cmap]
        outs.append(_as_kind(torch.cat(blocks, dim=1)[:, idx], kind))
    return tuple(outs)


def fit_dataflow_plain(prog: TileProgram, srcs) -> tuple:
    """Plain version of the fit kernel: (first_pos, counts) int32."""
    vals = run_program_plain(prog, srcs, ())[prog.value_slot].reshape(-1)
    return (kref.vocab_build_chunk(vals, prog.capacity),
            kref.vocab_counts_chunk(vals, prog.capacity))


# ---------------------------------------------------------------------------
# the CUDA route
# ---------------------------------------------------------------------------

class _CSlot(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("width", ctypes.c_int),
                ("hex_width", ctypes.c_int), ("offset", ctypes.c_int)]


class _CInstr(ctypes.Structure):
    _fields_ = [("op", ctypes.c_int), ("dst", ctypes.c_int),
                ("a", ctypes.c_int), ("b", ctypes.c_int),
                ("i0", ctypes.c_int), ("i1", ctypes.c_int),
                ("f0", ctypes.c_float), ("f1", ctypes.c_float)]


class _CTerm(ctypes.Structure):
    _fields_ = [("out", ctypes.c_int), ("slot", ctypes.c_int),
                ("col", ctypes.c_int), ("width", ctypes.c_int)]


@functools.cache
def _program_type(lim: Limits) -> type:
    """The ctypes mirror of ``ProgramT`` at ``lim`` in csrc/dataflow.cu
    (checked by size when the library loads)."""

    class CProgram(ctypes.Structure):
        _fields_ = [("src", ctypes.c_void_p * lim.src),
                    ("table", ctypes.c_void_p * lim.table),
                    ("out", ctypes.c_void_p * lim.out),
                    ("first_pos", ctypes.c_void_p),
                    ("counts", ctypes.c_void_p),
                    ("n_rows", ctypes.c_int), ("tile_rows", ctypes.c_int),
                    ("smem_bytes", ctypes.c_int),
                    ("stage_bytes", ctypes.c_int),
                    ("n_src", ctypes.c_int), ("n_instr", ctypes.c_int),
                    ("n_out", ctypes.c_int), ("n_term", ctypes.c_int),
                    ("value_slot", ctypes.c_int), ("capacity", ctypes.c_int),
                    ("aux_off", ctypes.c_int),
                    ("sync_mask", ctypes.c_uint * -(-lim.instr // 32)),
                    ("table_cap", ctypes.c_int * lim.table),
                    ("out_kind", ctypes.c_int * lim.out),
                    ("out_cols", ctypes.c_int * lim.out),
                    ("slot", _CSlot * lim.slot),
                    ("instr", _CInstr * lim.instr),
                    ("term", _CTerm * lim.term),
                    ("param", ctypes.c_int * lim.param)]

    CProgram.__name__ = "CWideProgram" if lim == WIDE else "CProgram"
    return CProgram


def _rows(prog: TileProgram, srcs) -> int:
    return int(srcs[0].shape[1] if prog.slots[0].kind == KIND_HEX
               else srcs[0].shape[0])


def _check_sources(prog: TileProgram, srcs, tables, device) -> int:
    if len(srcs) != prog.n_src or len(tables) != len(prog.capacities):
        raise ValueError(f"expected {prog.n_src} sources and "
                         f"{len(prog.capacities)} tables, got {len(srcs)} "
                         f"and {len(tables)}")
    rows = _rows(prog, srcs)
    for s, x in zip(prog.slots, srcs):
        want = ((s.hex_width, rows, s.width) if s.kind == KIND_HEX
                else (rows, s.width))
        if (x.dtype != _KIND_DTYPE[s.kind] or x.shape != want
                or x.device != device or not x.is_contiguous()):
            raise ValueError(
                f"source {s.name}: want contiguous {_KIND_DTYPE[s.kind]}"
                f"{list(want)} on {device}, got {x.dtype}{list(x.shape)} "
                f"on {x.device} (contiguous={x.is_contiguous()})")
    for cap, t in zip(prog.capacities, tables):
        if (t.dtype != torch.int32 or t.numel() != cap or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"table: want contiguous int32[{cap}] on "
                             f"{device}, got {t.dtype}{list(t.shape)} on "
                             f"{t.device}")
    return rows


def _c_template(prog: TileProgram) -> ctypes.Structure:
    """The launch struct's call-independent part: layout, instructions,
    barriers, parameters and terminals (no pointers, no row count)."""
    c = _program_type(WIDE if prog.wide else NARROW)()
    t = prog.tile_rows()
    offs, c.stage_bytes, c.aux_off, c.smem_bytes = prog.layout(t)
    c.tile_rows = t
    c.n_src, c.n_instr = prog.n_src, len(prog.instrs)
    c.n_out, c.n_term = len(prog.out_cols), len(prog.terms)
    c.value_slot, c.capacity = prog.value_slot, prog.capacity
    for k, on in enumerate(prog.sync):
        if on:
            c.sync_mask[k // 32] |= 1 << (k % 32)
    for i, cap in enumerate(prog.capacities):
        c.table_cap[i] = cap
    for i, (s, off) in enumerate(zip(prog.slots, offs)):
        c.slot[i] = _CSlot(s.kind, s.width, s.hex_width, off)
    for i, ins in enumerate(prog.instrs):
        c.instr[i] = _CInstr(ins.op, ins.dst, ins.a, ins.b, ins.i0, ins.i1,
                             ins.f0, ins.f1)
    for i, p in enumerate(prog.params):
        c.param[i] = p
    for i, (kind, cols) in enumerate(zip(prog.out_kinds, prog.out_cols)):
        c.out_kind[i], c.out_cols[i] = kind, cols
    for i, term in enumerate(prog.terms):
        c.term[i] = _CTerm(*term)
    return c


def _c_program(prog: TileProgram, srcs, tables, rows: int):
    """One call's launch struct: a copy of the program's template (built on
    its first call) with the source and table pointers and the row count
    set."""
    if prog.template is None:
        prog.template = _c_template(prog)
    c = type(prog.template).from_buffer_copy(prog.template)
    c.n_rows = rows
    for i, x in enumerate(srcs):
        c.src[i] = x.data_ptr()
    for i, tb in enumerate(tables):
        c.table[i] = tb.data_ptr()
    return c


@functools.cache
def _library():
    lib = backend.load_library()
    for size, mirror in ((lib.dataflow_program_size(0), _program_type(NARROW)),
                         (lib.dataflow_program_size(1), _program_type(WIDE)),
                         (lib.stage_args_size(), _CStage),
                         (lib.pack_args_size(0), _pack_type(MAX_BLOCK)),
                         (lib.pack_args_size(1), _pack_type(MAX_WIDE_BLOCK))):
        if size != ctypes.sizeof(mirror):
            raise RuntimeError(f"a struct in csrc/ ({size} bytes) does not "
                               f"match its ctypes mirror {mirror.__name__}")
    return lib


def _launch_apply(prog: TileProgram, srcs, tables, name: str) -> tuple:
    device = srcs[0].device
    rows = _check_sources(prog, srcs, tables, device)
    outs = tuple(torch.empty(rows, cols, dtype=_KIND_DTYPE[kind], device=device)
                 for kind, cols in zip(prog.out_kinds, prog.out_cols))
    c = _c_program(prog, srcs, tables, rows)
    for i, o in enumerate(outs):
        c.out[i] = o.data_ptr()
    lib = _library()
    backend.check_launch(lib, lib.launch_dataflow_apply(
        ctypes.byref(c), int(prog.wide), backend.stream_of(device)), name,
        device)
    count_launch(name)
    return outs


def _launch_fit(prog: TileProgram, srcs) -> tuple:
    device = srcs[0].device
    rows = _check_sources(prog, srcs, (), device)
    # the launcher sets both (ABSENT32, 0) before the fold
    first_pos = torch.empty(prog.capacity, dtype=torch.int32, device=device)
    counts = torch.empty(prog.capacity, dtype=torch.int32, device=device)
    c = _c_program(prog, srcs, (), rows)
    c.first_pos, c.counts = first_pos.data_ptr(), counts.data_ptr()
    lib = _library()
    backend.check_launch(lib, lib.launch_dataflow_fit(
        ctypes.byref(c), int(prog.wide), backend.stream_of(device)),
        "fit_dataflow", device)
    count_launch("fit_dataflow")
    return first_pos, counts


# ---------------------------------------------------------------------------
# factories (the counterparts of the JAX package's make_*_dataflow)
# ---------------------------------------------------------------------------

def make_group_dataflow(inputs: Sequence[StreamInput],
                        tables: Sequence[TableInput],
                        steps: Sequence[TileStep],
                        outputs: Sequence[GroupOutput], *,
                        row_tile: int = ROW_TILE):
    """fn(*sources, *tables) -> tuple of packed tensors, one per output,
    from ONE kernel launch (plain version for CPU tensors)."""
    prog = encode_program(inputs, tables, steps, outputs=outputs,
                          row_tile=row_tile)
    n_src = len(inputs)

    def plain(*arrays):
        return apply_dataflow_plain(prog, arrays[:n_src], arrays[n_src:])

    def run(*arrays):
        if backend.on_cpu(arrays[0]):
            return plain(*arrays)
        return _launch_apply(prog, arrays[:n_src], arrays[n_src:],
                             "group_dataflow")

    run.program, run.plain = prog, plain
    return run


def make_output_dataflow(inputs: Sequence[StreamInput],
                         tables: Sequence[TableInput],
                         steps: Sequence[TileStep],
                         terminals: Sequence[tuple], out_dtype, *,
                         pad_cols_to: int = 1, row_tile: int = ROW_TILE):
    """fn(*sources, *tables) -> packed [rows, padded(sum widths)]: the
    one-output case of the group kernel."""
    out = GroupOutput("out", tuple((str(n), int(w)) for n, w in terminals),
                      np.dtype(out_dtype), pad_cols_to)
    prog = encode_program(inputs, tables, steps, outputs=[out],
                          row_tile=row_tile)
    n_src = len(inputs)

    def plain(*arrays):
        return apply_dataflow_plain(prog, arrays[:n_src], arrays[n_src:])[0]

    def run(*arrays):
        if backend.on_cpu(arrays[0]):
            return plain(*arrays)
        return _launch_apply(prog, arrays[:n_src], arrays[n_src:],
                             "output_dataflow")[0]

    run.program, run.plain = prog, plain
    return run


def make_fit_dataflow(inputs: Sequence[StreamInput],
                      steps: Sequence[TileStep],
                      value_buf: str, capacity: int, *,
                      row_tile: int = ROW_TILE):
    """fn(*sources) -> (first_pos int32[capacity], counts int32[capacity]).

    Positions are global row-major ``row * width + col`` over the chunk;
    ``ABSENT32`` marks values absent from it; values < 0 or >= capacity
    drop."""
    prog = encode_program(inputs, (), steps, value_buf=value_buf,
                          capacity=capacity, row_tile=row_tile)

    def plain(*srcs):
        return fit_dataflow_plain(prog, srcs)

    def run(*srcs):
        if backend.on_cpu(srcs[0]):
            return plain(*srcs)
        return _launch_fit(prog, srcs)

    run.program, run.plain = prog, plain
    return run


# ---------------------------------------------------------------------------
# the staged lowering: one elementwise chain per kernel, and the packer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageProgram:
    """What the stage kernel runs on every element: the chain's unary
    instructions (a hex input's first one is Hex2Int, whose ``i0`` is the
    digit count), then one cast from ``val_kind`` to ``out_kind``."""

    in_kind: int
    hex_width: int
    instrs: tuple
    params: tuple
    val_kind: int
    out_kind: int


def encode_stage(ops: Sequence, in_dtype, out_dtype,
                 hex_width: int = 0) -> StageProgram:
    """Lower one ``FusedStage`` chain to the stage kernel's encoding (the
    same opcodes as the tile program)."""
    ops = list(ops)
    if hex_width:
        if not ops or not isinstance(ops[0], ops_lib.Hex2Int):
            raise TypeError("hex source must be consumed by Hex2Int first")
        kind, dtype = KIND_HEX, np.dtype(np.uint8)
    else:
        kind = _kind_of(in_dtype)
        dtype = np.dtype(in_dtype)
    instrs: list = []
    params: list = []
    for k, op in enumerate(ops):
        if not op.fusable or op.width_factor() != 1:
            raise NotImplementedError(
                f"{op.name} is not an elementwise chain operator")
        instrs.append(_instr(op.encode(dtype), params, 1, 0 if k == 0 else 1))
        dtype = op.out_dtype(dtype)
    if len(instrs) > MAX_INSTR or len(params) > MAX_PARAM:
        raise NotImplementedError(
            f"chain exceeds the kernel's fixed maxima: {len(instrs)} "
            f"instructions, {len(params)} parameters")
    return StageProgram(kind, int(hex_width), tuple(instrs), tuple(params),
                        _kind_of(dtype), _out_kind_of(out_dtype))


def fused_stage_plain(prog: StageProgram, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the stage kernel: the same instructions, whole
    tensor at a time (env slot 0 is the input, slot 1 the chain's value)."""
    env = [x, x]
    for ins in prog.instrs:
        env[1] = _run_instr(ins, env, prog, ())
    return _as_kind(_cast(env[1], prog.out_kind), prog.out_kind)


class _CStage(ctypes.Structure):
    """Mirror of ``struct StageArgs`` in csrc/stage.cu (checked by size)."""

    _fields_ = [("src", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_longlong),
                ("in_kind", ctypes.c_int), ("hex_width", ctypes.c_int),
                ("val_kind", ctypes.c_int), ("out_kind", ctypes.c_int),
                ("n_instr", ctypes.c_int), ("n_param", ctypes.c_int),
                ("instr", _CInstr * MAX_INSTR),
                ("param", ctypes.c_int * MAX_PARAM)]


def _launch_stage(prog: StageProgram, x: torch.Tensor) -> torch.Tensor:
    backend.require(x, _KIND_DTYPE[prog.in_kind], "fused_stage input")
    if prog.in_kind == KIND_HEX and (x.dim() < 1
                                     or x.shape[0] != prog.hex_width):
        raise ValueError(f"fused_stage: want digit-major uint8"
                         f"[{prog.hex_width}, ...], got {list(x.shape)}")
    shape = x.shape[1:] if prog.in_kind == KIND_HEX else x.shape
    dtype = _KIND_DTYPE[prog.out_kind]
    # the kernel's first vector starts `head` elements in (the input's
    # first 16-byte boundary; none when hex planes lie a stride apart that
    # is no multiple of 16); the output is a view at the offset that puts
    # that element on a 16-byte boundary too
    n, phase = math.prod(shape), x.data_ptr() & 15
    if prog.in_kind == KIND_HEX:
        head = (16 - phase) % 16 if n % 16 == 0 else 0
    else:
        head = (16 - phase) % 16 // 4
    size = dtype.itemsize
    off = (-head * size) % 16 // size
    out = torch.empty(n + off, dtype=dtype, device=x.device)[off:].view(shape)
    c = _CStage(src=x.data_ptr(), out=out.data_ptr(), n=out.numel(),
                in_kind=prog.in_kind, hex_width=prog.hex_width,
                val_kind=prog.val_kind, out_kind=prog.out_kind,
                n_instr=len(prog.instrs), n_param=len(prog.params))
    for i, ins in enumerate(prog.instrs):
        c.instr[i] = _CInstr(ins.op, ins.dst, ins.a, ins.b, ins.i0, ins.i1,
                             ins.f0, ins.f1)
    for i, p in enumerate(prog.params):
        c.param[i] = p
    lib = _library()
    backend.check_launch(lib, lib.launch_fused_stage(
        ctypes.byref(c), backend.stream_of(x.device)), "fused_stage", x.device)
    count_launch("fused_stage")
    return out


def make_fused_stage(ops: Sequence, *, in_dtype, out_dtype,
                     hex_width: int = 0):
    """fn(x) -> chain(x) cast to ``out_dtype``, from ONE kernel launch.

    ``x`` is float32/int32 ``[rows, cols]`` or, with ``hex_width``,
    digit-major uint8 ``[hex_width, rows, cols]``.  The JAX factory takes a
    traced ``chain_fn``; this one takes the chain's operators, which it
    encodes once."""
    prog = encode_stage(ops, in_dtype, out_dtype, hex_width)

    def plain(x):
        return fused_stage_plain(prog, x)

    def run(x):
        if backend.on_cpu(x):
            return plain(x)
        return _launch_stage(prog, x)

    run.program, run.plain = prog, plain
    return run


@dataclasses.dataclass(frozen=True)
class PackLayout:
    """The packer's program: block kinds and widths in pack order, the
    output kind and the padded output width."""

    kinds: tuple
    widths: tuple
    out_kind: int
    out_cols: int


@functools.cache
def _pack_type(max_block: int) -> type:
    """The ctypes mirror of ``PackArgsT<max_block>`` in csrc/stage.cu
    (checked by size when the library loads)."""

    class CPack(ctypes.Structure):
        _fields_ = [("src", ctypes.c_void_p * max_block),
                    ("out", ctypes.c_void_p),
                    ("rows", ctypes.c_longlong),
                    ("out_cols", ctypes.c_int), ("n_block", ctypes.c_int),
                    ("out_kind", ctypes.c_int),
                    ("tile_rows", ctypes.c_int), ("tile_cols", ctypes.c_int),
                    ("kind", ctypes.c_int * max_block),
                    ("width", ctypes.c_int * max_block),
                    ("col", ctypes.c_int * max_block)]

    CPack.__name__ = f"CPack{max_block}"
    return CPack


# the packer's tiles (csrc/stage.cu): a tile's input and output bytes at
# most where 16 rows fit, the shared memory of one tile (no opt-in past
# 48 KiB), the output columns of a window of a row too wide for that, and
# the tiles per SM a launch has where its rows allow
PACK_TILE_BYTES = 32 * 1024
PACK_SMEM_MAX = 48 * 1024
PACK_WINDOW = 512
PACK_TILES_PER_SM = 4


def pack_smem_bytes(lay: PackLayout, tile_rows: int, tile_cols: int) -> int:
    """Shared memory of one packer tile (``pack_data`` in csrc/stage.cu):
    the column map (a word a column, one more each 32) and the zero word,
    rounded up to 16 bytes, then ``tile_rows`` rows of the window's input
    columns and the blocks' skew (``pack_skew``: 16 bytes a block, 32 every
    8th, which spreads one-column blocks over the banks)."""
    data = (tile_cols + (tile_cols >> 5) + 4) & ~3
    used = min(sum(lay.widths), tile_cols)
    n = len(lay.widths)
    return 4 * (data + tile_rows * used + 4 * (n + (n >> 3)))


@functools.cache
def _pack_tile_max(lay: PackLayout) -> tuple:
    size = _KIND_DTYPE[lay.out_kind].itemsize
    rows = min(PACK_TILE_BYTES // (4 * max(sum(lay.widths), 1)),
               PACK_TILE_BYTES // (size * lay.out_cols)) // 16 * 16
    for r in (max(rows, 16), 16):
        if pack_smem_bytes(lay, r, lay.out_cols) <= PACK_SMEM_MAX:
            return r, lay.out_cols
    return 16, PACK_WINDOW


def pack_tile(lay: PackLayout, rows: int, sms: int) -> tuple:
    """``(tile_rows, tile_cols)`` of a packer launch over ``rows`` rows on a
    card of ``sms`` SMs: the most rows, a multiple of 16 (so every tile of
    the output starts on a 16-byte boundary at any element size), whose
    input and output each take at most ``PACK_TILE_BYTES``, and few enough
    for ``PACK_TILES_PER_SM`` tiles an SM where ``rows`` allow; 16 at least;
    over the whole row when its tile fits ``PACK_SMEM_MAX``, else 16 rows in
    windows of ``PACK_WINDOW`` output columns."""
    tile_rows, tile_cols = _pack_tile_max(lay)
    spread = _round_up(-(-rows // (PACK_TILES_PER_SM * sms)), 16)
    return max(min(tile_rows, spread), 16), tile_cols


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_blocks(lay: PackLayout, blocks) -> int:
    if len(blocks) != len(lay.widths):
        raise ValueError(f"packer: expected {len(lay.widths)} blocks, got "
                         f"{len(blocks)}")
    rows = int(blocks[0].shape[0])
    for k, (b, kind, w) in enumerate(zip(blocks, lay.kinds, lay.widths)):
        if b.dim() != 2 or tuple(b.shape) != (rows, w):
            raise ValueError(f"packer block {k}: want [{rows}, {w}], got "
                             f"{list(b.shape)}")
        if b.device != blocks[0].device:
            raise ValueError(f"packer block {k} is on {b.device}, block 0 "
                             f"on {blocks[0].device}")
        backend.require(b, _KIND_DTYPE[kind], f"packer block {k}")
    return rows


def packer_plain(lay: PackLayout, blocks) -> torch.Tensor:
    """Plain version of the packer kernel."""
    _check_blocks(lay, blocks)
    packed = torch.cat([_cast(b, lay.out_kind) for b in blocks], dim=1)
    packed = torch.nn.functional.pad(packed,
                                     (0, lay.out_cols - packed.shape[1]))
    return _as_kind(packed, lay.out_kind)


def _launch_packer(lay: PackLayout, blocks) -> torch.Tensor:
    rows = _check_blocks(lay, blocks)
    device = blocks[0].device
    out = torch.empty(rows, lay.out_cols, dtype=_KIND_DTYPE[lay.out_kind],
                      device=device)
    wide = len(blocks) > MAX_BLOCK
    tile_rows, tile_cols = pack_tile(lay, rows, _sm_count(device.index))
    c = _pack_type(MAX_WIDE_BLOCK if wide else MAX_BLOCK)(
        out=out.data_ptr(), rows=rows, out_cols=lay.out_cols,
        n_block=len(blocks), out_kind=lay.out_kind, tile_rows=tile_rows,
        tile_cols=tile_cols)
    col = 0
    for k, (b, kind, w) in enumerate(zip(blocks, lay.kinds, lay.widths)):
        c.src[k], c.kind[k], c.width[k], c.col[k] = b.data_ptr(), kind, w, col
        col += w
    lib = _library()
    backend.check_launch(lib, lib.launch_packer(
        ctypes.byref(c), int(wide), backend.stream_of(device)), "packer",
        device)
    count_launch("packer")
    return out


def make_packer(col_widths: Sequence[int], in_dtypes: Sequence, out_dtype, *,
                pad_cols_to: int = 128):
    """fn(*blocks) -> packed ``[rows, padded(sum(col_widths))]`` from ONE
    kernel launch: up to ``MAX_WIDE_BLOCK`` float32/int32 ``[rows, w_k]``
    blocks concatenated, cast to ``out_dtype`` (any output dtype; float ->
    int truncates toward zero), zero-padded to a multiple of
    ``pad_cols_to``."""
    widths = tuple(int(w) for w in col_widths)
    if len(widths) != len(in_dtypes) or not 0 < len(widths) <= MAX_WIDE_BLOCK:
        raise ValueError(f"packer takes 1..{MAX_WIDE_BLOCK} blocks with one "
                         f"dtype each, got {len(widths)} widths and "
                         f"{len(in_dtypes)} dtypes")
    lay = PackLayout(tuple(_kind_of(d) for d in in_dtypes), widths,
                     _out_kind_of(out_dtype),
                     _round_up(sum(widths), max(int(pad_cols_to), 1)))

    def plain(*blocks):
        return packer_plain(lay, blocks)

    def run(*blocks):
        if backend.on_cpu(blocks[0]):
            return plain(*blocks)
        return _launch_packer(lay, blocks)

    run.program, run.plain = lay, plain
    return run
