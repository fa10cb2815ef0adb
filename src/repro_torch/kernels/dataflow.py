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
- The kernel: one thread block per tile of rows loads every source tile into
  shared memory, runs the instructions over the tile with a barrier between
  them, then either writes every packed output (apply: zeros in padding
  columns, cast to the output dtype) or folds the value tile into global
  ``first_pos``/``counts`` with ``atomicMin``/``atomicAdd`` (fit; both
  combiners are order-independent, so the result is bit-exact).
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

What bounds them on an H100: bytes.  Per row they read the raw sources once
and write the packed outputs once, with a few integer operations per byte,
far below the card's operations-per-byte balance.  The design keeps every
intermediate in shared memory (no HBM tensor between operators, as on the
TPU); the vocabulary table (2 MiB at capacity 524288) is gathered from global
memory through L2 rather than staged per tile.  The fit's atomics contend on
the hottest ids (synthetic ids are Zipf(1.3)).

Launch counts: each wrapper adds one to ``LAUNCHES[name]`` where it launches
its CUDA kernel and nowhere else; ``reset_launch_counts`` zeroes them.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import operators as ops_lib
from repro_torch.kernels import backend
from repro_torch.kernels import ref as kref

ABSENT32 = kref.ABSENT32

KIND_F32, KIND_I32, KIND_HEX = 0, 1, 2
_KIND_DTYPE = {KIND_F32: torch.float32, KIND_I32: torch.int32,
               KIND_HEX: torch.uint8}
_NP_KIND = {np.dtype(np.float32): KIND_F32, np.dtype(np.int32): KIND_I32}

# fixed maxima of the by-value program struct (mirrored in dataflow.cu);
# the struct stays under the 4 KiB kernel-parameter limit
MAX_SRC, MAX_SLOT, MAX_INSTR, MAX_TABLE = 8, 24, 32, 4
MAX_OUT, MAX_TERM, MAX_PARAM = 4, 16, 64
THREADS = 256
# shared memory one block asks for: ~64 KiB lets three blocks share an SM
SMEM_TARGET = 64 * 1024
SMEM_MAX = 227 * 1024

LAUNCHES = {"group_dataflow": 0, "output_dataflow": 0, "fit_dataflow": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _kind_of(dtype) -> int:
    kind = _NP_KIND.get(np.dtype(dtype))
    if kind is None:
        raise NotImplementedError(
            f"the dataflow kernels carry float32/int32 buffers, not {dtype}")
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
    inputs in order; ``terms`` are ``(output, slot, column, width)``."""

    slots: list
    n_src: int
    instrs: list
    params: list
    capacities: list
    out_kinds: list = dataclasses.field(default_factory=list)
    out_cols: list = dataclasses.field(default_factory=list)
    terms: list = dataclasses.field(default_factory=list)
    value_slot: int = -1
    capacity: int = 0

    @property
    def bytes_per_row(self) -> int:
        return sum(s.bytes_per_row for s in self.slots)

    def tile_rows(self) -> int:
        """Rows per thread block: the largest power of two up to 256 whose
        tile of every slot fits ``SMEM_TARGET`` bytes."""
        t = 256
        while t > 1 and self.smem_bytes(t) > SMEM_TARGET:
            t //= 2
        if self.smem_bytes(t) > SMEM_MAX:
            raise ValueError(f"one row needs {self.bytes_per_row} bytes of "
                             f"shared memory, over the {SMEM_MAX} a block has")
        return t

    def slot_offsets(self, tile_rows: int) -> list:
        offs, at = [], 0
        for s in self.slots:
            offs.append(at)
            at += _round_up(tile_rows * s.bytes_per_row, 16)
        return offs

    def smem_bytes(self, tile_rows: int) -> int:
        return sum(_round_up(tile_rows * s.bytes_per_row, 16)
                   for s in self.slots)


def encode_program(inputs: Sequence[StreamInput],
                   tables: Sequence[TableInput],
                   steps: Sequence[TileStep], *,
                   outputs: Sequence[GroupOutput] = (),
                   value_buf: Optional[str] = None,
                   capacity: int = 0) -> TileProgram:
    """Lower a TileStep program to the interpreter's slot/instruction form."""
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
        i0, i1 = enc.i0, enc.i1
        if enc.params:  # bucket boundaries: (offset, count) into the pool
            i0 = len(params)
            params.extend(enc.params)
        instrs.append(Instr(enc.op, dst, a, b, i0, i1, enc.f0, enc.f1))

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
                       capacities=[t.capacity for t in tables])
    for o, g in enumerate(outputs):
        widths = [int(w) for _, w in g.terminals]
        prog.out_kinds.append(_kind_of(g.out_dtype))
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
            prog.terms.append((o, s, col, int(w)))
            col += int(w)
    if value_buf is not None:
        prog.value_slot = index[value_buf]
        prog.capacity = int(capacity)
    if (len(inputs) > MAX_SRC or len(slots) > MAX_SLOT
            or len(instrs) > MAX_INSTR or len(tables) > MAX_TABLE
            or len(prog.out_cols) > MAX_OUT or len(prog.terms) > MAX_TERM
            or len(params) > MAX_PARAM):
        raise NotImplementedError(
            f"program exceeds the kernel's fixed maxima: {len(inputs)} "
            f"sources, {len(slots)} slots, {len(instrs)} instructions, "
            f"{len(tables)} tables, {len(prog.out_cols)} outputs, "
            f"{len(prog.terms)} terminals, {len(params)} parameters")
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
    """Plain version of the apply kernel (group and output dataflow)."""
    env = run_program_plain(prog, srcs, tables)
    rows = _rows(prog, srcs)
    dev = srcs[0].device
    outs = [torch.zeros(rows, cols, dtype=_KIND_DTYPE[kind], device=dev)
            for kind, cols in zip(prog.out_kinds, prog.out_cols)]
    for o, s, col, w in prog.terms:
        outs[o][:, col:col + w] = env[s].to(outs[o].dtype)
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


class _CProgram(ctypes.Structure):
    """Mirror of ``struct Program`` in csrc/dataflow.cu (checked by size)."""

    _fields_ = [("src", ctypes.c_void_p * MAX_SRC),
                ("table", ctypes.c_void_p * MAX_TABLE),
                ("out", ctypes.c_void_p * MAX_OUT),
                ("first_pos", ctypes.c_void_p),
                ("counts", ctypes.c_void_p),
                ("n_rows", ctypes.c_int), ("tile_rows", ctypes.c_int),
                ("smem_bytes", ctypes.c_int), ("n_src", ctypes.c_int),
                ("n_slot", ctypes.c_int), ("n_instr", ctypes.c_int),
                ("n_table", ctypes.c_int), ("n_out", ctypes.c_int),
                ("n_term", ctypes.c_int), ("n_param", ctypes.c_int),
                ("value_slot", ctypes.c_int), ("capacity", ctypes.c_int),
                ("table_cap", ctypes.c_int * MAX_TABLE),
                ("out_kind", ctypes.c_int * MAX_OUT),
                ("out_cols", ctypes.c_int * MAX_OUT),
                ("slot", _CSlot * MAX_SLOT),
                ("instr", _CInstr * MAX_INSTR),
                ("term", _CTerm * MAX_TERM),
                ("param", ctypes.c_int * MAX_PARAM)]


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
        if (x.device != device or x.dtype != _KIND_DTYPE[s.kind]
                or tuple(x.shape) != want or not x.is_contiguous()):
            raise ValueError(
                f"source {s.name}: want contiguous {_KIND_DTYPE[s.kind]}"
                f"{list(want)} on {device}, got {x.dtype}{list(x.shape)} "
                f"on {x.device} (contiguous={x.is_contiguous()})")
    for cap, t in zip(prog.capacities, tables):
        if (t.device != device or t.dtype != torch.int32
                or t.numel() != cap or not t.is_contiguous()):
            raise ValueError(f"table: want contiguous int32[{cap}] on "
                             f"{device}, got {t.dtype}{list(t.shape)} on "
                             f"{t.device}")
    return rows


def _c_program(prog: TileProgram, srcs, tables, rows: int) -> _CProgram:
    c = _CProgram()
    t = prog.tile_rows()
    c.n_rows, c.tile_rows, c.smem_bytes = rows, t, prog.smem_bytes(t)
    c.n_src, c.n_slot, c.n_instr = prog.n_src, len(prog.slots), len(prog.instrs)
    c.n_table, c.n_out = len(prog.capacities), len(prog.out_cols)
    c.n_term, c.n_param = len(prog.terms), len(prog.params)
    c.value_slot, c.capacity = prog.value_slot, prog.capacity
    for i, x in enumerate(srcs):
        c.src[i] = x.data_ptr()
    for i, (cap, tb) in enumerate(zip(prog.capacities, tables)):
        c.table[i] = tb.data_ptr()
        c.table_cap[i] = cap
    for i, (s, off) in enumerate(zip(prog.slots, prog.slot_offsets(t))):
        c.slot[i] = _CSlot(s.kind, s.width, s.hex_width, off)
    for i, ins in enumerate(prog.instrs):
        c.instr[i] = _CInstr(ins.op, ins.dst, ins.a, ins.b, ins.i0, ins.i1,
                             ins.f0, ins.f1)
    for i, (o, s, col, w) in enumerate(prog.terms):
        c.term[i] = _CTerm(o, s, col, w)
    for i, p in enumerate(prog.params):
        c.param[i] = p
    for i, (kind, cols) in enumerate(zip(prog.out_kinds, prog.out_cols)):
        c.out_kind[i], c.out_cols[i] = kind, cols
    return c


def _library():
    lib = backend.load_library()
    if lib.dataflow_program_size() != ctypes.sizeof(_CProgram):
        raise RuntimeError("csrc/dataflow.cu Program struct does not match "
                           "the ctypes mirror")
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
    stream = torch.cuda.current_stream(device).cuda_stream
    backend.check_launch(lib, lib.launch_dataflow_apply(ctypes.byref(c), stream),
                         name, device)
    LAUNCHES[name] += 1
    return outs


def _launch_fit(prog: TileProgram, srcs) -> tuple:
    device = srcs[0].device
    rows = _check_sources(prog, srcs, (), device)
    first_pos = torch.full((prog.capacity,), ABSENT32, dtype=torch.int32,
                           device=device)
    counts = torch.zeros(prog.capacity, dtype=torch.int32, device=device)
    c = _c_program(prog, srcs, (), rows)
    c.first_pos, c.counts = first_pos.data_ptr(), counts.data_ptr()
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    backend.check_launch(lib, lib.launch_dataflow_fit(ctypes.byref(c), stream),
                         "fit_dataflow", device)
    LAUNCHES["fit_dataflow"] += 1
    return first_pos, counts


# ---------------------------------------------------------------------------
# factories (the counterparts of the JAX package's make_*_dataflow)
# ---------------------------------------------------------------------------

def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def make_group_dataflow(inputs: Sequence[StreamInput],
                        tables: Sequence[TableInput],
                        steps: Sequence[TileStep],
                        outputs: Sequence[GroupOutput]):
    """fn(*sources, *tables) -> tuple of packed tensors, one per output,
    from ONE kernel launch (plain version for CPU tensors)."""
    prog = encode_program(inputs, tables, steps, outputs=outputs)
    n_src = len(inputs)

    def run(*arrays):
        srcs, tbls = arrays[:n_src], arrays[n_src:]
        if _on_cpu(srcs[0]):
            return apply_dataflow_plain(prog, srcs, tbls)
        return _launch_apply(prog, srcs, tbls, "group_dataflow")

    run.program = prog
    return run


def make_output_dataflow(inputs: Sequence[StreamInput],
                         tables: Sequence[TableInput],
                         steps: Sequence[TileStep],
                         terminals: Sequence[tuple], out_dtype, *,
                         pad_cols_to: int = 1):
    """fn(*sources, *tables) -> packed [rows, padded(sum widths)]: the
    one-output case of the group kernel."""
    out = GroupOutput("out", tuple((str(n), int(w)) for n, w in terminals),
                      np.dtype(out_dtype), pad_cols_to)
    prog = encode_program(inputs, tables, steps, outputs=[out])
    n_src = len(inputs)

    def run(*arrays):
        srcs, tbls = arrays[:n_src], arrays[n_src:]
        if _on_cpu(srcs[0]):
            return apply_dataflow_plain(prog, srcs, tbls)[0]
        return _launch_apply(prog, srcs, tbls, "output_dataflow")[0]

    run.program = prog
    return run


def make_fit_dataflow(inputs: Sequence[StreamInput],
                      steps: Sequence[TileStep],
                      value_buf: str, capacity: int):
    """fn(*sources) -> (first_pos int32[capacity], counts int32[capacity]).

    Positions are global row-major ``row * width + col`` over the chunk;
    ``ABSENT32`` marks values absent from it; values < 0 or >= capacity
    drop."""
    prog = encode_program(inputs, (), steps, value_buf=value_buf,
                          capacity=capacity)

    def run(*srcs):
        if _on_cpu(srcs[0]):
            return fit_dataflow_plain(prog, srcs)
        return _launch_fit(prog, srcs)

    run.program = prog
    return run
