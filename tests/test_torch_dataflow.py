"""The dataflow kernels' plain versions against the JAX package's Pallas
kernels in interpret mode, on programs that each package compiles from the
same pipeline and on the same numpy inputs.

The port's plain versions interpret the *encoded* tile program (the one the
CUDA kernel runs), so these tests check the encoding as well as the
arithmetic.  The CUDA kernels themselves are held against the plain
versions on the card (tests/test_torch_cuda.py and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.kernels import dataflow as rdf  # noqa: E402
from repro_torch.kernels import dataflow as df  # noqa: E402

_CACHE: dict = {}


def _pair(name: str, optimize: str = "auto"):
    """Reference (pallas, interpret) and port (cuda on the CPU) compiled
    pipelines sharing one fitted state, plus the reference's assembled
    source buffers and OOV-resolved tables as numpy."""
    key = (name, optimize)
    if key not in _CACHE:
        ref_t, port_t = tp.build_pair(tp.BUILDERS[name])
        ref = ref_t.compile("pallas", interpret=True, optimize=optimize)
        ref.fit(tp.fit_batches())
        port = port_t.compile("cuda", device="cpu", optimize=optimize)
        port.state = ref.state
        raw = tp.raw_batch()
        cols = {k: jnp.asarray(v) for k, v in ref._raw_columns(raw).items()}
        srcs = {k: np.asarray(v)
                for k, v in ref._assemble_sources_jnp(cols).items()}
        tables = {k: np.asarray(v) for k, v in ref._resolved_tables().items()}
        _CACHE[key] = (ref, port, srcs, tables)
    return _CACHE[key]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(a)


@pytest.mark.parametrize("name", ["I", "II", "III", "sink"])
def test_group_dataflow_plain_matches_pallas(name):
    ref, port, srcs, tables = _pair(name)
    assert len(port._active_groups) == len(ref._active_groups) == 1
    g, fn = port._active_groups[0], port._group_fns[0]
    rfn = ref._build_group_fn(ref._active_groups[0])
    want = rfn(*[srcs[b] for b in g.source_buffers],
               *[tables[v] for v in g.vocab_ids])
    got = df.apply_dataflow_plain(
        fn.program, [_t(srcs[b]) for b in g.source_buffers],
        [_t(tables[v]).reshape(-1) for v in g.vocab_ids])
    assert len(got) == len(want) == len(g.outputs)
    for out, w, o in zip(g.outputs, want, got):
        tp.assert_match(w, o, f"{name}/{out}")


@pytest.mark.parametrize("name", ["I", "II", "III", "sink"])
def test_output_dataflow_plain_matches_pallas(name):
    ref, port, srcs, tables = _pair(name, optimize="off")
    dfmap = {dp.output: dp for dp in ref.plan.dataflows}
    assert set(port._solo_fns) == set(ref._fused_programs)
    for po in ref.plan.pack:
        dp = dfmap[po.name]
        want = ref._build_dataflow_fn(po, dp)(
            *[srcs[b] for b in dp.source_buffers],
            *[tables[v] for v in dp.vocab_ids])
        (got,) = df.apply_dataflow_plain(
            port._solo_fns[po.name].program,
            [_t(srcs[b]) for b in dp.source_buffers],
            [_t(tables[v]).reshape(-1) for v in dp.vocab_ids])
        tp.assert_match(want, got, f"{name}/{po.name}")


@pytest.mark.parametrize("build_form", ["scatter", "serial"])
@pytest.mark.parametrize("name", ["II", "III", "sink"])
def test_fit_dataflow_plain_matches_pallas(name, build_form):
    ref, port, srcs, _ = _pair(name)
    plan = ref.plan
    for vid, fp in ref._fused_fit_programs.items():
        inputs = [rdf.StreamInput(b, plan.buffers[b].width,
                                  plan.buffers[b].dtype,
                                  plan.buffers[b].hex_width)
                  for b in fp.source_buffers]
        rfn = rdf.make_fit_dataflow(
            inputs, ref._tile_steps(fp.stage_ids), fp.in_buf, fp.capacity,
            partitions=max(1, -(-fp.capacity // 65536)),
            block_rows=plan.row_tile, interpret=True, build_form=build_form)
        want_fp, want_cnt = rfn(*[srcs[b] for b in fp.source_buffers])
        got_fp, got_cnt = df.fit_dataflow_plain(
            port._fit_fns[vid].program,
            [_t(srcs[b]) for b in fp.source_buffers])
        tp.assert_match(want_fp, got_fp, f"{name}/{vid}/first_pos")
        tp.assert_match(want_cnt, got_cnt, f"{name}/{vid}/counts")
        assert int(got_cnt.sum()) == srcs[fp.source_buffers[0]].shape[1] * \
            plan.buffers[fp.in_buf].width


def test_program_encoding_covers_every_opcode():
    """The kitchen-sink pipeline's encoded programs use every opcode."""
    _, port, _, _ = _pair("sink")
    ops = {i.op for fn in port._group_fns for i in fn.program.instrs}
    ops |= {i.op for fn in port._fit_fns.values() for i in fn.program.instrs}
    assert ops == set(range(1, 13))


def test_tile_rows_fit_shared_memory():
    """The kernel's row tile comes from the program's bytes per row:
    Pipeline III's grouped apply carries 524 B/row -> 64-row tiles."""
    _, port, _, _ = _pair("III")
    prog = port._group_fns[0].program
    assert prog.bytes_per_row == 52 + 208 + 4 + 52 + 104 + 104
    assert prog.tile_rows() == 64
    assert prog.smem_bytes(64) <= df.SMEM_TARGET


# packer layouts (widths, output dtype, pad_cols_to): staged_main's sparse
# output, 26 and 128 one-column blocks, staged_off's dense output in
# float32 and float16, a bool output padded to 128, rows too wide for 16 of
# them in shared memory (one block, and many)
PACK_TILE_LAYOUTS = {
    "sparse_26": ([26], np.int32, 32), "26x1": ([1] * 26, np.int32, 32),
    "128x1": ([1] * 128, np.int32, 128), "dense_13": ([13], np.float32, 16),
    "dense_13_f16": ([13], np.float16, 16), "bool_1": ([1], np.bool_, 128),
    "wide_1500": ([1500, 3, 13], np.int32, 1),
    "wide_100x20": ([100] * 20, np.uint8, 1)}


@pytest.mark.parametrize("rows", [1, 1000, 65536, 10 ** 6])
@pytest.mark.parametrize("layout", sorted(PACK_TILE_LAYOUTS))
def test_pack_tile_fits_and_aligns(layout, rows):
    """The packer's tile (``pack_tile``, on a card of 132 SMs): a multiple
    of 16 rows, so every tile of the output starts on a 16-byte boundary;
    within the shared memory of one tile and the map's 16-bit shared
    offsets and 15-bit pitches; tiles of ``PACK_TILE_BYTES`` at most, or of
    the fewest rows that give each SM ``PACK_TILES_PER_SM``; windows of
    ``PACK_WINDOW`` columns only for rows of which 16 do not fit."""
    widths, out, pad = PACK_TILE_LAYOUTS[layout]
    lay = df.make_packer(widths, [np.int32] * len(widths), out,
                         pad_cols_to=pad).program
    tile_rows, tile_cols = df.pack_tile(lay, rows, 132)
    size = np.dtype(out).itemsize
    smem = df.pack_smem_bytes(lay, tile_rows, tile_cols)
    assert tile_rows >= 16 and tile_rows % 16 == 0
    assert (tile_rows * lay.out_cols * size) % 16 == 0
    assert smem <= df.PACK_SMEM_MAX and smem // 4 < 1 << 16
    assert min(max(widths), tile_cols) < 1 << 15
    whole = df.pack_smem_bytes(lay, 16, lay.out_cols) <= df.PACK_SMEM_MAX
    assert tile_cols == (lay.out_cols if whole else df.PACK_WINDOW)
    assert whole == layout.startswith(("sparse", "26x1", "128x1", "dense",
                                       "bool"))
    if whole and tile_rows > 16:
        assert tile_rows * max(4 * sum(widths), size * lay.out_cols) <= \
            df.PACK_TILE_BYTES
        assert (tile_rows - 16) * df.PACK_TILES_PER_SM * 132 < rows or \
            tile_rows == df._pack_tile_max(lay)[0]


# ---------------------------------------------------------------------------
# the encoding the redesigned kernels run: column map, barriers, launch
# struct, and the fit's edge values
# ---------------------------------------------------------------------------

def _lm(ns):
    return ns.pipeline.lm_token_pipeline(16, 1000, batch_size=64)


MAP_BUILDERS = {**tp.BUILDERS, "lm": _lm}


def _programs(name: str):
    """(kind, output names or vocab id, program) of every dataflow kernel
    the port compiles for a pipeline, grouped and ungrouped."""
    _, port_t = tp.build_pair(MAP_BUILDERS[name])
    out = []
    for optimize in ("auto", "off"):
        p = port_t.compile("cuda", device="cpu", optimize=optimize)
        out += [("group", tuple(g.outputs), fn.program)
                for g, fn in zip(p._active_groups, p._group_fns)]
        out += [("solo", (po,), fn.program) for po, fn in p._solo_fns.items()]
        out += [("fit", vid, fn.program) for vid, fn in p._fit_fns.items()]
    return p.plan, out


@pytest.mark.parametrize("name", sorted(MAP_BUILDERS))
def test_column_map_equals_term_list(name):
    """Every output column of every apply program maps to its terminal's
    (slot, column), in pack order, then padding up to ``pad_cols_to``."""
    plan, progs = _programs(name)
    pack = {po.name: po for po in plan.pack}
    n_apply = 0
    for kind, outputs, prog in progs:
        if kind == "fit":
            assert prog.colmap == []
            continue
        n_apply += 1
        slot_of = {s.name: i for i, s in enumerate(prog.slots)}
        want, cols = [], []
        for o in outputs:
            po = pack[o]
            terms = [(slot_of[b], c) for b in po.buffers
                     for c in range(plan.buffers[b].width)]
            n = -(-max(len(terms), 1) // po.pad_cols_to) * po.pad_cols_to
            want += terms + [(-1, 0)] * (n - len(terms))
            cols.append(n)
        assert prog.colmap == want, (name, outputs)
        assert prog.out_cols == cols
    assert n_apply


@pytest.mark.parametrize("name", sorted(MAP_BUILDERS))
def test_instructions_without_barrier_are_read_elementwise(name):
    """A barrier may be left out after instruction k only if every reader
    of its output up to the next barrier is an elementwise opcode over an
    output of the same width (it reads the element the same thread wrote);
    ONEHOT, CROSS and the last instruction always keep theirs."""
    from repro_torch.core import operators as ops_lib
    _, progs = _programs(name)
    for kind, what, prog in progs:
        ins, slots, sync = prog.instrs, prog.slots, prog.sync
        assert len(sync) == len(ins)
        if ins:
            assert sync[-1], (kind, what)
        for k, a in enumerate(ins):
            if a.op in (ops_lib.OP_ONEHOT, ops_lib.OP_CROSS):
                assert sync[k], (kind, what, k)
            if sync[k]:
                continue
            for b in ins[k + 1:sync.index(True, k) + 1]:
                reads = [b.a] + ([b.b] if b.op == ops_lib.OP_CROSS else [])
                if a.dst in reads:
                    assert b.op != ops_lib.OP_ONEHOT, (kind, what, k)
                    assert slots[b.dst].width == slots[a.dst].width
    if name == "III":  # two elementwise chains: one barrier, at the end
        group = next(p for kind, _, p in progs if kind == "group")
        assert group.sync == [False] * 5 + [True]


@pytest.mark.parametrize("rows", [1000, 7])
def test_cached_launch_struct_equals_fresh_build(rows):
    """A call's launch struct, copied from the program's cached template,
    equals one built from scratch byte for byte, for two sets of tensors;
    the template itself keeps no pointer and no row count."""
    _, port, _, _ = _pair("III")
    for fn in (port._group_fns[0], port._fit_fns[next(iter(port._fit_fns))]):
        prog = fn.program
        for seed in (0, 1):
            rng = np.random.default_rng(seed)
            srcs = [torch.tensor(rng.integers(
                0, 100, size=((s.hex_width, rows, s.width) if s.hex_width
                              else (rows, s.width))).astype(
                np.uint8 if s.hex_width else np.float32))
                for s in prog.slots[:prog.n_src]]
            tables = [torch.zeros(cap, dtype=torch.int32)
                      for cap in prog.capacities]
            df._c_program(prog, srcs[::-1], tables, rows + 1)  # caches
            cached = df._c_program(prog, srcs, tables, rows)
            prog.template = None
            fresh = df._c_program(prog, srcs, tables, rows)
            assert bytes(cached) == bytes(fresh)
            assert cached.n_rows == rows
            assert [cached.src[i] for i in range(len(srcs))] == \
                [x.data_ptr() for x in srcs]
        assert prog.template is not None
        assert prog.template.n_rows == 0 and not any(prog.template.src)


@pytest.mark.parametrize("build_form", ["scatter", "serial"])
@pytest.mark.parametrize("case", tp.FIT_EDGE_CASES)
def test_fit_plain_on_edge_values_matches_pallas(case, build_form):
    """Hex2Int straight into the fit (no Modulus): every value equal, every
    value distinct (more per tile than the kernel's shared table holds),
    and negative, missing and >= capacity values, against the reference's
    fit kernel in interpret mode."""
    from repro.kernels import ref as rkref
    from repro_torch.core import operators as pops
    rows, width, capacity = 300, 26, 8192
    hexes = tp.fit_edge_values(case, rows, width, capacity)
    rfn = rdf.make_fit_dataflow(
        [rdf.StreamInput("h", width, np.uint8, 8)],
        [rdf.TileStep("map", "v", ("h",), fn=rkref.hex2int_digit_major)],
        "v", capacity, block_rows=128, interpret=True, build_form=build_form)
    want_fp, want_cnt = rfn(hexes)
    fn = df.make_fit_dataflow(
        [df.StreamInput("h", width, np.dtype(np.uint8), 8)],
        [df.TileStep("map", "v", ("h",), (pops.Hex2Int(8),))], "v", capacity)
    got_fp, got_cnt = fn(_t(hexes))
    tp.assert_match(want_fp, got_fp, f"{case}/first_pos")
    tp.assert_match(want_cnt, got_cnt, f"{case}/counts")
    if case == "distinct":  # a full tile overflows the shared table
        assert int(got_cnt.sum()) == rows * width
        assert fn.program.tile_rows() * width > df.FIT_SLOTS
        assert rows >= fn.program.tile_rows()
    if case == "equal":
        assert int(got_cnt[0x1ABC]) == rows * width
        assert int(got_fp[0x1ABC]) == 0


def test_wide_output_lowers_to_the_dataflow_kernel():
    """An output of 2,048 columns (an LM batch's labels) still lowers to the
    fused kernel: the launch struct carries terminals, not columns.  The
    outputs equal the numpy oracle."""
    from repro_torch.core.pipeline import lm_token_pipeline
    from repro_torch.data import synth
    t = lm_token_pipeline(2048, 1000, batch_size=8)
    port = t.compile("cuda", device="cpu")
    assert port.lowering_report()["labels"]["path"] == "fused"
    progs = [fn.program for fn in list(port._solo_fns.values())
             + port._group_fns]
    assert any(sum(p.out_cols) >= 2048 for p in progs)
    raw = next(synth.lm_event_batches(2048, rows=8, batch_size=8))
    got = port(raw)
    want = t.compile("numpy")(raw)
    for k, w in want.items():
        tp.assert_match(w, got[k], k)
