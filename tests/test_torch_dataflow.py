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
