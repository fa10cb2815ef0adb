"""The staged lowering of ``repro_torch`` against the JAX package.

- Each staged kernel's plain version (``fused_stage``, ``packer``,
  ``vocab_build_chunk``, ``vocab_lookup``) against the JAX Pallas kernel in
  interpret mode, on seeded numpy inputs at the shapes of
  ``tests/test_kernels.py``, edge inputs included: NaN and negatives through
  Clamp | Log, non-hex bytes and all-zero (missing) hex, ``-1`` and
  ``>= capacity`` values in the build, ids outside ``[0, capacity)`` in the
  lookup.
- Whole pipelines whose plan sends outputs or vocabularies down the staged
  path, through the port's ``cuda`` backend on ``device="cpu"`` (the
  kernels' plain versions) against the reference's ``pallas`` backend with
  ``interpret=True``: fitted state bit-equal, outputs by the reference's
  policy, lowering reports, stage execution counts, and one counted kernel
  call per traced ``pallas_call``.

The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py and chip_smoke.py)."""

import functools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.core import operators as rops  # noqa: E402
from repro.kernels import ops as rkops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.core import operators as pops  # noqa: E402
from repro_torch.core.pipeline import paper_pipeline  # noqa: E402
from repro_torch.data.source import Source  # noqa: E402
from repro_torch.kernels import dataflow as df  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.session import EtlJob  # noqa: E402

HEXMAP = np.frombuffer(b"0123456789abcdef", np.uint8)


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng([7, zlib.crc32(repr(key).encode())])


def _ref_chain(ops, hex_width: int = 0):
    """The reference compiler's chain function for a stage (``_chain_fn``)."""
    rest = ops[1:] if hex_width else ops

    def chain(x):
        if hex_width:
            x = rref.hex2int_digit_major(x)
        return functools.reduce(lambda v, op: op.jnp_expr(v), rest, x)

    return chain


# ---------------------------------------------------------------------------
# the staged kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

DENSE_CHAINS = {  # name -> (ops from an operator module, output dtype)
    "clamp_log": (lambda o: [o.Clamp(0.0), o.Logarithm()], np.float32),
    "fill_clamp_log": (lambda o: [o.FillMissing(0.0), o.Clamp(0.0, 50.0),
                                  o.Logarithm()], np.float32),
    "fill_bucketize": (lambda o: [o.FillMissing(1.5),
                                  o.Bucketize((0.5, 2.0, 10.0))], np.int32),
}


@pytest.mark.parametrize("chain", sorted(DENSE_CHAINS))
@pytest.mark.parametrize("rows,cols", [(8, 13), (100, 26), (257, 5),
                                       (1024, 128)])
def test_fused_stage_dense_plain_matches_pallas(rows, cols, chain):
    """f32 chains, NaN and negatives included (Clamp keeps NaN, Log of a
    clamped negative is 0)."""
    rng = _rng("dense", rows, cols, chain)
    x = (rng.normal(size=(rows, cols)) * 10).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    mk, out_dtype = DENSE_CHAINS[chain]
    want = rkops.fused_stage(_ref_chain(mk(rops)), in_dtype=np.float32,
                             out_dtype=out_dtype,
                             interpret=True)(jnp.asarray(x))
    fn = kops.fused_stage(mk(pops), in_dtype=np.float32, out_dtype=out_dtype)
    got = fn(torch.tensor(x))
    assert got.dtype == torch.from_numpy(np.zeros(0, out_dtype)).dtype
    tp.assert_match(want, got, chain)


HEX_CHAINS = {
    "mod": lambda o, w: [o.Hex2Int(w), o.Modulus(4096)],
    "fill_sigrid": lambda o, w: [o.Hex2Int(w), o.FillMissing(7),
                                 o.SigridHash(1000)],
    "mod_bucketize": lambda o, w: [o.Hex2Int(w), o.Modulus(997),
                                   o.Bucketize((100.5, 500.0))],
}


@pytest.mark.parametrize("chain", sorted(HEX_CHAINS))
@pytest.mark.parametrize("rows,cols,width", [(64, 26, 8), (100, 3, 4),
                                             (8, 1, 8)])
def test_fused_stage_hex_plain_matches_pallas(rows, cols, width, chain):
    """Digit-major hex, with non-hex bytes and all-zero (missing) ids."""
    rng = _rng("hex", rows, cols, width, chain)
    raw = HEXMAP[rng.integers(0, 16, size=(width, rows, cols))]
    bad = rng.random(raw.shape) < 0.05
    raw[bad] = rng.choice(np.frombuffer(b"gzG !~\x7f", np.uint8), bad.sum())
    raw[:, rng.random((rows, cols)) < 0.1] = 0
    want = rkops.fused_stage(_ref_chain(HEX_CHAINS[chain](rops, width), width),
                             in_dtype=np.uint8, out_dtype=np.int32,
                             hex_width=width, interpret=True)(jnp.asarray(raw))
    fn = kops.fused_stage(HEX_CHAINS[chain](pops, width), in_dtype=np.uint8,
                          out_dtype=np.int32, hex_width=width)
    tp.assert_match(want, fn(torch.tensor(raw)), chain)


@pytest.mark.parametrize("cap,parts", [(64, 1), (64, 4), (256, 8), (512, 2)])
@pytest.mark.parametrize("n", [1, 100, 5000])
def test_vocab_build_chunk_plain_matches_pallas(cap, parts, n):
    """Padding (-1) and ids >= capacity are ignored, as the Pallas kernel
    ignores them."""
    rng = _rng("build", cap, n)
    vals = rng.integers(0, cap, size=(n,)).astype(np.int32)
    vals[rng.random(n) < 0.1] = -1
    vals[rng.random(n) < 0.05] = cap + 5
    want = rkops.vocab_build_chunk(jnp.asarray(vals), capacity=cap,
                                   partitions=parts, interpret=True)
    got = kops.vocab_build_chunk(torch.tensor(vals), cap)
    tp.assert_match(want, got, "first_pos")


@pytest.mark.parametrize("rows,cols,cap,parts", [(8, 3, 64, 4),
                                                 (100, 26, 128, 1),
                                                 (33, 7, 256, 8)])
def test_vocab_lookup_plain_matches_pallas(rows, cols, cap, parts):
    """Absent entries and ids outside [0, capacity) map to n_unique, as in
    the masked Pallas kernel (the JAX ``ref.vocab_lookup`` would wrap a
    negative id instead)."""
    rng = _rng("lookup", rows, cols, cap)
    vg = rops.VocabGen(cap)
    table = vg.finalize(vg.update(vg.init_state(),
                                  rng.integers(0, cap, size=(cap // 2,)), 0))
    n = rops.VocabGen.n_unique(table)
    x = rng.integers(-3, cap + 3, size=(rows, cols)).astype(np.int32)
    want = rkops.vocab_lookup(jnp.asarray(x), jnp.asarray(table), n,
                              partitions=parts, interpret=True)
    got = kops.vocab_lookup(torch.tensor(x), torch.tensor(table), n)
    tp.assert_match(want, got, "lookup")
    assert (got.numpy() == n).any() and (got.numpy() < n).any()


@pytest.mark.parametrize("in_dtype", [np.float32, np.int32])
@pytest.mark.parametrize("widths,out_dtype", [([13, 26], np.float32),
                                              ([1], np.float32),
                                              ([5, 7, 11], np.int32)])
@pytest.mark.parametrize("rows", [8, 100])
def test_packer_plain_matches_pallas(widths, out_dtype, rows, in_dtype):
    """Concat + cast (float -> int truncates toward zero) + zero pad."""
    rng = _rng("pack", tuple(widths), rows, np.dtype(in_dtype).name,
               np.dtype(out_dtype).name)
    blocks = [(rng.normal(size=(rows, w)) * 300).astype(in_dtype)
              for w in widths]
    want = rkops.packer(widths, [in_dtype] * len(widths), out_dtype,
                        pad_cols_to=128,
                        interpret=True)(*[jnp.asarray(b) for b in blocks])
    fn = kops.packer(widths, [in_dtype] * len(widths), out_dtype,
                     pad_cols_to=128)
    got = fn(*[torch.tensor(b) for b in blocks])
    assert got.shape[1] % 128 == 0
    tp.assert_match(want, got, "packed")


@pytest.mark.parametrize("rows", [8, 100])
@pytest.mark.parametrize("n_block,pad", [(26, 32), (128, 128)])
def test_packer_plain_matches_pallas_on_one_column_blocks(n_block, pad, rows):
    """The layout of per-column chains under ``fuse="off"``: 26 int32
    [rows, 1] blocks into int32 [rows, 32] (the small struct), and 128
    float32 and int32 [rows, 1] blocks in turn into int32 [rows, 128] (the
    wide struct at its maximum; float -> int truncates toward zero)."""
    dtypes = ([np.int32] * n_block if n_block == 26
              else [np.float32, np.int32] * (n_block // 2))
    rng = _rng("pack_one_column", n_block, rows)
    blocks = [(rng.normal(size=(rows, 1)) * 300).astype(d) for d in dtypes]
    want = rkops.packer([1] * n_block, dtypes, np.int32, pad_cols_to=pad,
                        interpret=True)(*[jnp.asarray(b) for b in blocks])
    got = kops.packer([1] * n_block, dtypes, np.int32, pad_cols_to=pad)(
        *[torch.tensor(b) for b in blocks])
    assert tuple(got.shape) == (rows, pad)
    tp.assert_match(want, got, f"{n_block} blocks")


def test_staged_encodings_refuse_what_no_kernel_takes():
    with pytest.raises(NotImplementedError, match="OneHot"):
        kops.fused_stage([pops.OneHot(3)], in_dtype=np.int32,
                         out_dtype=np.float32)
    with pytest.raises(TypeError, match="Hex2Int"):
        kops.fused_stage([pops.Modulus(7)], in_dtype=np.uint8,
                         out_dtype=np.int32, hex_width=8)
    # past the small struct's 32 blocks the packer takes the wide one; past
    # that it refuses, and so it does a dtype the reference refuses too
    wide = kops.packer([4] * (df.MAX_BLOCK + 1),
                       [np.int32] * (df.MAX_BLOCK + 1), np.int32)
    blocks = [torch.full((3, 4), k, dtype=torch.int32)
              for k in range(df.MAX_BLOCK + 1)]
    assert torch.equal(wide(*blocks)[:, :4 * len(blocks)],
                       torch.cat(blocks, dim=1))
    with pytest.raises(ValueError, match="blocks"):
        kops.packer([4] * (df.MAX_WIDE_BLOCK + 1),
                    [np.int32] * (df.MAX_WIDE_BLOCK + 1), np.int32)
    with pytest.raises(NotImplementedError, match="float64"):
        kops.packer([4], [np.int32], np.float64)
    fn = kops.packer([2, 3], [np.float32, np.int32], np.int32, pad_cols_to=8)
    with pytest.raises(ValueError, match=r"block 1: want \[4, 3\]"):
        fn(torch.zeros(4, 2), torch.zeros(4, 2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# whole staged plans against the reference
# ---------------------------------------------------------------------------

def _force_int_output(name: str) -> frozenset:
    """The per-output fuse spec that stages a builder's integer output."""
    return frozenset({"ids" if name == "sink" else "sparse"})


CASES = {
    # the reference's own HBM-fallback case: sparse staged (hbm-table),
    # dense + label grouped
    "III_hbm": (tp.paper("III", large_vocab=2 ** 21), {}),
    # sparse staged (hbm-table), dense staged (budget), label solo fused
    "III_budget": (tp.paper("III"), {"vmem_budget": 16 << 10}),
    **{f"{n}_off": (tp.BUILDERS[n], {"fuse": "off"})
       for n in ("I", "II", "III", "sink")},
    **{f"{n}_int_staged": (tp.BUILDERS[n], {"fuse": _force_int_output(n)})
       for n in ("I", "II", "III", "sink")},
}


_REFERENCE: dict = {}


def _reference(case: str):
    """(fitted reference pipeline, port template with the same node ids):
    the interpret-mode fit at capacity 2**21 takes seconds, so each case
    fits its reference once per process."""
    if case not in _REFERENCE:
        builder, kw = CASES[case]
        ref_t, port_t = tp.build_pair(builder)
        ref = ref_t.compile("pallas", interpret=True, **kw)
        ref.fit(tp.fit_batches())
        _REFERENCE[case] = ref, port_t
    return _REFERENCE[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_plan_matches_reference(case):
    ref, port_t = _reference(case)
    port = port_t.compile("cuda", device="cpu", **CASES[case][1])
    assert "staged" in {v["path"] for v in port.lowering_report().values()}
    assert port.lowering_report() == ref.lowering_report()
    assert port.fit_lowering_report() == ref.fit_lowering_report()
    for phase in ("apply", "fit"):
        assert (port.stage_execution_counts(phase)
                == ref.stage_execution_counts(phase)), phase
    port.fit(tp.fit_batches())
    assert port.state.n_unique == ref.state.n_unique
    for vid, t in ref.state.tables.items():
        np.testing.assert_array_equal(port.state.tables[vid], np.asarray(t))
    raw = tp.raw_batch()
    tp.assert_outputs_match(ref(raw), port(raw), case)
    # one counted kernel call per pallas_call the reference traces (the
    # fit ran over three chunks)
    assert port.dataflow_calls == {
        "apply": ref.traced_pallas_call_count(raw),
        "fit": 3 * ref.traced_pallas_call_count(raw, "fit")}


@pytest.mark.parametrize("case", ["III_hbm", "III_budget"])
def test_staged_plan_through_etljob(case):
    """The same plans driven by the session facade: fit over a Source, then
    the streaming executor; the delivered batch matches the reference."""
    ref, port_t = _reference(case)
    job = EtlJob(port_t.compile("cuda", device="cpu", **CASES[case][1]),
                 Source.synth("I", rows=600, batch_size=600, seed=9),
                 fit_source=Source.synth("I", rows=3000, batch_size=1000,
                                         seed=7))
    job.fit()
    for vid, t in ref.state.tables.items():
        np.testing.assert_array_equal(job.state.tables[vid], np.asarray(t))
    with job.batches() as ex:
        (batch,) = list(ex)
    tp.assert_outputs_match(ref(tp.raw_batch()), batch, case)
    assert job.compiled.dataflow_calls["apply"] == \
        ref.traced_pallas_call_count(tp.raw_batch())


@pytest.mark.parametrize("which", ["II", "III"])
def test_fused_fit_equals_staged_fit(which):
    """The state is bit-identical whichever lowering fits it (the port's
    counterpart of tests/test_pipeline.py's fused-vs-staged fit test)."""
    states = {}
    for fuse in ("auto", "off"):
        p = paper_pipeline(which, **tp.SMALL).compile("cuda", device="cpu",
                                                      fuse=fuse)
        assert {v["path"] for v in p.fit_lowering_report().values()} == \
            ({"fused"} if fuse == "auto" else {"staged"})
        states[fuse] = p.fit(tp.fit_batches())
    a, b = states["auto"], states["off"]  # vocab ids differ per compile
    assert list(a.n_unique.values()) == list(b.n_unique.values())
    assert a.version == b.version
    for ta, tb in zip(a.tables.values(), b.tables.values()):
        np.testing.assert_array_equal(ta, tb)


def test_staged_launches_name_their_kernels_in_order():
    """``dataflow_launches`` yields the staged calls of a phase in plan
    order with runnable arguments, and leaves ``dataflow_calls`` alone."""
    p = paper_pipeline("III", **tp.SMALL).compile("cuda", device="cpu",
                                                  fuse="off")
    p.fit(tp.fit_batches())
    calls = dict(p.dataflow_calls)
    raw = tp.raw_batch(rows=100)
    apply = p.dataflow_launches(raw)
    fit = p.dataflow_launches(raw, "fit")
    assert [k for k, *_ in apply] == ["fused_stage", "fused_stage",
                                      "vocab_lookup", "packer", "packer"]
    assert [k for k, *_ in fit] == ["fused_stage", "vocab_build_chunk"]
    assert p.dataflow_calls == calls
    for _, _, fn, args in apply + fit:
        got, want = fn(*args), fn.plain(*args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)
