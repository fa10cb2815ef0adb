"""Plans past the small program struct, and every output dtype, against the
JAX package.

The port's kernels take a program within 8 sources, 24 slots, 32
instructions, 4 tables, 4 outputs and 16 terminals in a struct under 4 KiB
of kernel parameters, and any larger one (up to 128 / 384 / 384 / 128 / 16
/ 128) in a second, wider struct; the packer takes up to 32 blocks in one
struct and up to 128 in another.  Outputs may be of any dtype the
reference's kernels return (float32, int32, float16, bfloat16, int8, uint8,
int16, uint16, uint32, bool).  Here, on the CPU, the port's ``cuda`` backend
(the kernels' plain versions interpreting the same encoded programs)
against the reference's ``pallas`` backend in interpret mode, both built by
``torch_parity.build_pair``: lowering reports equal (no plan is demoted to
dodge a kernel limit), fitted tables and ``n_unique`` bit-equal, outputs by
the reference's policy (integers bit-equal, floats rtol 1e-5) and of the
reference's dtype.

Casts of out-of-range values (a float past an integer dtype's range)
depend on the platform in both packages, so the inputs here keep every
value in the output dtype's range: Clamp bounds the dense floats to [0,
100] and Modulus(200) the ids.  The CUDA kernels themselves are held
against these plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.kernels import ops as rkops  # noqa: E402
from repro_torch.kernels import dataflow as df  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402


def _outputs_of_dense(n: int):
    """n outputs, each one ``dense_i | FillMissing(0.0)`` (grouped)."""
    def build(ns):
        o = ns.ops
        p = ns.Pipeline(ns.Schema.criteo_kaggle(), name="many_outputs")
        for i in range(n):
            p.output(f"d{i}", [p.dense(f"dense_{i}") | o.FillMissing(0.0)],
                     dtype=np.float32)
        return p
    return build


def _vocab_columns(n: int):
    """One int32 output over n columns of ``sparse_i | Hex2Int(8) |
    Modulus(1000) | Vocab(1000)`` (fused)."""
    def build(ns):
        o = ns.ops
        p = ns.Pipeline(ns.Schema.criteo_kaggle(), name="vocab_columns")
        p.output("ids", [p.sparse(f"sparse_{i}") | o.Hex2Int(8)
                         | o.Modulus(1000) | ns.Vocab(1000)
                         for i in range(n)], dtype=np.int32)
        return p
    return build


def _single_column_chains(n: int):
    """One output of n single-column chains ``dense_(i % 13) |
    FillMissing(i)``: fused, or with ``fuse="off"`` one packer block each."""
    def build(ns):
        o = ns.ops
        p = ns.Pipeline(ns.Schema.criteo_kaggle(), name="chains")
        p.output("x", [p.dense(f"dense_{i % 13}") | o.FillMissing(float(i))
                       for i in range(n)], dtype=np.float32)
        return p
    return build


# the Queue C probe cases: each raised in the port before the wide structs
PROBES = {
    "5_outputs": (_outputs_of_dense(5), {}, "grouped"),
    "5_vocab_columns": (_vocab_columns(5), {}, "fused"),
    "16_chains": (_single_column_chains(16), {}, "fused"),
    "33_chains_off": (_single_column_chains(33), {"fuse": "off"}, "staged"),
}

def _np_dtype(name: str):
    return jnp.bfloat16 if name == "bfloat16" else np.dtype(name)


def _compare(builder, kw: dict, rows: int = 600) -> tuple:
    """Fit both packages on the same batches and apply both to one raw
    batch; assert every equality the module docstring lists.  Returns
    (reference, port) compiled pipelines."""
    ref_t, port_t = tp.build_pair(builder)
    ref = ref_t.compile("pallas", interpret=True, **kw)
    port = port_t.compile("cuda", device="cpu", **kw)
    assert port.lowering_report() == ref.lowering_report()
    assert port.fit_lowering_report() == ref.fit_lowering_report()
    ref.fit(tp.fit_batches())
    port.fit(tp.fit_batches())
    assert port.state.n_unique == ref.state.n_unique
    for vid, t in ref.state.tables.items():
        np.testing.assert_array_equal(port.state.tables[vid], np.asarray(t))
    raw = tp.raw_batch(rows=rows)
    want, got = ref(raw), port(raw)
    assert {k: tp.dtype_name(v) for k, v in want.items()} == \
        {k: tp.dtype_name(v) for k, v in got.items()}
    tp.assert_outputs_match(want, got)
    return ref, port


@pytest.mark.parametrize("case", sorted(PROBES))
def test_probe_plans_keep_the_reference_lowering(case):
    builder, kw, path = PROBES[case]
    _, port = _compare(builder, kw)
    assert {v["path"] for v in port.lowering_report().values()} == {path}


def test_criteo_per_feature_vocabularies_run_grouped():
    """26 per-feature vocabularies (Vocab(2048)) in one ``sparse`` output:
    one group kernel for dense, sparse and label (a program of 28 sources,
    81 slots and instructions, 26 tables), one fit kernel per vocabulary,
    all equal to the reference's, on two raw batches."""
    ref, port = _compare(tp.criteo_per_feature(2048), {})
    assert {v["path"] for v in port.lowering_report().values()} == \
        {"grouped"}
    assert {v["path"] for v in port.fit_lowering_report().values()} == \
        {"fused"}
    assert len(port.state.tables) == 26
    (group,) = port._group_fns
    assert group.program.wide and group.program.counts.table == 26
    raw = tp.raw_batch(rows=1000, seed=3)
    tp.assert_outputs_match(ref(raw), port(raw), "second batch")
    assert port.dataflow_calls["apply"] == 2


def test_packer_takes_more_blocks_than_the_small_struct():
    """A 33-block (and a 128-block) packer against the reference's
    ``make_packer`` in interpret mode, f32 and i32 blocks into int32."""
    rng = np.random.default_rng(33)
    for n in (df.MAX_BLOCK + 1, df.MAX_WIDE_BLOCK):
        widths = [int(w) for w in rng.integers(1, 4, size=n)]
        dtypes = [np.float32 if k % 2 else np.int32 for k in range(n)]
        blocks = [(rng.normal(size=(37, w)) * 300).astype(d)
                  for w, d in zip(widths, dtypes)]
        want = rkops.packer(widths, dtypes, np.int32, pad_cols_to=16,
                            interpret=True)(*[jnp.asarray(b) for b in blocks])
        fn = kops.packer(widths, dtypes, np.int32, pad_cols_to=16)
        tp.assert_match(want, fn(*[torch.tensor(b) for b in blocks]),
                        f"{n} blocks")
    with pytest.raises(ValueError, match="1..128 blocks"):
        kops.packer([1] * (df.MAX_WIDE_BLOCK + 1),
                    [np.int32] * (df.MAX_WIDE_BLOCK + 1), np.int32)


@pytest.mark.parametrize("fuse", ["auto", "off"])
@pytest.mark.parametrize("dtype", tp.OUT_DTYPES)
def test_output_dtypes_match_the_reference(dtype, fuse):
    """Every output dtype of the reference, on the fused (one group kernel)
    and on the staged lowering (fused_stage chains, then the packer)."""
    _, port = _compare(tp.in_range_outputs(_np_dtype(dtype)), {"fuse": fuse})
    paths = {v["path"] for v in port.lowering_report().values()}
    assert paths == ({"grouped"} if fuse == "auto" else {"staged"})


@pytest.mark.parametrize("dtype", ["float16", "int16", "uint8", "bool"])
def test_stage_and_packer_kernels_cast_like_astype(dtype):
    """The stage and packer kernels' plain versions against the reference's
    ``make_fused_stage`` and ``make_packer`` casting at the store, on values
    in the dtype's range."""
    rng = np.random.default_rng(16)
    x = (rng.random((50, 13)) * 100).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = 0.0
    from repro.core import operators as rops
    from repro_torch.core import operators as pops
    want = rkops.fused_stage(lambda v: rops.Clamp(0.0, 90.0).jnp_expr(v),
                             in_dtype=np.float32, out_dtype=_np_dtype(dtype),
                             interpret=True)(jnp.asarray(x))
    got = kops.fused_stage([pops.Clamp(0.0, 90.0)], in_dtype=np.float32,
                           out_dtype=_np_dtype(dtype))(torch.tensor(x))
    assert tp.dtype_name(want) == tp.dtype_name(got) == dtype
    tp.assert_match(want, got, "fused_stage")
    ids = rng.integers(0, 120, size=(50, 5)).astype(np.int32)
    want = rkops.packer([13, 5], [np.float32, np.int32], _np_dtype(dtype),
                        pad_cols_to=32, interpret=True)(jnp.asarray(x),
                                                        jnp.asarray(ids))
    got = kops.packer([13, 5], [np.float32, np.int32], _np_dtype(dtype),
                      pad_cols_to=32)(torch.tensor(x), torch.tensor(ids))
    assert tp.dtype_name(want) == tp.dtype_name(got) == dtype
    tp.assert_match(want, got, "packer")


def test_programs_past_the_wide_struct_name_the_limit():
    """Past the wide struct's maxima the port raises and names the limit
    (129 sources; no plan here is demoted to the staged path instead)."""
    inputs = [df.StreamInput(f"s{i}", 1, np.dtype(np.float32))
              for i in range(df.WIDE.src + 1)]
    out = df.GroupOutput("o", tuple((f"s{i}", 1)
                                    for i in range(df.WIDE.src + 1)),
                         np.dtype(np.float32))
    with pytest.raises(NotImplementedError,
                       match=r"129 sources \(at most 128\)"):
        df.make_group_dataflow(inputs, (), (), [out])
    with pytest.raises(NotImplementedError, match="float64"):
        df.make_group_dataflow(inputs[:1], (), (), [df.GroupOutput(
            "o", (("s0", 1),), np.dtype(np.float64))])
