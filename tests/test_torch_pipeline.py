"""The port's planner, optimizer and compiled pipelines against the JAX
package: equal plans, and equal fitted tables and packed outputs between
``repro_torch`` (``backend="cuda", device="cpu"``: the dataflow kernels'
plain versions) and ``repro`` (``backend="pallas", interpret=True``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.etl_runtime import metrics as ref_metrics  # noqa: E402
from repro.etl_runtime import runtime as ref_runtime  # noqa: E402
from repro_torch.core.compiler import PipelineState  # noqa: E402
from repro_torch.core.pipeline import paper_pipeline  # noqa: E402
from repro_torch.core.planner import FusedStage  # noqa: E402
from repro_torch.data.source import Source  # noqa: E402
from repro_torch.etl_runtime import metrics as port_metrics  # noqa: E402
from repro_torch.etl_runtime import runtime as port_runtime  # noqa: E402
from repro_torch.kernels import dataflow as df  # noqa: E402
from repro_torch.session import EtlJob  # noqa: E402


def _lm(ns):
    return ns.pipeline.lm_token_pipeline(16, 1000, batch_size=64)


def _shared_prefix(ns):
    """tests/test_optimizer.py's worst case: three outputs rebuilding the
    same dense and sparse+vocab chains from fresh sources."""
    o = ns.ops
    p = ns.Pipeline(ns.Schema.criteo_kaggle())
    for i in range(3):
        d = (p.dense("dense_*") | o.FillMissing(0.0) | o.Clamp(0.0, 50.0)
             | o.Logarithm())
        s = p.sparse("sparse_0") | o.Hex2Int(8) | o.Modulus(1000) | ns.Vocab(1000)
        p.output(f"out{i}", [d, s], dtype=np.float32)
    return p


PLAN_BUILDERS = {**tp.BUILDERS, "lm": _lm, "shared_prefix": _shared_prefix,
                 "III_hbm": tp.paper("III", large_vocab=2 ** 21)}


def _stage_key(s):
    d = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
    for k in ("ops", "op"):
        if k in d:
            d[k] = repr(d[k])
    d["out_dtype"] = str(d.get("out_dtype"))
    d["in_dtype"] = str(d.get("in_dtype"))
    return type(s).__name__, sorted(d.items())


def _plan_key(plan):
    return {
        "stages": [_stage_key(s) for s in plan.stages],
        "fit_stage_ids": plan.fit_stage_ids,
        "vocab_fits": [dataclasses.astuple(v) for v in plan.vocab_fits],
        "pack": [(p.name, p.buffers, str(p.dtype), p.pad_cols_to, p.squeeze)
                 for p in plan.pack],
        "source_buffers": plan.source_buffers,
        "dataflows": [(d.output, d.stage_ids, d.source_buffers, d.vocab_ids,
                       d.legal, d.reason_kind, d.reason)
                      for d in plan.dataflows],
        "fit_dataflows": [(f.vocab_id, f.stage_ids, f.source_buffers,
                           f.legal, f.reason_kind, f.reason)
                          for f in plan.fit_dataflows],
        "groups": [dataclasses.astuple(g) for g in plan.groups],
        "optimize_report": plan.optimize_report(),
        "referenced": plan.referenced_columns(),
        "fit_referenced": plan.fit_referenced_columns(),
    }


@pytest.mark.parametrize("optimize", ["auto", "off"])
@pytest.mark.parametrize("name", sorted(PLAN_BUILDERS))
def test_plans_equal(name, optimize):
    ref, port = tp.build_pair(PLAN_BUILDERS[name])
    r = ref.compile("numpy", optimize=optimize)
    p = port.compile("numpy", optimize=optimize)
    assert _plan_key(p.plan) == _plan_key(r.plan)
    assert p.optimize_report() == r.optimize_report()


@pytest.mark.parametrize("name", ["I", "II", "III", "sink"])
def test_compiled_pipeline_matches_reference(name):
    """Fit + apply: the port's cuda backend (plain versions on the CPU)
    against the reference's pallas backend in interpret mode, and the
    port's numpy and torch backends against the same."""
    ref_t, port_t = tp.build_pair(tp.BUILDERS[name])
    ref = ref_t.compile("pallas", interpret=True)
    ref.fit(tp.fit_batches())
    raw = tp.raw_batch()
    want = ref(raw)
    rep = {k: v["path"] for k, v in ref.lowering_report().items()}
    for backend in ("cuda", "torch", "numpy"):
        port = port_t.compile(backend, device="cpu")
        port.fit(tp.fit_batches())
        assert port.state.n_unique == ref.state.n_unique, backend
        for vid, t in ref.state.tables.items():
            np.testing.assert_array_equal(port.state.tables[vid],
                                          np.asarray(t), err_msg=backend)
        tp.assert_outputs_match(want, port(raw), f"{name}/{backend}")
        if backend == "cuda":
            assert {k: v["path"] for k, v in
                    port.lowering_report().items()} == rep
            assert port.fit_lowering_report() == ref.fit_lowering_report()


def test_reference_state_loads_as_is():
    """A state fitted by the JAX package drives the port unchanged."""
    ref_t, port_t = tp.build_pair(tp.BUILDERS["III"])
    ref = ref_t.compile("numpy")
    ref.fit(tp.fit_batches())
    port = port_t.compile("cuda", device="cpu")
    port.state = PipelineState(dict(ref.state.tables), dict(ref.state.n_unique),
                               version=ref.state.version)
    raw = tp.raw_batch(seed=21)
    tp.assert_outputs_match(ref(raw), port(raw), "loaded state")


def test_one_dataflow_call_per_batch_and_chunk():
    """The launch counter: one group call per applied batch (all three
    outputs share it), one fit call per chunk per vocab; three solo calls
    per batch with optimize="off"."""
    tmpl = paper_pipeline("II", **tp.SMALL)
    p = tmpl.compile("cuda", device="cpu")
    p.fit(tp.fit_batches())
    assert p.dataflow_calls == {"apply": 0, "fit": 3}
    for i in range(4):
        p(tp.raw_batch(rows=100, seed=i))
    assert p.dataflow_calls["apply"] == 4
    solo = tmpl.compile("cuda", device="cpu", optimize="off")
    solo.state = p.state
    solo(tp.raw_batch(rows=100))
    assert solo.dataflow_calls["apply"] == 3
    assert {v["path"] for v in solo.lowering_report().values()} == {"fused"}
    # CUDA launch counts move only for CUDA tensors
    launches = dict(df.LAUNCHES)
    p(tp.raw_batch(rows=100))
    assert df.LAUNCHES == launches


def test_launches_per_batch_through_etljob():
    job = EtlJob(paper_pipeline("III", batch_size=256, **tp.SMALL),
                 Source.synth("I", rows=5 * 256, batch_size=256, seed=3),
                 backend="cuda", device="cpu",
                 fit_source=Source.synth("I", rows=2000, batch_size=1000))
    job.fit()
    assert job.compiled.dataflow_calls["fit"] == 2
    with job.batches() as ex:
        batches = list(ex)
    assert len(batches) == 5
    assert job.compiled.dataflow_calls["apply"] == 5
    assert batches[0]["dense"].shape == (256, 16)
    assert batches[0]["sparse"].dtype == torch.int32
    assert batches[0]["label"].shape == (256,)
    st = job.stats()
    assert st.consumed == 5 and set(st.stages) == {"read", "transform",
                                                   "place", "deliver"}


def test_staged_path_raises_on_cuda():
    """The two compiles that met the staged wall before its kernels were
    ported now compile on cuda and report the reference's lowering; what
    still raises is a staged kernel handed a tensor that is on neither the
    CPU nor a CUDA device (no silent plain route)."""
    cases = [(tp.paper("II"), {"fuse": "off"}),
             (tp.paper("III", large_vocab=2 ** 21), {})]
    for builder, kw in cases:
        ref_t, port_t = tp.build_pair(builder)
        ref = ref_t.compile("pallas", interpret=True, **kw)
        port = port_t.compile("cuda", device="cpu", **kw)
        assert port.lowering_report() == ref.lowering_report()
        assert port.fit_lowering_report() == ref.fit_lowering_report()
        assert "staged" in {v["path"] for v in port.lowering_report().values()}
    fn = port._stage_fns({s.stage_id for s in port.plan.stages})
    stage = next(s for s in port.plan.stages
                 if s.stage_id in fn and isinstance(s, FusedStage))
    with pytest.raises(ValueError, match="meta"):
        fn[stage.stage_id](torch.empty(8, 1000, 26, dtype=torch.uint8,
                                       device="meta"))


def test_with_knobs_shares_state_and_is_identical():
    p = paper_pipeline("II", **tp.SMALL).compile("cuda", device="cpu")
    p.fit(tp.fit_batches())
    q = p.with_knobs(row_tile=64)
    assert q.state is p.state and q.plan.row_tile == 64
    raw = tp.raw_batch(seed=5)
    a, b = p(raw), q(raw)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_prometheus_text_identical():
    def fill(stats, stage_cls):
        stats.produced, stats.consumed, stats.consumer_wait_s = 7, 6, 0.25
        stats.knobs["credits"] = 2
        for i, name in enumerate(("read", "transform", "place", "deliver")):
            stats.stages[name] = stage_cls(name, items=i + 1, busy_s=0.5 * i,
                                           wait_in_s=0.125, wait_out_s=0.0)
        stats.staleness.observe(0.02)
        return stats

    want = ref_metrics.stats_to_prometheus(
        fill(ref_runtime.RuntimeStats(), ref_runtime.StageStats),
        labels={"job": "x"})
    got = port_metrics.stats_to_prometheus(
        fill(port_runtime.RuntimeStats(), port_runtime.StageStats),
        labels={"job": "x"})
    assert got == want
