"""The CUDA kernels against their plain versions on the card (the dataflow
kernels, the staged lowering's four and the two embedding bags), cached ==
uncached bags bit for bit, the cached lookup's deterministic backward, and
the stream handoff of the executor (a place hook after the transform
stream's event too) and the group kernel under incremental refits; the wide program struct (26 per-feature
vocabularies in one group), every output dtype, 16-bit bags, the tile
program's byte copy and the edges of the redesigned stage, build and
packer kernels; the LM trainer's forward and backward against the CPU,
three tenants at once bit for bit, and exact launch counts under four
launching threads; the MoE family and bfloat16-state optimizer steps
against the CPU; serving, and the hybrid and enc-dec families, against the
CPU; a data-parallel rank on NCCL against one on gloo on the CPU; the
example twins run on the card.  Needs an NVIDIA GPU with nvcc: marked ``cuda`` and skipped
elsewhere (a CUDA kernel has no interpret mode).

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro_torch.core.pipeline import paper_pipeline  # noqa: E402
from repro_torch.data.source import Source  # noqa: E402
from repro_torch.etl_runtime import lookahead as la  # noqa: E402
from repro_torch.core import operators as ops  # noqa: E402
from repro_torch.kernels import dataflow as df  # noqa: E402
from repro_torch.kernels import embedding_bag as kbag  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.session import EtlJob  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _check(got, want, msg):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), msg
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, msg
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=0,
                                       equal_nan=True, msg=msg)
        else:
            assert torch.equal(g, w), msg


BUILDERS = {**tp.BUILDERS, "III_hbm": tp.paper("III", large_vocab=2 ** 21)}


@pytest.mark.parametrize("optimize,fuse", [("auto", "auto"), ("off", "auto"),
                                           ("auto", "off")])
@pytest.mark.parametrize("name", ["I", "II", "III", "sink", "III_hbm"])
def test_kernels_match_plain_versions(card, name, optimize, fuse):
    p = BUILDERS[name](tp.PORT).compile("cuda", device=card,
                                        optimize=optimize, fuse=fuse)
    p.fit(tp.fit_batches())
    raw = tp.raw_batch(rows=1000)  # not a multiple of any row tile
    before = dict(df.LAUNCHES)
    calls = p.dataflow_launches(raw, "apply") + p.dataflow_launches(raw, "fit")
    assert sum(df.LAUNCHES.values()) - sum(before.values()) == len(calls)
    for kname, what, fn, args in calls:
        got = fn(*args)
        want = fn.plain(*args)
        torch.cuda.synchronize()
        _check(got, want, f"{name}/{kname}/{what}")
    assert sum(df.LAUNCHES.values()) - sum(before.values()) == 2 * len(calls)


def _staged_edge_cases(card):
    """(kernel, runner, args) on edge inputs: NaN and negatives through
    Clamp | Log, non-hex and all-zero hex, out-of-range build values and
    lookup ids, float -> int packing; embedding bags with -1 and >= vocab
    ids, slots >= cache_rows, the float4 (dim 128) and scalar (dim 13)
    paths (nnz 8 through the cached bag at both), the cache-only variant
    and row-strided plan columns; the lookup
    on views off a 16-byte boundary and of lengths n % 4 != 0 (n = 3 lies
    wholly before the first boundary), and the stacked cached bag on
    strided plan columns at dims 128 and 13."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(777, 13)) * 10).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    hexes = np.frombuffer(b"0123456789abcdefgz !", np.uint8)[
        rng.integers(0, 20, size=(8, 777, 26))]
    hexes[:, rng.random((777, 26)) < 0.1] = 0
    vals = rng.integers(-2, 70000, size=(100000,)).astype(np.int32)
    table = rng.integers(-1, 5000, size=(65536,)).astype(np.int32)
    ids = rng.integers(-5, 65541, size=(777, 26)).astype(np.int32)
    blocks = [(rng.normal(size=(777, w)) * 300).astype(np.float32)
              for w in (13, 3)]
    t = lambda a: torch.tensor(a, device=card)  # noqa: E731
    dense = kops.fused_stage([ops.Clamp(0.0), ops.Logarithm()],
                             in_dtype=np.float32, out_dtype=np.float32)
    sparse = kops.fused_stage([ops.Hex2Int(8), ops.FillMissing(7),
                               ops.SigridHash(4096)],
                              in_dtype=np.uint8, out_dtype=np.int32,
                              hex_width=8)
    bucket = kops.fused_stage([ops.Bucketize((0.5, 2.0))],
                              in_dtype=np.float32, out_dtype=np.float32)
    pack_i = kops.packer([13, 3], [np.float32] * 2, np.int32, pad_cols_to=32)
    pack_f = kops.packer([13, 3], [np.float32] * 2, np.float32, pad_cols_to=8)
    tbl = rng.normal(size=(5000, 128)).astype(np.float32)
    tbl13 = np.ascontiguousarray(tbl[:, :13])
    cache = rng.normal(size=(300, 128)).astype(np.float32)
    bag_ids = rng.integers(-1, 5003, size=(777, 8)).astype(np.int32)
    slots = rng.integers(-150, 303, size=(777, 8)).astype(np.int32)
    plan_slot = t(rng.integers(-100, 303, size=(777, 26)).astype(np.int32))
    plan_cold = t(rng.integers(-1, 5003, size=(777, 26)).astype(np.int32))
    tables3 = t(rng.normal(size=(3, 5000, 128)).astype(np.float32))
    cache3 = t(rng.normal(size=(3, 300, 128)).astype(np.float32))
    flat = t(ids).view(-1)  # views off a 16-byte boundary, n % 4 != 0
    return [("fused_stage", dense, [t(x)]),
            ("fused_stage", sparse, [t(hexes)]),
            ("fused_stage", bucket, [t(np.nan_to_num(x))]),
            ("vocab_build_chunk", kops.vocab_build_chunk, [t(vals), 65536]),
            ("vocab_lookup", kops.vocab_lookup, [t(ids), t(table), 4321]),
            ("packer", pack_i, [t(b) for b in blocks]),
            ("packer", pack_f, [t(b) for b in blocks]),
            ("embedding_bag", kops.embedding_bag, [t(tbl), t(bag_ids)]),
            ("embedding_bag", kops.embedding_bag, [t(tbl13), t(bag_ids)]),
            ("embedding_bag_cached", kops.embedding_bag_cached,
             [t(tbl), t(cache), t(slots), t(bag_ids)]),
            ("embedding_bag_cached", kops.embedding_bag_cached,
             [t(tbl), t(cache), t(slots)]),
            ("embedding_bag_cached", kops.embedding_bag_cached,
             [t(tbl13), t(np.ascontiguousarray(cache[:, :13])), t(slots),
              t(bag_ids)]),
            ("embedding_bag_cached", kops.embedding_bag_cached,
             [t(tbl), t(cache), plan_slot[:, 3:4], plan_cold[:, 3:4]]),
            ("vocab_lookup", kops.vocab_lookup, [flat[1:], t(table), 4321]),
            ("vocab_lookup", kops.vocab_lookup,
             [flat[2:2 + 4099], t(table), 4321]),
            ("vocab_lookup", kops.vocab_lookup, [flat[3:6], t(table), 4321]),
            ("vocab_lookup", kops.vocab_lookup, [flat[:4097], t(table), 4321]),
            ("embedding_bag_cached", kbag._stacked_cached_bag,
             [tables3, cache3, plan_slot[:, 5:8], plan_cold[:, 20:23]]),
            ("embedding_bag_cached", kbag._stacked_cached_bag,
             [tables3[:, :, :13].contiguous(), cache3[:, :, :13].contiguous(),
              plan_slot[:, :3], plan_cold[:, :3]])]


@pytest.mark.parametrize("case", range(19))
def test_staged_kernels_on_edge_inputs(card, case):
    kname, fn, args = _staged_edge_cases(card)[case]
    before = df.LAUNCHES[kname]
    got = fn(*args)
    assert df.LAUNCHES[kname] == before + 1
    want = fn.plain(*args)
    torch.cuda.synchronize()
    _check(got, want, f"{kname}/{case}")


DATAFLOW_EDGES = [f"fit_{c}" for c in tp.FIT_EDGE_CASES] + [
    f"rows_{n}" for n in (1, 7, 1000, 65533)] + ["dense_off_16B",
                                                 "wide_2048"]


def _dataflow_edge_case(card, case: str) -> list:
    """(kernel, runner, args) of one edge instance of the redesigned
    dataflow kernels: Hex2Int straight into the fit on every value equal
    (one shared-table entry), every value distinct (more per tile than the
    shared table holds: the probe-overflow path) and negative, missing and
    >= capacity values; Pipeline III's fit and group at row counts whose
    tail tiles are not 16-byte multiples; the group with its dense source a
    contiguous row view off a 16-byte boundary; an output of 2,048 columns
    (more than a block has threads)."""
    if case == "wide_2048":
        from repro_torch.core.pipeline import lm_token_pipeline
        from repro_torch.data import synth
        p = lm_token_pipeline(2048, 1000, batch_size=300).compile(
            "cuda", device=card)
        raw = next(synth.lm_event_batches(2048, rows=300, batch_size=300))
        return [(k, fn, args) for k, _, fn, args in
                p.dataflow_launches(raw, "apply") if k == "output_dataflow"]
    if case.startswith("fit_"):
        width, cap = 26, 65536
        fn = df.make_fit_dataflow(
            [df.StreamInput("h", width, np.dtype(np.uint8), 8)],
            [df.TileStep("map", "v", ("h",), (ops.Hex2Int(8),))], "v", cap)
        hexes = tp.fit_edge_values(case[4:], 2000, width, cap)
        return [("fit_dataflow", fn, [torch.tensor(hexes, device=card)])]
    p = tp.BUILDERS["III"](tp.PORT).compile("cuda", device=card)
    p.fit(tp.fit_batches())
    if case.startswith("rows_"):
        raw = tp.raw_batch(rows=int(case[5:]))
        return [(k, fn, args) for phase in ("fit", "apply")
                for k, _, fn, args in p.dataflow_launches(raw, phase)]
    ((kname, _, fn, args),) = p.dataflow_launches(tp.raw_batch(rows=1000),
                                                  "apply")
    (i,) = [i for i, s in enumerate(fn.program.slots[:fn.program.n_src])
            if s.kind == df.KIND_F32 and s.width == 13]
    buf = torch.empty(args[i].shape[0] + 1, 13, device=card)
    buf[1:] = args[i]
    args = list(args)
    args[i] = buf[1:]  # contiguous, 52 B past a 16-byte boundary
    assert args[i].is_contiguous() and args[i].data_ptr() % 16
    return [(kname, fn, args)]


@pytest.mark.parametrize("case", DATAFLOW_EDGES)
def test_dataflow_kernels_on_edge_inputs(card, case):
    for kname, fn, args in _dataflow_edge_case(card, case):
        before = df.LAUNCHES[kname]
        got = fn(*args)
        assert df.LAUNCHES[kname] == before + 1
        want = fn.plain(*args)
        torch.cuda.synchronize()
        _check(got, want, f"{case}/{kname}")


@pytest.mark.parametrize("dim", [128, 13])
def test_stacked_bag_equals_per_feature_launches(card, dim):
    """One stacked launch over a 26-feature plan (strided columns, -1
    entries, slots past the cache, cold ids past the vocabulary) equals the
    26 single-feature launches stacked, bit for bit, and counts one
    launch."""
    rng = np.random.default_rng(8)
    n_feat, vocab, rows = 26, 3000, 200
    tables = torch.tensor(rng.normal(size=(n_feat, vocab, dim)).astype(
        np.float32), device=card)
    cache = torch.tensor(rng.normal(size=(n_feat, rows, dim)).astype(
        np.float32), device=card)
    slot = torch.tensor(rng.integers(-60, rows + 5, size=(999, 32)).astype(
        np.int32), device=card)[:, 6:]
    cold = torch.tensor(rng.integers(-1, vocab + 5, size=(999, 32)).astype(
        np.int32), device=card)[:, :n_feat]
    before = df.LAUNCHES["embedding_bag_cached"]
    got = kbag._stacked_cached_bag(tables, cache, slot, cold)
    assert df.LAUNCHES["embedding_bag_cached"] == before + 1
    want = torch.stack([kops.embedding_bag_cached(
        tables[t], cache[t], slot[:, t:t + 1], cold[:, t:t + 1])
        for t in range(n_feat)], dim=1)
    plain = kbag._stacked_cached_bag.plain(tables, cache, slot, cold)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("staged", [False, True])
def test_cached_bag_bit_equal_to_uncached(card, staged):
    """Cache rows that mirror the table rows the remap assigned give the
    uncached bag's output bit for bit (one pooling routine)."""
    rng = np.random.default_rng(5)
    tbl = torch.tensor(rng.normal(size=(20000, 128)).astype(np.float32),
                       device=card)
    idx = rng.integers(0, 20000, size=(4096, 8)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.1] = -1
    rows = (np.unique(idx[idx >= 0]) if staged
            else rng.choice(20000, size=512, replace=False))
    slot_of = np.full(20000, -1, np.int64)
    slot_of[rows] = np.arange(len(rows))
    slot = np.where(idx >= 0, slot_of[idx.clip(min=0)], -1).astype(np.int32)
    cold = None if staged else torch.tensor(
        np.where(slot < 0, idx, -1).astype(np.int32), device=card)
    cache = tbl[torch.tensor(rows, device=card)].contiguous()
    got = kops.embedding_bag_cached(tbl, cache, torch.tensor(slot, device=card),
                                    cold)
    want = kops.embedding_bag(tbl, torch.tensor(idx, device=card))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_cached_lookup_backward_is_deterministic(card):
    """Two backward passes of the cached lookup give bit-equal table
    gradients, equal to the uncached gather's."""
    rng = np.random.default_rng(6)
    n_t, vocab, dim, batch = 4, 30000, 128, 8192
    cfg = la.EmbedCacheConfig(rows=256, window=1, stage_max=512)
    orig = (rng.zipf(1.2, size=(batch, n_t)) % vocab).astype(np.int32)
    planner = la.LookaheadPlanner(cfg, n_t)
    planner.push(orig)
    _, plan = planner.pop_plan()
    tables = torch.tensor(rng.normal(size=(n_t, vocab, dim)).astype(
        np.float32), device=card, requires_grad=True)
    b = la.EmbedCache(cfg, n_t, dim, device=card).advance(tables,
                                                          plan.as_payload())
    o = torch.tensor(orig, device=card)
    g = torch.tensor(rng.normal(size=(batch, n_t, dim)).astype(np.float32),
                     device=card)
    grads = []
    for _ in range(2):
        out = la.cached_embedding_lookup(tables, b["emb_cache"], b["emb_slot"],
                                         b["emb_cold"], o)
        grads.append(torch.autograd.grad(out, tables, g)[0])
    plain = torch.autograd.grad(
        tables[torch.arange(n_t, device=card), o.long()], tables, g)[0]
    torch.cuda.synchronize()
    assert torch.equal(out, tables.detach()[torch.arange(n_t, device=card),
                                            o.long()])
    assert torch.equal(grads[0], grads[1])
    assert torch.equal(grads[0], plain)


def test_lookahead_stage_reads_cuda_payloads(card):
    """The stage waits on each batch's transform event before it copies the
    planned columns (not a contiguous range here) to the host: its plans
    equal a planner fed with the directly applied batches."""
    tmpl = paper_pipeline("III", batch_size=512, **tp.SMALL)
    cfg = la.EmbedCacheConfig(rows=64, window=2, stage_max=32,
                              tables=(0, 3, 7, 25))
    job = EtlJob(tmpl, Source.synth("I", rows=6 * 512, batch_size=512,
                                    seed=4),
                 backend="cuda", device=card, embed_cache=cfg,
                 fit_source=Source.synth("I", rows=2000, batch_size=1000))
    job.fit()
    with job.batches() as ex:
        got = [b["emb_slot"] for b in ex]
    planner = la.LookaheadPlanner(cfg, 4)
    want = []
    for raw in Source.synth("I", rows=6 * 512, batch_size=512, seed=4):
        planner.push(job.apply(raw)["sparse"][:, [0, 3, 7, 25]].cpu().numpy()
                     .astype(np.int64))
        if planner.window_depth() >= cfg.window:
            want.append(planner.pop_plan()[1].slot)
    while planner.window_depth():
        want.append(planner.pop_plan()[1].slot)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_executor_stream_handoff_matches_direct_apply(card):
    tmpl = paper_pipeline("III", batch_size=512, **tp.SMALL)
    job = EtlJob(tmpl, Source.synth("I", rows=4 * 512, batch_size=512,
                                    seed=4),
                 backend="cuda", device=card,
                 fit_source=Source.synth("I", rows=2000, batch_size=1000))
    job.fit()
    with job.batches() as ex:
        delivered = [{k: v.clone() for k, v in b.items()} for b in ex]
    direct = [job.apply(raw) for raw in Source.synth(
        "I", rows=4 * 512, batch_size=512, seed=4)]
    assert len(delivered) == len(direct) == 4
    for a, b in zip(delivered, direct):
        for k in a:
            assert torch.equal(a[k], b[k]), k


class _SlowTransform:
    """A compiled pipeline whose transform first holds its stream for
    ~0.1 s (``torch.cuda._sleep``), so a consumer that does not wait on the
    transform's event reads its output before the kernel writes it."""

    def __init__(self, inner):
        self.inner, self.device = inner, inner.device

    def __call__(self, raw):
        torch.cuda._sleep(200_000_000)
        return self.inner(raw)


def test_place_hook_runs_after_the_transform_stream(card):
    """A place hook that copies the batch (``put_packed`` on a mesh does)
    reads what the transform stream wrote: the executor's place stage
    waits on the transform's event first, so the copies equal a direct
    apply."""
    from repro_torch.etl_runtime.runtime import StreamingExecutor
    tmpl = paper_pipeline("III", batch_size=512, **tp.SMALL)
    job = EtlJob(tmpl, Source.synth("I", rows=512, batch_size=512),
                 backend="cuda", device=card,
                 fit_source=Source.synth("I", rows=2000, batch_size=1000))
    job.fit()
    ex = StreamingExecutor(
        _SlowTransform(job.compiled),
        Source.synth("I", rows=3 * 512, batch_size=512, seed=4),
        place=lambda b: {k: v.clone() for k, v in b.items()})
    with ex:
        delivered = [{k: v.clone() for k, v in b.items()} for b in ex]
    direct = [job.apply(raw) for raw in Source.synth(
        "I", rows=3 * 512, batch_size=512, seed=4)]
    assert len(delivered) == len(direct) == 3
    for a, b in zip(delivered, direct):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def _launch_all(calls, msg: str) -> None:
    """Run each (kernel, runner, args): one counted launch each, equal to
    its plain version."""
    for kname, fn, args in calls:
        before = df.LAUNCHES[kname]
        got = fn(*args)
        assert df.LAUNCHES[kname] == before + 1, (msg, kname)
        want = fn.plain(*args)
        torch.cuda.synchronize()
        _check(got, want, f"{msg}/{kname}")


def test_criteo_per_feature_group(card):
    """26 per-feature vocabularies (Vocab(65536)) at B = 65536: the group
    takes the wide program struct (26 tables) in one launch, and each fit
    is one launch, all equal to their plain versions."""
    p = tp.criteo_per_feature(65536)(tp.PORT)
    host = p.compile("cuda", device="cpu")
    host.fit(tp.fit_batches())
    cp = p.compile("cuda", device=card)
    cp.state = host.state
    raw = tp.raw_batch(rows=65536)
    apply = cp.dataflow_launches(raw, "apply")
    assert [k for k, *_ in apply] == ["group_dataflow"]
    assert apply[0][2].program.wide
    fit = cp.dataflow_launches(tp.raw_batch(rows=4096), "fit")
    assert [k for k, *_ in fit] == ["fit_dataflow"] * 26
    _launch_all([(k, fn, args) for k, _, fn, args in apply + fit], "criteo26")


# the reference's output dtypes a Pipeline can name without an extension
# type (bfloat16 takes the kernel-level test below)
PIPELINE_DTYPES = [d for d in tp.OUT_DTYPES if d != "bfloat16"]


@pytest.mark.parametrize("fuse", ["auto", "off"])
@pytest.mark.parametrize("dtype", PIPELINE_DTYPES)
def test_output_dtypes(card, dtype, fuse):
    """Every output dtype through the group kernel (fused) and through the
    stage and packer kernels (staged), values in range."""
    p = tp.in_range_outputs(np.dtype(dtype))(tp.PORT).compile(
        "cuda", device=card, fuse=fuse)
    p.fit(tp.fit_batches())
    raw = tp.raw_batch(rows=1000)
    calls = p.dataflow_launches(raw, "apply")
    written = set()
    for _, _, fn, args in calls:
        got = fn(*args)
        written |= {str(g.dtype).removeprefix("torch.")
                    for g in (got if isinstance(got, tuple) else (got,))}
    assert dtype in written
    _launch_all([(k, fn, args) for k, _, fn, args in calls], dtype)


@pytest.mark.parametrize("dtype", tp.OUT_DTYPES)
def test_stage_and_packer_cast_to_every_dtype(card, dtype):
    """fused_stage and packer with each output dtype (bfloat16 included),
    on views off a 16-byte boundary and row counts off a vector."""
    rng = np.random.default_rng(12)
    out = getattr(torch, dtype)
    x = torch.tensor((rng.random((1001 * 13 + 1,)) * 100).astype(np.float32),
                     device=card)[1:].view(1001, 13)
    ids = torch.tensor(rng.integers(0, 250, size=(1001, 5)).astype(np.int32),
                       device=card)
    stage = kops.fused_stage([ops.Clamp(0.0, 90.0)], in_dtype=np.float32,
                             out_dtype=out)
    pack = kops.packer([13, 5], [np.float32, np.int32], out, pad_cols_to=32)
    _launch_all([("fused_stage", stage, [x]), ("packer", pack, [x, ids])],
                dtype)


@pytest.mark.parametrize("variant", ["uncached", "two_level", "cache_only",
                                     "stacked"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("dim", [128, 13])
def test_16bit_bags(card, dtype, variant, dim):
    """bfloat16 / float16 tables: each bag bit-equal to its plain version
    (both sum in float32 in one order and round once), the cached bags
    bit-equal to the uncached one, the stacked one to the per-feature
    launches; the 4-element path at dim 128, the scalar one at dim 13."""
    rng = np.random.default_rng(9)
    dt = getattr(torch, dtype)
    tbl = torch.tensor(rng.normal(size=(5000, dim)).astype(np.float32),
                       device=card).to(dt)
    idx = rng.integers(-1, 5003, size=(777, 8)).astype(np.int32)
    ids = torch.tensor(idx, device=card)
    uncached = kops.embedding_bag(tbl, ids)
    assert uncached.dtype == dt
    if variant == "uncached":
        _launch_all([("embedding_bag", kops.embedding_bag, [tbl, ids])],
                    dtype)
        return
    if variant == "stacked":
        tables = tbl.view(1, 5000, dim).expand(3, -1, -1).contiguous()
        cache = tbl[:300].view(1, 300, dim).expand(3, -1, -1).contiguous()
        slot = torch.tensor(rng.integers(-100, 303, size=(777, 3)).astype(
            np.int32), device=card)
        cold = ids[:, :3]
        _launch_all([("embedding_bag_cached", kbag._stacked_cached_bag,
                      [tables, cache, slot, cold])], dtype)
        got = kbag._stacked_cached_bag(tables, cache, slot, cold)
        want = torch.stack([kops.embedding_bag_cached(
            tables[t], cache[t], slot[:, t:t + 1], cold[:, t:t + 1])
            for t in range(3)], dim=1)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        return
    rows = 300 if variant == "two_level" else 5000
    slot = torch.tensor(np.where((idx >= 0) & (idx < rows), idx, -1).astype(
        np.int32), device=card)
    cold = ids if variant == "two_level" else None
    cache = tbl[:rows].contiguous()
    args = [tbl, cache, slot] + ([cold] if cold is not None else [])
    _launch_all([("embedding_bag_cached", kops.embedding_bag_cached, args)],
                dtype)
    got = kops.embedding_bag_cached(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, uncached)


def test_tile_byte_copy(card):
    """A 1023-column hex output: a row needs so much shared memory that a
    tile holds 2 rows, so digit plane d of a tile lies 2046 * d bytes into
    its stage (off a 4-byte boundary for odd d), the case the kernel copies
    byte by byte; at a row count whose last tile is 1 row."""
    w = 1023
    fn = df.make_output_dataflow(
        [df.StreamInput("h", w, np.dtype(np.uint8), 8)], (),
        [df.TileStep("map", "v", ("h",), (ops.Hex2Int(8), ops.Modulus(4099)))],
        [("v", w)], np.int32)
    assert fn.program.tile_rows() == 2
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 1 << 32, size=(301, w), dtype=np.uint64)
    hexes = tp.hex_planes(vals.astype(np.uint32), rng.random(vals.shape) < 0.1)
    _launch_all([("output_dataflow", fn, [torch.tensor(hexes, device=card)])],
                "byte_copy")


def _hex_views(card, rng, rows: int, cols: int) -> list:
    """Digit-major hex of ``rows x cols`` elements (non-hex bytes and
    missing strings among them), contiguous and as views 1, 5 and 16 bytes
    into a larger buffer (planes a stride apart that is or is not a
    multiple of 16 bytes, whatever ``rows * cols`` is)."""
    chars = np.frombuffer(b"0123456789abcdefABCDEFgz !~", np.uint8)
    raw = chars[rng.integers(0, len(chars), size=(8, rows, cols))]
    raw[:, rng.random((rows, cols)) < 0.1] = 0
    base = torch.tensor(raw, device=card)
    out = [base]
    for off in (1, 5, 16):
        buf = torch.zeros(base.numel() + off, dtype=torch.uint8, device=card)
        view = buf[off:].view(8, rows, cols)
        view.copy_(base)
        out.append(view)
    return out


STAGE_EDGE_ELEMS = [(1, 1), (7, 1), (65533, 1), (1000, 26), (65536, 26)]


@pytest.mark.parametrize("rows,cols", STAGE_EDGE_ELEMS)
def test_stage_kernel_edges(card, rows, cols):
    """The redesigned stage kernel on 1, 7 and 65533 elements, Pipeline
    III's 26 columns, hex views off a 16-byte boundary (vector heads) and
    planes a stride apart that is no multiple of 16 (the all-scalar path),
    missing strings and bytes that are no hex digit, and f32 views off 4,
    8 and 12 bytes; outputs of 4, 2 and 1 bytes."""
    rng = np.random.default_rng(rows * 31 + cols)
    hexes = _hex_views(card, rng, rows, cols)
    calls = []
    for out in (np.int32, np.int16, np.uint8):
        sparse = kops.fused_stage([ops.Hex2Int(8), ops.FillMissing(7),
                                   ops.Modulus(200)], in_dtype=np.uint8,
                                  out_dtype=out, hex_width=8)
        calls += [("fused_stage", sparse, [h]) for h in hexes]
    n = rows * cols
    flat = torch.tensor((rng.normal(size=n + 3) * 10).astype(np.float32),
                        device=card)
    flat[::5] = float("nan")
    dense = kops.fused_stage([ops.FillMissing(0.0), ops.Clamp(0.0),
                              ops.Logarithm()], in_dtype=np.float32,
                             out_dtype=np.float32)
    calls += [("fused_stage", dense, [flat[k:k + n].view(rows, cols)])
              for k in range(4)]
    _launch_all(calls, f"stage {rows}x{cols}")


BUILD_EDGES = ["n_1", "n_7", "n_65533", "view_off_4", "view_off_8",
               "view_off_12", "all_equal", "all_distinct", "out_of_range"]


@pytest.mark.parametrize("case", BUILD_EDGES)
def test_build_kernel_edges(card, case):
    """The redesigned build on 1, 7 and 65533 ids, id views off a 16-byte
    boundary, all-equal ids (one shared-table entry for every block),
    all-distinct ids (more per block than the shared table holds: the
    probe-overflow path) and ids that are negative or >= capacity."""
    rng = np.random.default_rng(len(case))
    cap = 65536
    if case.startswith("n_"):
        vals = rng.integers(0, cap, size=int(case[2:])).astype(np.int32)
    elif case.startswith("view_off_"):
        k = int(case[9:]) // 4
        vals = rng.integers(0, 5000, size=100003).astype(np.int32)
        buf = torch.tensor(np.concatenate([np.zeros(k, np.int32), vals]),
                           device=card)
        _launch_all([("vocab_build_chunk", kops.vocab_build_chunk,
                      [buf[k:], cap])], case)
        return
    elif case == "all_equal":
        vals = np.full(300001, 1234, np.int32)
    elif case == "all_distinct":
        cap = 1 << 22
        vals = rng.permutation(cap)[:1703936].astype(np.int32)
    else:
        vals = rng.integers(-cap, 2 * cap, size=300001).astype(np.int32)
        vals[::7] = -1
    _launch_all([("vocab_build_chunk", kops.vocab_build_chunk,
                  [torch.tensor(vals, device=card), cap])], case)


@pytest.mark.parametrize("kind", ["fit", "group", "packer"])
def test_wide_structs(card, kind):
    """The wide structs on programs that would fit the small ones: a fit
    and Pipeline III's group forced into ``WideProgram`` (no plan here
    needs a wide fit), and a 40-block packer (``WidePackArgs``), each equal
    to its plain version and to the small struct's launch."""
    rng = np.random.default_rng(40)
    if kind == "packer":
        fn = kops.packer([3] * 40, [np.float32, np.int32] * 20, np.int32,
                         pad_cols_to=128)
        blocks = [torch.tensor((rng.normal(size=(777, 3)) * 100).astype(
            np.float32 if k % 2 == 0 else np.int32), device=card)
            for k in range(40)]
        _launch_all([("packer", fn, blocks)], "40 blocks")
        return
    if kind == "fit":
        fn = df.make_fit_dataflow(
            [df.StreamInput("h", 26, np.dtype(np.uint8), 8)],
            [df.TileStep("map", "v", ("h",), (ops.Hex2Int(8),
                                              ops.Modulus(65536)))], "v",
            65536)
        args = [torch.tensor(tp.fit_edge_values("out_of_range", 3001, 26,
                                                65536), device=card)]
        name = "fit_dataflow"
    else:
        p = tp.BUILDERS["III"](tp.PORT).compile("cuda", device=card)
        p.fit(tp.fit_batches())
        ((name, _, fn, args),) = p.dataflow_launches(tp.raw_batch(rows=1000),
                                                     "apply")
    assert not fn.program.wide
    small = fn(*args)
    fn.program.wide, fn.program.template = True, None
    try:
        _launch_all([(name, fn, args)], f"wide {kind}")
        wide = fn(*args)
        torch.cuda.synchronize()
        _check(wide, small, f"wide {kind} vs small")
    finally:
        fn.program.wide, fn.program.template = False, None


# packer layouts (widths, pad_cols_to): staged_main's sparse output (one
# 26-column block), 26 and 128 one-column blocks, 33 blocks of widths 1, 3,
# 13 and 26 (rows off 16 bytes) and a row too wide for whole-row tiles (a
# 1500-column block beside narrow ones: windows of output columns)
PACK_LAYOUTS = {"1x26": ([26], 32), "26x1": ([1] * 26, 32),
                "33_mixed": ([1, 3, 13, 26] * 8 + [1], 1),
                "128x1": ([1] * 128, 128), "window": ([1500, 3, 13], 1)}
PACK_ROWS = ["1", "7", "R-1", "R+1", "65533", "full_tiles"]


def _pack_case(card, layout: str, out, rows: int, pad=None):
    """A packer of ``PACK_LAYOUTS[layout]`` (i32 and f32 blocks in turn)
    into ``out`` and its blocks at ``rows`` rows, values in [0, 100): block
    k is a contiguous view 4 * (k % 4) bytes past a 16-byte boundary, so
    every phase of the copies' heads runs."""
    widths, layout_pad = PACK_LAYOUTS[layout]
    dtypes = [np.float32 if k % 2 else np.int32 for k in range(len(widths))]
    fn = kops.packer(widths, dtypes, out,
                     pad_cols_to=layout_pad if pad is None else pad)
    rng = np.random.default_rng(rows + len(widths))
    blocks = []
    for k, (w, d) in enumerate(zip(widths, dtypes)):
        vals = torch.tensor((rng.random((rows, w)) * 100).astype(d),
                            device=card)
        off = k % 4
        buf = torch.zeros(rows * w + off, dtype=vals.dtype, device=card)
        blocks.append(buf[off:].view(rows, w))
        blocks[-1].copy_(vals)
        assert blocks[-1].data_ptr() % 16 == 4 * off
    return fn, blocks


def _pack_equal(fn, blocks, msg: str) -> None:
    """One counted launch, bit-equal to the plain version."""
    before = df.LAUNCHES["packer"]
    got = fn(*blocks)
    assert df.LAUNCHES["packer"] == before + 1, msg
    want = fn.plain(*blocks)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape, msg
    assert torch.equal(got, want), msg


@pytest.mark.parametrize("rows", PACK_ROWS)
@pytest.mark.parametrize("layout", sorted(PACK_LAYOUTS))
def test_packer_tiles(card, layout, rows):
    """The redesigned packer at row counts whose last tile is ragged (R is
    the layout's largest tile; ``full_tiles`` has PACK_TILES_PER_SM tiles
    of R an SM and a last one of R - 1 rows), bit-equal to its plain
    version."""
    fn, _ = _pack_case(card, layout, np.int32, 1)
    big, cols = df._pack_tile_max(fn.program)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    n = {"R-1": big - 1, "R+1": big + 1,
         "full_tiles": df.PACK_TILES_PER_SM * sms * big + big - 1}.get(
             rows) or int(rows)
    assert (cols == fn.program.out_cols) == (layout != "window")
    if rows == "full_tiles":
        assert df.pack_tile(fn.program, n, sms)[0] == big
    fn, blocks = _pack_case(card, layout, np.int32, n)
    _pack_equal(fn, blocks, f"{layout}/{n} rows")


@pytest.mark.parametrize("dtype", ["float32", "int32", *tp.OUT_DTYPES])
def test_packer_casts_every_layout(card, dtype):
    """Every output dtype on every packer layout, padded to multiples of 1
    and of 128 columns, at a row count off every tile (1000 rows)."""
    for layout in sorted(PACK_LAYOUTS):
        for pad in (1, 128):
            fn, blocks = _pack_case(card, layout, getattr(torch, dtype),
                                    1000, pad)
            _pack_equal(fn, blocks, f"{dtype}/{layout}/pad {pad}")


def test_group_kernel_under_refits(card):
    """The group kernel runs on the executor's stream while the trainer's
    thread swaps 8 incremental refits in: every delivered batch, tagged
    with the version that transformed it, equals a fresh compile at that
    version, and every refit is one fit launch per window event."""
    from repro_torch.online import EventBus, OnlineConfig, OnlineTrainer

    rows, n = 4096, 17
    tmpl = paper_pipeline("III", batch_size=rows, **tp.SMALL)
    bus = EventBus(capacity=64)
    job = EtlJob(tmpl, Source.events(bus, "ev"), backend="cuda", device=card)
    job.compiled.fit(iter(Source.synth("I", rows=2 * rows, batch_size=rows)))
    v0 = job.compiled.state.version
    feed = list(Source.synth("I", rows=n * rows, batch_size=rows, seed=5))
    published = [2]

    def step_fn(state, batch):
        # one event a step: every refit window holds the two newest
        if published[0] < n:
            bus.publish("ev", feed[published[0]])
            published[0] += 1
            if published[0] == n:
                bus.close()
        return state, {"loss": batch["dense"].sum()}

    tr = OnlineTrainer(job, None, step_fn,
                       OnlineConfig(refit_every=2, window_batches=2,
                                    get_timeout_s=0.1),
                       bus=bus, topic="ev", trace_batches=n)
    for ev in feed[:2]:
        bus.publish("ev", ev)
    before = dict(df.LAUNCHES)
    tr.run(deadline_s=120.0)
    torch.cuda.synchronize()
    launched = {k: df.LAUNCHES[k] - before[k] for k in before}
    assert tr.stats.steps == n and tr.stats.swaps == 8
    assert tr.stats.versions == list(range(v0 + 1, v0 + 9))
    assert launched["group_dataflow"] == n
    # windows at steps 2, 4, ..., 14 hold 2 events, step 16's the last one
    assert launched["fit_dataflow"] == tr.stats.refit_batches == 15
    assert len(tr.trace) == n
    assert len({v for v, _, _ in tr.trace}) >= 3
    fresh = {}
    for version, raw, packed in tr.trace:
        if version not in fresh:
            fresh[version] = tmpl.compile("cuda", device=card)
            fresh[version].state = tr.state_history[version]
        for k, v in fresh[version](raw).items():
            np.testing.assert_array_equal(packed[k], v.cpu().numpy(),
                                          err_msg=f"v{version}/{k}")


def test_row_tile_variants_agree(card):
    """Every row tile the ``row_tile`` knob can set, from one row up to the
    plan's, gives the group and fit kernels' results bit for bit (tail
    tiles included), and the kernels run at the tile the plan caps."""
    rows = 4096
    tmpl = paper_pipeline("III", batch_size=rows, **tp.SMALL)
    feed = list(Source.synth("I", rows=3 * rows + 1000, batch_size=rows,
                             seed=2))
    base = tmpl.compile("cuda", device=card)
    base.fit(iter(feed))
    want = [base(raw) for raw in (feed[0], feed[-1])]
    for t in (1, 16, 32, 128):
        cap = 1 << (t.bit_length() - 1)
        v = tmpl.compile("cuda", device=card, row_tile=t)
        assert v.kernel_tiles() == tuple(min(b, cap)
                                         for b in base.kernel_tiles())
        v.fit(iter(feed))
        for vid, tb in base.state.tables.items():
            np.testing.assert_array_equal(v.state.tables[vid], tb,
                                          err_msg=f"row_tile {t}: {vid}")
        for raw, w in zip((feed[0], feed[-1]), want):
            for k, x in v(raw).items():
                assert torch.equal(x, w[k]), (t, k)


@pytest.mark.parametrize("compute,rel", [("float32", 1e-4),
                                         ("bfloat16", 5e-2)])
def test_lm_forward_and_backward_match_the_cpu(card, compute, rel):
    """Reduced llama3_2_3b on the card against the CPU port from the same
    parameters: logits and every gradient within ``rel`` (float32: TF32
    off; bfloat16: the tolerance of the CPU parity tests against the
    reference), the loss within rtol ``rel / 10``."""
    import dataclasses
    from repro_torch.configs.registry import get_reduced
    from repro_torch.models import transformer as ttr
    cfg = dataclasses.replace(get_reduced("llama3_2_3b"),
                              compute_dtype=compute)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = ttr.Transformer(cfg, device="cpu", seed=3)
        gpu = ttr.Transformer(cfg, device=card, seed=4)
        gpu.load_jax_tree(_stack_tree(cpu.jax_tree()))
        rng = np.random.default_rng(0)
        tok = rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
        lab = rng.integers(-2, 4 * cfg.vocab_size, (4, 64)).astype(np.int32)
        outs = []
        for m, dev in ((cpu, "cpu"), (gpu, card)):
            b = {"tokens": torch.tensor(tok, device=dev),
                 "labels": torch.tensor(lab, device=dev)}
            loss = m.loss_fn(b)
            loss.backward()
            with torch.no_grad():
                logits = m(b["tokens"]).float().cpu()
            outs.append((float(loss.detach()), logits,
                         [p.grad.float().cpu() for p in m.parameters()]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (l0, x0, g0), (l1, x1, g1) = outs
    assert abs(l1 - l0) <= rel / 10 * abs(l0)
    assert float((x1 - x0).abs().max()) <= rel * float(x0.abs().max())
    for a, b in zip(g0, g1):
        assert float(torch.linalg.vector_norm(a - b)) <= \
            rel * float(torch.linalg.vector_norm(a))


def _stack_tree(tree):
    """A ``jax_tree`` with its per-layer lists stacked (JAX layout)."""
    from repro_torch.models import transformer as ttr
    if isinstance(tree, dict):
        return {k: _stack_tree(v) for k, v in tree.items()}
    return ttr.stacked(tree).cpu()


def test_three_tenants_on_the_card_match_their_plain_compiles(card):
    """Three gated tenants (stateless, small and large vocabulary) run at
    once on the card, each on its executor's stream: every batch each
    transformed equals its plain compile's on the same raw batch (integer
    outputs bit for bit, floats within rtol 1e-5: ``_check``)."""
    from repro_torch.etl_runtime.multitenant import (PipelineManager,
                                                     TransformService)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke  # its TappedPipeline keeps each transformed batch
    finally:
        sys.path.pop(0)
    rows = 4096
    fit = list(Source.synth("I", rows=2 * rows, batch_size=rows))
    mgr = PipelineManager(total_credits=8)
    plain = {}
    for name, which, w in (("stateless", "I", 2.0), ("vocab8k", "II", 1.0),
                           ("vocab512k", "III", 1.0)):
        tmpl = paper_pipeline(which, small_vocab=8192, batch_size=rows)
        p = tmpl.compile("cuda", device=card)
        p.fit(iter(fit))
        plain[name] = tmpl.compile("cuda", device="cpu")
        plain[name].state = p.state
        mgr.add(name, chip_smoke.TappedPipeline(p),
                Source.synth("I", rows=6 * rows, batch_size=rows,
                             seed=len(name)), weight=w)
    before = dict(df.LAUNCHES)
    svc = TransformService(mgr.weights)
    res = mgr.run(n_batches=6, service=svc)
    torch.cuda.synchronize()
    n_calls = 0
    for name, (tapped, _) in mgr.tenants.items():
        assert res[name].batches == 6 and len(tapped.calls) >= 6
        n_calls += len(tapped.calls)
        for raw, out in tapped.calls:
            for k, w in plain[name](raw).items():
                _check(out[k].cpu(), w, f"{name}/{k}")
    assert df.LAUNCHES["group_dataflow"] - before["group_dataflow"] == \
        n_calls == len(svc.grants)


def test_launch_counts_exact_when_four_threads_launch(card):
    p = paper_pipeline("I", modulus=4096, batch_size=2048).compile(
        "cuda", device=card)
    p.fit(iter(()))
    raw = tp.raw_batch(rows=2048)
    ((_, _, fn, args),) = p.dataflow_launches(raw, "apply")
    barrier = threading.Barrier(4)

    def work():
        s = torch.cuda.Stream(card)
        with torch.cuda.stream(s):
            barrier.wait()
            for _ in range(200):
                fn(*args)
        s.synchronize()

    threads = [threading.Thread(target=work) for _ in range(4)]
    before = df.LAUNCHES["group_dataflow"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert df.LAUNCHES["group_dataflow"] - before == 800


@pytest.mark.parametrize("compute,rel", [("float32", 1e-4),
                                         ("bfloat16", 5e-2)])
@pytest.mark.parametrize("arch", ["mixtral_8x7b", "kimi_k2"])
def test_moe_matches_the_cpu(card, arch, compute, rel):
    """The reduced MoE configs on the card against the CPU port from the
    same parameters: the first MoE layer's routing (``top_e``,
    ``pos_in_e``, ``keep``, ``slot``) equal on a seeded input; then the
    model's loss within rtol ``rel / 10``, its logits within ``rel`` of
    the largest and every gradient within ``rel`` in relative norm
    (float32: TF32 off; bfloat16: the CPU parity tests' tolerance).  The
    card's expert choices are pinned to the CPU run's: in float32 none of
    its own may differ; in bfloat16 the router's input differs in its last
    bits between the devices, so a token near a tie may pick another
    expert (measured: 1-2 of 256 rows a layer at kimi_k2, none at
    mixtral_8x7b), and at most 5 % of the rows may."""
    import dataclasses
    from repro_torch.configs.registry import get_reduced
    from repro_torch.models import moe
    from repro_torch.models import transformer as ttr
    cfg = dataclasses.replace(get_reduced(arch), compute_dtype=compute)
    real_top_k = moe.top_k
    chosen, calls, flips = [], [0], [0, 0]

    def recording(probs, k):
        vals, idx = real_top_k(probs, k)
        chosen.append(idx.cpu())
        return vals, idx

    def pinned(probs, k):
        _, own = real_top_k(probs, k)
        idx = chosen[calls[0]].to(probs.device)
        calls[0] += 1
        flips[0] += int((own != idx).any(-1).sum())
        flips[1] += idx.shape[0]
        return probs.gather(-1, idx), idx

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = ttr.Transformer(cfg, device="cpu", seed=3)
        gpu = ttr.Transformer(cfg, device=card, seed=4)
        gpu.load_jax_tree(_stack_tree(cpu.jax_tree()))
        rng = np.random.default_rng(0)
        xf = rng.normal(size=(96, cfg.d_model)).astype(np.float32)
        tok = rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
        lab = rng.integers(-2, 4 * cfg.vocab_size, (4, 64)).astype(np.int32)
        outs, plans = [], []
        for m, dev, top in ((cpu, "cpu", recording), (gpu, card, pinned)):
            with torch.no_grad():
                plans.append({k: v.cpu() for k, v in moe.route(
                    m.moe_blocks[0].moe, torch.tensor(xf, device=dev), cfg,
                    moe.capacity(96, cfg)).items()})
            b = {"tokens": torch.tensor(tok, device=dev),
                 "labels": torch.tensor(lab, device=dev)}
            moe.top_k = top
            try:
                loss = m.loss_fn(b)
                loss.backward()
                with torch.no_grad():
                    logits = m(b["tokens"]).float().cpu()
            finally:
                moe.top_k = real_top_k
            outs.append((float(loss.detach()), logits,
                         [p.grad.float().cpu() for p in m.parameters()]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for k in ("top_e", "pos_in_e", "keep", "slot"):
        assert torch.equal(plans[0][k], plans[1][k]), k
    assert calls[0] == len(chosen) > 0
    if compute == "float32":
        assert flips[0] == 0
    else:
        assert flips[0] <= 0.05 * flips[1]
    (l0, x0, g0), (l1, x1, g1) = outs
    assert abs(l1 - l0) <= rel / 10 * abs(l0)
    assert float((x1 - x0).abs().max()) <= rel * float(x0.abs().max())
    for a, b in zip(g0, g1):
        assert float(torch.linalg.vector_norm(a - b)) <= \
            rel * float(torch.linalg.vector_norm(a))


def _bf16_ulps(a, b, scale=None) -> float:
    import chip_smoke
    return chip_smoke.bf16_ulps(a.cpu(), b.cpu(),
                                None if scale is None else scale.cpu())


@pytest.mark.parametrize("optimizer", ["adafactor", "adamw"])
def test_bf16_state_step_matches_the_cpu(card, optimizer):
    """Two optimizer steps with bfloat16 parameters and state on the card
    against the CPU port from the same tensors (a stacked [2, 64, 96]
    leaf, stacked vectors [1, 64] and [2, 64], a [512, 64] matrix), the
    gradient inside the clip norm (the clip scale is a float32 reduction
    whose order differs between the devices): parameters and state within
    one bfloat16 unit in the last place (a parameter's at the larger of
    its old and new values)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.training import optimizer as topt
    tc = TrainConfig(optimizer=optimizer, opt_state_dtype="bfloat16",
                     lr=1e-2, weight_decay=0.1)
    rng = np.random.default_rng(0)
    shapes = [(64, 96), (64, 96), (64,), (64,), (64,), (512, 64)]
    leaves = [[0, 1], [2], [3, 4], 5]

    def tensors(scale):
        return [torch.tensor(rng.normal(size=s) * scale,
                             dtype=torch.float32).to(torch.bfloat16)
                for s in shapes]
    params, grads = tensors(1.0), tensors(2e-3)  # grad norm ~0.22
    runs = []
    for dev in ("cpu", card):
        ps = [p.clone().to(dev) for p in params]
        st = topt.opt_init(ps, tc, leaves=leaves)
        for i in range(2):
            topt.opt_update(ps, [g.to(dev) for g in grads], st, i, tc)
        flat = st["f"] if optimizer == "adafactor" else [
            {"m": m, "v": v} for m, v in zip(st["m"], st["v"])]
        runs.append((ps, flat))
    (p0, s0), (p1, s1) = runs
    assert float(topt.global_norm(grads)) < tc.max_grad_norm
    for a, b, old in zip(p0, p1, params):
        assert _bf16_ulps(a, b, old) <= 1
    for a, b in zip(s0, s1):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].shape == b[k].shape
            assert _bf16_ulps(a[k], b[k]) <= 1, k


@pytest.mark.parametrize("arch", ["llama3_2_3b", "mixtral_8x7b",
                                  "mamba2_370m"])
def test_serving_matches_the_cpu(card, arch):
    """The reduced dense, MoE (a 16-token ring) and SSM configs at float32
    compute, TF32 off: prefill of 20 tokens, then 4 decode steps, on the
    card against the CPU port from the same parameters: every step's
    logits and the final cache within rtol 1e-4 (absolute floor 1e-4 x
    the largest), cache positions bit-equal, and greedy ``generate``'s
    tokens equal."""
    import dataclasses
    from repro_torch.configs.registry import get_reduced
    from repro_torch.models import api
    from repro_torch.serving import decode
    cfg = dataclasses.replace(get_reduced(arch), compute_dtype="float32")
    model = api.build_model(cfg)

    def close(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        torch.testing.assert_close(b, a, rtol=1e-4,
                                   atol=1e-4 * float(a.abs().max()))

    def leaves(c):
        return [x for v in c.values() for x in
                (leaves(v) if isinstance(v, dict) else [v])]

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = model.init(seed=3, device="cpu")
        gpu = model.init(seed=4, device=card)
        gpu.load_jax_tree(_stack_tree(cpu.jax_tree()))
        tok = torch.tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 24)).astype(np.int32))
        out = []
        for m, dev in ((cpu, "cpu"), (gpu, card)):
            t = tok.to(dev)
            lg, cache = model.prefill(m, {"tokens": t[:, :20]}, 32)
            steps = [lg]
            for pos in range(20, 24):
                lg, cache = model.decode_step(m, cache, t[:, pos:pos + 1],
                                              pos)
                steps.append(lg)
            toks, _ = decode.generate(model, m, t[:, :20], max_new=6,
                                      max_len=26)
            out.append((steps, leaves(cache), toks))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (s0, c0, t0), (s1, c1, t1) = out
    for a, b in zip(s0, s1):
        close(a, b)
    for a, b in zip(c0, c1):
        if a.dtype.is_floating_point:
            close(a, b)
        else:
            assert torch.equal(a, b.cpu())
    np.testing.assert_array_equal(t0, t1)


@pytest.mark.parametrize("compute,rel", [("float32", 1e-4),
                                         ("bfloat16", 5e-2)])
@pytest.mark.parametrize("arch", ["zamba2_2_7b", "whisper_base"])
def test_hybrid_and_encdec_match_the_cpu(card, arch, compute, rel):
    """The reduced hybrid (a 16-slot ring, the SSD chunk 32) and enc-dec
    (32 frames) on the card against the CPU port from the same parameters
    (TF32 off): logits within ``rel`` x the largest, the loss within rtol
    ``rel / 10``, every gradient within ``rel`` in norm; then prefill (32
    tokens for the hybrid, past its ring; 16 for the enc-dec) and 4 decode
    steps: each step's logits within ``rel`` x the largest, every float
    cache leaf within ``rel`` in norm and the positions bit-equal."""
    import dataclasses
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.configs.registry import get_reduced
    from repro_torch.models import api
    cfg = dataclasses.replace(get_reduced(arch), compute_dtype=compute)
    model = api.build_model(cfg)
    S = 32 if arch == "zamba2_2_7b" else 16

    def leaves(c):
        return [x for _, v in sorted(c.items()) for x in
                (leaves(v) if isinstance(v, dict) else [v])]

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = model.init(seed=3, device="cpu")
        gpu = model.init(seed=4, device=card)
        gpu.load_jax_tree(_stack_tree(cpu.jax_tree()))
        # the hybrid's forward runs whole SSD chunks past the first
        batch = api.random_batch(cfg, ShapeCfg("t", 2 * S, 2, "train"),
                                 seed=0, device="cpu")
        out = []
        for m, dev in ((cpu, "cpu"), (gpu, card)):
            b = {k: v.to(dev) for k, v in batch.items()}
            loss = model.loss(m, b)
            loss.backward()
            with torch.no_grad():
                logits = model.forward(m, b).float().cpu()
            pre = {k: (v[:, :S] if k == "tokens" else v)
                   for k, v in b.items() if k != "labels"}
            lg, cache = model.prefill(m, pre, S + 8)
            steps = [lg.float().cpu()]
            for pos in range(S, S + 4):
                lg, cache = model.decode_step(
                    m, cache, b["tokens"][:, pos:pos + 1], pos)
                steps.append(lg.float().cpu())
            out.append((float(loss.detach()), logits,
                        [p.grad.float().cpu() for p in m.parameters()],
                        steps, [x.cpu() for x in leaves(cache)]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (l0, x0, g0, s0, c0), (l1, x1, g1, s1, c1) = out

    def norm_close(a, b):
        a, b = a.float(), b.float()
        assert float(torch.linalg.vector_norm(a - b)) <= \
            rel * float(torch.linalg.vector_norm(a))

    assert abs(l1 - l0) <= rel / 10 * abs(l0)
    for a, b in zip((x0, *s0), (x1, *s1)):
        assert float((b - a).abs().max()) <= rel * float(a.abs().max())
    for a, b in zip(g0, g1):
        norm_close(a, b)
    assert len(c0) == len(c1)
    for a, b in zip(c0, c1):
        if a.dtype.is_floating_point:
            norm_close(a, b)
        else:
            assert torch.equal(a, b)


def test_distributed_on_the_card(card, tmp_path):
    """One NCCL rank on the card against one gloo rank on the CPU:
    ``compressed_psum_mean`` bit-equal, ``put_packed``'s rows equal, and
    two FSDP steps (reduced llama3_2_3b, float32, microbatch 2) within
    rtol 1e-4 (losses, gradient norms) and 1e-4 of each leaf's norm."""
    import torch_dist as td
    got = td.spawn(td.card_rank, 1, tmp_path, "cuda", backend="nccl")[0]
    want = td.spawn(td.card_rank, 1, tmp_path, "cpu")[0]
    for k in ("mean", "ef"):
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(g, w)
    for k, v in want["placed"].items():
        np.testing.assert_array_equal(got["placed"][k], v)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    for g, w in zip(got["leaves"], want["leaves"]):
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)


def test_cache_rows_from_data_sharded_tables_on_the_card(card, tmp_path):
    """Two gloo ranks sharing the card: ``EmbedCache.advance`` on tables
    sharded over them on each dim (FSDP's DTensor) fills each rank's cache
    bit-equal to the whole tables' rows of its own plans, through the data
    group's collectives on CUDA tensors (``embed_cache_gather``)."""
    import torch_dist as td
    for rank in td.spawn(td.cache_rows_rank, 2, tmp_path, "cuda",
                         timeout=300):
        for d, ok, (nbytes, calls) in rank:
            assert ok and nbytes > 0 and calls > 0, (d, ok, nbytes, calls)


def test_example_twins_on_the_card(card, tmp_path):
    """``examples/torch_quickstart.py`` (its three backends agree, the
    cuda one's kernels included), ``torch_train_lm.py`` and
    ``torch_online_training.py`` run on the card, as a user runs them: in
    a subprocess, without ``--device``."""
    import os
    import subprocess
    root = Path(__file__).resolve().parents[1]
    runs = {"torch_quickstart.py": ([], ["[cuda  ] dense:(4096, 128)",
                                         "numpy, torch, cuda agree with "
                                         "numpy: True"]),
            "torch_train_lm.py": (["--steps", "3", "--batch", "4", "--seq",
                                   "64"], ["[train] done: 3 steps"]),
            "torch_online_training.py": (
                ["--duration", "4", "--refit-every", "4",
                 "--checkpoint-every", "4", "--ckpt-dir",
                 str(tmp_path / "ckpt")],
                ["[online] staleness p50/p95/p99"])}
    for example, (args, lines) in runs.items():
        out = subprocess.run(
            [sys.executable, str(root / "examples" / example), *args],
            cwd=tmp_path, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(root / "src")))
        assert out.returncode == 0, (example, out.stderr[-3000:])
        for line in lines:
            assert line in out.stdout, (example, line, out.stdout[-3000:])
