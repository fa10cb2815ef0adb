"""The CUDA kernels against their plain versions on the card (the dataflow
kernels and the staged lowering's four), and the stream handoff of the
executor.  Needs an NVIDIA GPU with nvcc: marked
``cuda`` and skipped elsewhere (a CUDA kernel has no interpret mode).

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro_torch.core.pipeline import paper_pipeline  # noqa: E402
from repro_torch.data.source import Source  # noqa: E402
from repro_torch.core import operators as ops  # noqa: E402
from repro_torch.kernels import dataflow as df  # noqa: E402
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
    lookup ids, float -> int packing."""
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
    return [("fused_stage", dense, [t(x)]),
            ("fused_stage", sparse, [t(hexes)]),
            ("fused_stage", bucket, [t(np.nan_to_num(x))]),
            ("vocab_build_chunk", kops.vocab_build_chunk, [t(vals), 65536]),
            ("vocab_lookup", kops.vocab_lookup, [t(ids), t(table), 4321]),
            ("packer", pack_i, [t(b) for b in blocks]),
            ("packer", pack_f, [t(b) for b in blocks])]


@pytest.mark.parametrize("case", range(7))
def test_staged_kernels_on_edge_inputs(card, case):
    kname, fn, args = _staged_edge_cases(card)[case]
    before = df.LAUNCHES[kname]
    got = fn(*args)
    assert df.LAUNCHES[kname] == before + 1
    want = fn.plain(*args)
    torch.cuda.synchronize()
    _check(got, want, f"{kname}/{case}")


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
