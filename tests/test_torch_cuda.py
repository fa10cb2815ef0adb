"""The CUDA kernels against their plain versions on the card, and the
stream handoff of the executor.  Needs an NVIDIA GPU with nvcc: marked
``cuda`` and skipped elsewhere (a CUDA kernel has no interpret mode).

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro_torch.core.pipeline import paper_pipeline  # noqa: E402
from repro_torch.data.source import Source  # noqa: E402
from repro_torch.kernels import dataflow as df  # noqa: E402
from repro_torch.session import EtlJob  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _check(got, want, msg):
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, msg
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=0,
                                       equal_nan=True, msg=msg)
        else:
            assert torch.equal(g, w), msg


@pytest.mark.parametrize("optimize", ["auto", "off"])
@pytest.mark.parametrize("name", ["I", "II", "III", "sink"])
def test_kernels_match_plain_versions(card, name, optimize):
    p = tp.BUILDERS[name](tp.PORT).compile("cuda", device=card,
                                           optimize=optimize)
    p.fit(tp.fit_batches())
    raw = tp.raw_batch(rows=1000)  # not a multiple of any row tile
    before = dict(df.LAUNCHES)
    n = 0
    for kname, what, fn, args in (p.dataflow_launches(raw, "apply")
                                  + p.dataflow_launches(raw, "fit")):
        got = fn(*args)
        prog = fn.program
        if kname == "fit_dataflow":
            want = df.fit_dataflow_plain(prog, args)
        else:
            want = df.apply_dataflow_plain(prog, args[:prog.n_src],
                                           args[prog.n_src:])
        torch.cuda.synchronize()
        _check(got, want, f"{name}/{kname}/{what}")
        n += 1
    assert sum(df.LAUNCHES.values()) - sum(before.values()) == n


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
