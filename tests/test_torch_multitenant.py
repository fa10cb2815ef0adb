"""The port's multitenancy (``etl_runtime/multitenant.py``, the executor's
``transform_service=``, ``EtlJob(transform_service=)``) against the JAX
package's: the arbiter's picks, the service's grant order and the credit
split are compared with the reference's on seeded scripts (exactly: they
are integer decisions), the reference's own multitenant expectations are
held on the port, and a gated job's batches are bit-equal to an ungated
job's on the CPU (the cuda backend's plain versions)."""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.etl_runtime import multitenant as rmt  # noqa: E402
from repro_torch.core.pipeline import paper_pipeline  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.data.source import Source  # noqa: E402
from repro_torch.etl_runtime import multitenant as mt  # noqa: E402
from repro_torch.etl_runtime.multitenant import (  # noqa: E402
    PipelineManager, TransformService, WeightedRoundRobin)
from repro_torch.session import EtlJob  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _pipe(**kw):
    return paper_pipeline("I", modulus=256, batch_size=500, **kw).compile(
        "cuda", device="cpu")


# ---------------------------------------------------------------------------
# decisions against the reference (seeded scripts)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_wrr_picks_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    weights = {f"t{i}": float(rng.choice([0.5, 1, 2, 3, 7.5]))
               for i in range(n)}
    ref, port = rmt.WeightedRoundRobin(weights), WeightedRoundRobin(weights)
    for _ in range(200):
        if rng.random() < 0.3:
            eligible = None
        else:
            k = int(rng.integers(1, n + 1))
            eligible = set(rng.choice(list(weights), size=k, replace=False))
        assert port.pick(eligible) == ref.pick(eligible)


def _grant_script(svc_cls, weights: dict, rounds: list) -> list:
    """Run an acquisition script: each round, a holder tenant takes the
    slot, the round's requests (one thread each) all queue behind it, and
    the holder releases; every granted thread releases at once.  Returns
    the grants."""
    svc = svc_cls({**weights, "holder": 1.0})
    holder = svc.gate("holder")  # never requested by the script itself
    for requests in rounds:
        assert holder.acquire()
        threads = []
        for name in requests:
            gate = svc.gate(name)

            def work(gate=gate):
                assert gate.acquire()
                gate.release()
            threads.append(threading.Thread(target=work))
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10
        while True:  # every request waiting before the slot frees
            with svc._cv:
                if sum(svc._waiting.values()) == len(requests):
                    break
            assert time.monotonic() < deadline
            time.sleep(0.001)
        holder.release()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
    return list(svc.grants)


@pytest.mark.parametrize("seed", range(4))
def test_transform_service_grants_equal_the_reference(seed):
    rng = np.random.default_rng(100 + seed)
    weights = {"a": 2.0, "b": 1.0, "c": float(rng.choice([1, 3]))}
    rounds = [list(rng.choice(list(weights), size=int(rng.integers(1, 6))))
              for _ in range(12)]
    want = _grant_script(rmt.TransformService, weights, rounds)
    got = _grant_script(TransformService, weights, rounds)
    assert got == want
    assert len(got) == 12 + sum(len(r) for r in rounds)
    assert got.count("holder") == 12


def test_transform_service_grants_are_bounded():
    svc = TransformService({"a": 1})
    gate = svc.gate("a")
    for _ in range(TransformService._GRANT_TRACE + 10):
        assert gate.acquire()
        gate.release()
    assert len(svc.grants) == TransformService._GRANT_TRACE


@pytest.mark.parametrize("seed", range(6))
def test_credit_allocation_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 10))
    budget = int(rng.integers(1, 13))  # more tenants than credits too
    ref, port = (rmt.PipelineManager(total_credits=budget),
                 PipelineManager(total_credits=budget))
    for i in range(n):
        w = float(rng.choice([0.25, 1, 2, 3, 5]))
        ref.add(f"t{i}", None, None, weight=w)
        port.add(f"t{i}", None, None, weight=w)
    assert port.credit_allocation() == ref.credit_allocation()


# ---------------------------------------------------------------------------
# the reference's multitenant expectations, on the port
# ---------------------------------------------------------------------------

def test_wrr_schedule_is_deterministic_and_proportional():
    wrr = WeightedRoundRobin({"a": 3, "b": 1})
    picks = [wrr.pick() for _ in range(8)]
    assert picks == ["a", "a", "b", "a"] * 2  # smooth WRR, 3:1
    wrr = WeightedRoundRobin({"a": 1, "b": 1, "c": 1})
    assert [wrr.pick({"b"}) for _ in range(3)] == ["b"] * 3
    with pytest.raises(ValueError):
        wrr.pick(set())
    with pytest.raises(ValueError):
        WeightedRoundRobin({"a": 0})


def test_transform_service_grants_follow_weights():
    svc = TransformService({"hot": 2, "cold": 1})
    hot = svc.gate("hot")
    order = []
    for _ in range(6):
        assert hot.acquire()
        order.append("hot")
        hot.release()
    assert order == ["hot"] * 6  # cold never waiting -> hot never starved
    assert list(svc.grants) == order
    with pytest.raises(KeyError):
        svc.gate("unknown")


def test_multitenant_concurrent_pipelines():
    mgr = PipelineManager()
    for i in range(3):
        mgr.add(f"t{i}", _pipe(),
                lambda i=i: synth.dataset_batches("I", rows=1500,
                                                  batch_size=500, seed=i))
    res = mgr.run(n_batches=3)
    assert len(res) == 3
    assert all(r.batches == 3 and r.rows == 1500 for r in res.values())
    assert all(r.rows_per_s > 0 for r in res.values())
    assert all(r.stage_breakdown["transform"]["items"] >= 3
               for r in res.values())


def test_multitenant_weights_split_credit_budget():
    mgr = PipelineManager(total_credits=6)
    mgr.add("heavy", _pipe(), Source.synth("I", rows=1000, batch_size=500,
                                           seed=0), weight=2.0)
    mgr.add("light", _pipe(), Source.synth("I", rows=1000, batch_size=500,
                                           seed=1), weight=1.0)
    assert mgr.credit_allocation() == {"heavy": 4, "light": 2}
    res = mgr.run(n_batches=2)
    assert res["heavy"].credits == 4 and res["light"].credits == 2
    assert res["heavy"].weight == 2.0
    assert all(r.batches == 2 for r in res.values())


def test_multitenant_swap_is_o1():
    mgr = PipelineManager()
    mgr.add("a", _pipe(), lambda: iter([]))
    new_pipe = _pipe()
    t0 = time.perf_counter()
    mgr.swap("a", new_pipe, lambda: iter([]))
    assert time.perf_counter() - t0 < 0.1
    assert mgr.tenants["a"][0] is new_pipe
    with pytest.raises(KeyError):
        mgr.swap("missing", new_pipe, lambda: iter([]))
    with pytest.raises(ValueError):
        mgr.add("a", new_pipe, lambda: iter([]))


def test_multitenant_service_weighted_run_grants_every_batch():
    """Two gated tenants: every transform was granted (grants counted on a
    service passed in), and each tenant's batches ran."""
    mgr = PipelineManager(total_credits=4, service_weighted=True)
    mgr.add("a", _pipe(), Source.synth("I", rows=1500, batch_size=500,
                                       seed=0), weight=2.0)
    mgr.add("b", _pipe(), Source.synth("I", rows=1500, batch_size=500,
                                       seed=1), weight=1.0)
    svc = TransformService(mgr.weights)
    res = mgr.run(n_batches=3, service=svc)
    assert all(r.batches == 3 for r in res.values())
    transformed = {n: r.stage_breakdown["transform"]["items"]
                   for n, r in res.items()}
    grants = list(svc.grants)
    assert {n: grants.count(n) for n in res} == transformed


# ---------------------------------------------------------------------------
# gated jobs: the same batches as ungated ones
# ---------------------------------------------------------------------------

def test_gated_jobs_deliver_the_ungated_batches():
    tmpl = paper_pipeline("II", small_vocab=2048, batch_size=400)
    fitted = EtlJob(tmpl, backend="cuda", device="cpu",
                    fit_source=Source.synth("I", rows=800, batch_size=400))
    fitted.fit()
    pipe = fitted.compiled
    svc = TransformService({"x": 2.0, "y": 1.0})

    def job(seed, gate=None):
        return EtlJob(pipe, Source.synth("I", rows=2000, batch_size=400,
                                         seed=seed),
                      transform_service=gate, credits=2)

    def drain(j, out):
        with j.batches() as ex:
            out.extend({k: v.clone() for k, v in b.items()} for b in ex)

    got = {"x": [], "y": []}
    threads = [threading.Thread(target=drain,
                                args=(job(s, svc.gate(n)), got[n]))
               for n, s in (("x", 1), ("y", 2))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    for n, s in (("x", 1), ("y", 2)):
        want = []
        drain(job(s), want)
        assert len(got[n]) == len(want) == 5
        for g, w in zip(got[n], want):
            assert g.keys() == w.keys()
            for k in g:
                assert torch.equal(g[k], w[k]), (n, k)
    assert sorted(svc.grants) == ["x"] * 5 + ["y"] * 5


def test_gate_is_released_after_a_failed_transform():
    svc = TransformService({"x": 1.0, "y": 1.0})

    def boom(raw):
        raise ValueError("transform failed")

    j = EtlJob(boom, Source.synth("I", rows=400, batch_size=200),
               transform_service=svc.gate("x"))
    with pytest.raises(RuntimeError):
        with j.batches() as ex:
            list(ex)
    gate = svc.gate("y")
    assert gate.acquire()  # the failed tenant's grant was released
    gate.release()


def test_wait_for_skips_cpu_tensors():
    mt._wait_for({"a": torch.zeros(2), "b": np.zeros(2)})


def test_example_twin_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" /
                             "torch_multitenant_pipelines.py"),
         "--device", "cpu", "--batch", "512", "--batches", "2"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    for name in ("stateless", "vocab8k", "vocab512k"):
        assert f"[tenant {name}" in out.stdout
    assert "after swap" in out.stdout


def test_dlrm_example_twin_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_train_dlrm_e2e.py"),
         "--device", "cpu", "--steps", "6", "--batch", "256", "--vocab",
         "1024"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[e2e] 6 steps" in out.stdout and "trainer utilization" in \
        out.stdout


def test_launch_counts_are_exact_under_concurrent_wrappers():
    """Every tenant's transform thread (and a trainer's refits) counts its
    launches into one dict: ``count_launch`` holds a lock, so no increment
    is lost however the threads interleave."""
    from repro_torch.kernels import backend
    n_threads = 2 * (os.cpu_count() or 4)  # more threads than cores
    before = backend.LAUNCHES["group_dataflow"]
    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait()
        for _ in range(5000):
            backend.count_launch("group_dataflow")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert backend.LAUNCHES["group_dataflow"] - before == n_threads * 5000


def test_device_time_is_split_by_marked_stream():
    """``chip_smoke.device_ms_by_stream`` on a synthetic profiler trace: a
    stream takes the name of the marker copy found on it; its kernels,
    copies and memsets count for that name, the markers themselves not;
    every other stream's work is "other"."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))

    def gpu(cat, stream, dur, nbytes=None):
        args = {"stream": stream, "correlation": 0}
        if nbytes is not None:
            args["bytes"] = nbytes
        return {"ph": "X", "cat": cat, "dur": dur, "args": args}

    ev = [gpu("gpu_memcpy", 25, 2.0, 4096), gpu("gpu_memcpy", 29, 2.0, 4100),
          gpu("gpu_memcpy", 25, 800.0, 1 << 20), gpu("kernel", 25, 40.0),
          gpu("gpu_memset", 25, 10.0, 64), gpu("kernel", 29, 300.0),
          gpu("kernel", 7, 50.0),
          {"ph": "X", "cat": "cuda_runtime", "tid": 1, "dur": 9.0,
           "args": {"correlation": 0}}]
    got = chip_smoke.device_ms_by_stream({"traceEvents": ev},
                                         {"a": 4096, "b": 4100, "c": 4104})
    assert got == pytest.approx({"a": 0.85, "b": 0.3, "c": 0.0, "other": 0.05})
