"""The port's PipelineController against the JAX package's: the scenarios of
``tests/test_controller.py`` run on ``repro_torch`` (its controller, its
executor, ``tests/torch_simclock.py``), and wherever a scenario takes
decisions the reference's controller runs the same workload under the same
seed and its decision log must be identical."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import simclock  # noqa: E402
import torch_simclock  # noqa: E402
from proptest import given, strategies as st  # noqa: E402
from torch_parity import assert_outputs_match, fit_batches, raw_batch  # noqa: E402
from torch_simclock import SimPipeline, SimWorkload, VirtualClock  # noqa: E402

from repro_torch.core.pipeline import paper_pipeline  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.data.source import Source  # noqa: E402
from repro_torch.etl_runtime import controller as port_ctl  # noqa: E402
from repro_torch.etl_runtime.controller import (Knob,  # noqa: E402
                                                PipelineController)
from repro_torch.etl_runtime.runtime import StreamingExecutor  # noqa: E402
from repro_torch.session import EtlJob  # noqa: E402


def _ref_controller():
    from repro.etl_runtime import controller
    return controller


def _climb(sim, ctl_mod, seed, windows=30, **kw):
    """Run a throughput-mode controller over ``sim``'s workload; return the
    workload and the controller."""
    w = sim.SimWorkload()
    ctl = ctl_mod.PipelineController(w.make_knobs(), mode="throughput",
                                     seed=seed, tolerance=0.005, **kw)
    for _ in range(windows):
        ctl.observe_window(w.throughput())
    return w, ctl


# ---------------- simulation harness sanity ----------------

def test_simpipeline_consumer_bound_is_analytic():
    r = SimPipeline([0.5], [2], 1.0).run(8)
    assert r.makespan == pytest.approx(0.5 + 8 * 1.0)
    assert r.starved() == 1
    assert r.consumer_waits[0] == pytest.approx(0.5)
    assert all(w == 0.0 for w in r.consumer_waits[1:])
    assert r.stage_busy_s[0] == pytest.approx(8 * 0.5)
    ref = simclock.SimPipeline([0.5], [2], 1.0).run(8)
    assert (r.makespan, r.consumer_waits) == (ref.makespan,
                                              ref.consumer_waits)


def test_simpipeline_credits_absorb_spikes():
    def spiky(i):
        return 3.0 if i % 4 == 3 else 0.2

    shallow = SimPipeline([spiky], [1], 1.0).run(32)
    deep = SimPipeline([spiky], [4], 1.0).run(32)
    assert deep.throughput > shallow.throughput
    assert deep.starved() < shallow.starved()


# ---------------- hill-climber convergence ----------------

@pytest.mark.parametrize("seed", [0, 1, 5])
def test_converges_within_10pct_of_sweep_optimum(seed):
    """<= 30 windows land within 10 % of the exhaustive-sweep optimum, and
    the decision log is the reference's, decision for decision."""
    w = SimWorkload()
    best, _ = w.optimum()
    untuned = w.throughput()
    w, ctl = _climb(torch_simclock, port_ctl, seed)
    ref_w, ref_ctl = _climb(simclock, _ref_controller(), seed)
    assert ctl.decision_log() == ref_ctl.decision_log()
    assert ctl.restore_best() == ref_ctl.restore_best()
    final = w.throughput()
    assert final == ref_w.throughput()
    assert ctl.window <= 30
    assert final >= 0.90 * best
    assert final >= untuned
    domains = {k.name: set(k.candidates) for k in ctl.knobs}
    for _, knob, _, value in ctl.decision_log():
        assert value in domains[knob]


def test_convergence_is_deterministic_under_fixed_seed():
    runs = []
    for _ in range(2):
        w, ctl = _climb(torch_simclock, port_ctl, 3)
        runs.append((ctl.decision_log(), ctl.knob_values(), dict(w.settings)))
    assert runs[0] == runs[1]
    ref_w, ref_ctl = _climb(simclock, _ref_controller(), 3)
    assert runs[0] == (ref_ctl.decision_log(), ref_ctl.knob_values(),
                       dict(ref_w.settings))


def test_throughput_drift_reopens_a_converged_search():
    logs = []
    for sim, mod in ((torch_simclock, port_ctl),
                     (simclock, _ref_controller())):
        w = sim.SimWorkload()
        ctl = mod.PipelineController(w.make_knobs(), mode="throughput",
                                     seed=0, tolerance=0.005)
        quiet = 0
        for _ in range(80):
            quiet = quiet + 1 if not ctl.observe_window(w.throughput()) else 0
            if quiet >= 3:
                break
        assert quiet >= 3, "climber never converged"
        w.train_cost = 3.0
        probed = []
        for _ in range(3):
            probed += [d for d in ctl.observe_window(w.throughput())
                       if d.action == "probe"]
        assert probed, "drift did not reopen the search"
        logs.append(ctl.decision_log())
    assert logs[0] == logs[1]


# ---------------- property: tuned never below untuned ----------------

@given(st.lists(st.floats(0.05, 1.5), min_size=1, max_size=3),
       st.floats(0.2, 1.2), st.integers(0, 999))
def test_tuning_never_decreases_steady_state_throughput(costs, train, seed):
    """Random stage costs: after restore_best() the tuned throughput is >=
    the untuned, every applied value is in bounds, and the reference's
    controller takes the same decisions."""
    logs = []
    for sim, mod in ((torch_simclock, port_ctl),
                     (simclock, _ref_controller())):
        settings = {"credits": 2, "prefetch_depth": 1}

        def tput():
            spiky = [(lambda i, c=c: c * (5.0 if i % 5 == 4 else 1.0))
                     for c in costs]
            caps = ([max(settings["credits"], settings["prefetch_depth"])]
                    + [settings["credits"]] * (len(costs) - 1))
            return sim.SimPipeline(spiky, caps, train).run(24).throughput

        def setter(name):
            return lambda v: settings.__setitem__(name, v)

        knobs = [mod.Knob("credits", (1, 2, 3, 4, 6, 8), value=2,
                          apply=setter("credits"), kind="queue",
                          bytes_per_unit=1 << 20),
                 mod.Knob("prefetch_depth", (1, 2, 4, 8), value=1,
                          apply=setter("prefetch_depth"), kind="queue",
                          bytes_per_unit=1 << 20)]
        untuned = tput()
        ctl = mod.PipelineController(knobs, mode="throughput", seed=seed,
                                     tolerance=0.005)
        for _ in range(24):
            ctl.observe_window(tput())
            for k in knobs:
                assert k.value in k.candidates
        ctl.restore_best()
        assert tput() >= untuned * (1 - 1e-9)
        domains = {k.name: set(k.candidates) for k in knobs}
        for _, knob, _, value in ctl.decision_log():
            assert value in domains[knob]
        logs.append(ctl.decision_log())
    assert logs[0] == logs[1]


# ---------------- memory-pressure guard ----------------

def test_pressure_shrinks_queue_knobs_first_largest_first():
    logs = []
    for sim, mod in ((torch_simclock, port_ctl),
                     (simclock, _ref_controller())):
        w = sim.SimWorkload()
        w.settings.update(credits=8, prefetch_depth=8, row_tile=256,
                          fuse=True)
        pressure = {"level": 0.0}
        ctl = mod.PipelineController(
            w.make_knobs(), mode="throughput", seed=0, tolerance=0.005,
            memory_pressure=lambda: pressure["level"])
        ctl.observe_window(w.throughput())
        before = ctl.total_queued_bytes()
        assert before > 0
        pressure["level"] = 1.0
        windows = 0
        while ctl.total_queued_bytes() > before / 2:
            decisions = ctl.observe_window(w.throughput())
            windows += 1
            assert windows <= 10, "guard failed to halve queued bytes"
            assert all(d.action in ("pressure-shrink", "revert")
                       for d in decisions)
        assert w.settings["credits"] < 8 and w.settings["prefetch_depth"] < 8
        assert w.settings["row_tile"] == 256 and w.settings["fuse"] is True
        first = [d for d in ctl.decisions if d.action == "pressure-shrink"]
        assert first[0].knob == "credits"
        pressure["level"] = 0.0
        resumed = []
        for _ in range(2):
            resumed += ctl.observe_window(w.throughput())
        assert any(d.action == "probe" for d in resumed)
        logs.append(ctl.decision_log())
    assert logs[0] == logs[1]


def test_pressure_shrinks_compute_knobs_only_at_queue_floor():
    w = SimWorkload()
    w.settings.update(credits=1, prefetch_depth=1, row_tile=512, fuse=False)
    ctl = PipelineController(w.make_knobs(), mode="throughput",
                             memory_pressure=lambda: 1.0)
    ctl.observe_window(w.throughput())
    shrunk = [d.knob for d in ctl.decisions if d.action == "pressure-shrink"]
    assert "row_tile" in shrunk
    assert w.settings["row_tile"] == 256


def _int_source(n):
    for i in range(n):
        yield {"x": np.full((4, 4), i, np.int32)}


def test_pressure_on_live_executor_no_deadlock_no_drops():
    """Sustained pressure on the port's executor shrinks the staging
    footprint >= 2x, every batch arrives once, in order, and the decision
    log is the reference executor's."""
    from repro.etl_runtime.runtime import StreamingExecutor as RefExecutor
    N = 12
    logs = []
    for ex_cls, mod in ((StreamingExecutor, port_ctl),
                        (RefExecutor, _ref_controller())):
        ctl = mod.PipelineController([], mode="throughput",
                                     window_deliveries=2,
                                     memory_pressure=lambda: 1.0)
        ex = ex_cls(lambda b: b, _int_source(N), credits=4, max_credits=8,
                    autotune=ctl)
        before = ctl.total_queued_bytes()
        got = [int(np.asarray(b["x"])[0, 0]) for b in ex]
        assert got == list(range(N))
        assert ex.stats.dropped_stale == 0
        assert ex.current_credits == 1
        assert ctl.total_queued_bytes() <= before / 2
        assert ex.join(timeout=5.0)
        logs.append(ctl.decision_log())
    assert logs[0] == logs[1]


# ---------------- occupancy-mode hysteresis ----------------

def _alternating_signals(ctl, windows=12):
    for i in range(windows):
        if i % 2 == 0:
            ctl.observe_window(1.0, starved=ctl.window_deliveries,
                               always_full=False)
        else:
            ctl.observe_window(1.0, starved=0, always_full=True)
    return [d for d in ctl.decisions if d.action in ("grow", "shrink")]


def _occupancy_controller(mod, hysteresis):
    store = {"credits": 4}
    knob = mod.Knob("credits", tuple(range(1, 9)), value=4,
                    apply=lambda v: store.__setitem__("credits", v),
                    kind="queue", bytes_per_unit=1 << 20)
    return mod.PipelineController([knob], mode="occupancy",
                                  window_deliveries=4, hysteresis=hysteresis)


def test_hysteresis_damps_adaptive_credit_oscillation():
    undamped = _occupancy_controller(port_ctl, hysteresis=0)
    resizes0 = _alternating_signals(undamped)
    assert undamped.suppressed_flips == 0
    flips0 = sum(1 for a, b in zip(resizes0, resizes0[1:])
                 if a.action != b.action)
    assert flips0 >= 8

    damped = _occupancy_controller(port_ctl, hysteresis=2)
    resizes2 = _alternating_signals(damped)
    assert damped.suppressed_flips >= 3
    assert len(resizes2) < len(resizes0)
    for a, b in zip(resizes2, resizes2[1:]):
        if a.action != b.action:
            assert b.window - a.window > 2
    ref = _occupancy_controller(_ref_controller(), hysteresis=2)
    _alternating_signals(ref)
    assert damped.decision_log() == ref.decision_log()
    assert damped.suppressed_flips == ref.suppressed_flips


# ---------------- knob-application equivalence ----------------

def test_with_knobs_matches_fresh_compile_bit_exact():
    """with_knobs(row_tile / fuse) on "cuda" (plain versions on the CPU) is
    bit-identical to a fresh compile at those settings, and round-trips."""
    raw = raw_batch()
    p = paper_pipeline("II", small_vocab=2048)
    cp = p.compile("cuda", device="cpu")
    cp.fit(fit_batches())
    base_tile = cp.plan.row_tile

    swapped = cp.with_knobs(row_tile=128, fuse={"sparse"})
    assert swapped.plan.row_tile == 128
    assert swapped.fuse_spec() == frozenset({"sparse"})
    fresh = p.compile("cuda", device="cpu", row_tile=128, fuse={"sparse"})
    fresh.fit(fit_batches())
    got = swapped(raw)
    want = fresh(raw)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    back = swapped.with_knobs(row_tile=base_tile, fuse="auto")
    assert back.plan.row_tile == base_tile and back.fuse_spec() == "auto"
    base = cp(raw)
    for k, v in back(raw).items():
        assert torch.equal(v, base[k]), k
    oracle = p.compile("numpy")
    oracle.state = cp.state
    assert_outputs_match(oracle(raw), got, "vs numpy oracle")


def test_row_tile_caps_the_kernels_rows_per_tile():
    """The plan's row_tile caps the dataflow kernels' rows per tile (the
    largest power of two under it; shared memory halves it further), and
    the launch struct of every group and fit kernel carries that tile."""
    from repro_torch.kernels import dataflow as df
    cp = paper_pipeline("II", small_vocab=2048).compile("cuda", device="cpu")
    base = cp.kernel_tiles()
    assert base and all(1 <= b <= cp.plan.row_tile for b in base)
    for t in (1, 16, 48, 128, 512):
        v = cp.with_knobs(row_tile=t)
        want = tuple(min(b, 1 << (t.bit_length() - 1)) for b in base)
        assert v.kernel_tiles() == want, t
        progs = [fn.program for fn in (*v._group_fns, *v._fit_fns.values())]
        assert [df._c_template(pr).tile_rows for pr in progs] == \
            [pr.tile_rows() for pr in progs]


def test_row_tile_swap_mid_run_bit_identical():
    """A mid-stream swap_pipeline on "cuda" (device="cpu"): every batch,
    whichever compile processed it, equals the fresh compile."""
    batches = list(synth.dataset_batches("I", rows=4000, batch_size=1000,
                                         seed=3))
    p = paper_pipeline("II", small_vocab=2048)
    cp = p.compile("cuda", device="cpu")
    cp.fit(fit_batches())
    fresh = p.compile("cuda", device="cpu", row_tile=128)
    fresh.fit(fit_batches())

    ex = StreamingExecutor(cp, iter(batches), credits=2)
    it = iter(ex)
    got = [next(it), next(it)]
    ex.swap_pipeline(cp.with_knobs(row_tile=128))
    got.extend(it)
    assert ex.pipeline.plan.row_tile == 128
    assert len(got) == len(batches)
    for i, (raw, out) in enumerate(zip(batches, got)):
        want = fresh(raw)
        for k in want:
            assert torch.equal(out[k], want[k]), (i, k)
    assert ex.join(timeout=5.0)


def test_autotune_job_swaps_every_batch_bit_equal():
    """EtlJob(autotune=...) on "cuda" (device="cpu"): the declared row_tile
    and fuse knobs' actuators swap cached variants into the running
    executor, and every delivered batch equals the untuned run's batch of
    the same index."""
    tmpl = paper_pipeline("III", small_vocab=2048, large_vocab=8192,
                          batch_size=500)

    def job(autotune):
        j = EtlJob(tmpl, Source.synth("I", rows=12 * 500, batch_size=500,
                                      seed=4),
                   backend="cuda", device="cpu", autotune=autotune,
                   fit_source=Source.synth("I", rows=1000, batch_size=500))
        j.fit()
        return j

    plain = job(None)
    with plain.batches() as ex:
        want = [dict(b) for b in ex]
    ctl = PipelineController([], window_deliveries=2)
    tuned = job(ctl)
    got = []
    with tuned.batches() as ex:
        knobs = {k.name: k for k in ctl.knobs}
        assert set(knobs) >= {"row_tile", "fuse", "credits", "prefetch_depth"}
        for i, b in enumerate(ex):
            got.append(dict(b))
            if i == 3:
                rt = knobs["row_tile"]
                rt.set(next(c for c in rt.candidates if c != rt.value))
                knobs["fuse"].set(False)
            if i == 7:
                knobs["fuse"].set(True)
    assert len(got) == len(want) == 12
    base_tile = tuned.compiled.plan.row_tile
    assert any(t != base_tile for t, _ in tuned.swap_log)
    assert any(not f for _, f in tuned.swap_log)
    assert tuned.stats().controller is ctl and ctl.window == 6
    for i, (w, g) in enumerate(zip(want, got)):
        for k in w:
            assert torch.equal(w[k], g[k]), (i, k)


# ---------------- virtual-clock seam through the live executor ----------

def test_virtual_clock_drives_stage_timers():
    clock = VirtualClock()

    def pipe(b):
        clock.advance(0.25)
        return b

    ex = StreamingExecutor(pipe, _int_source(4), credits=2, clock=clock)
    assert sum(1 for _ in ex) == 4
    assert ex.stats.stages["transform"].busy_s == 1.0
    assert ex.stats.stages["place"].busy_s == 0.0
    assert 0.0 <= ex.stats.consumer_wait_s <= 1.0
    assert ex.join(timeout=5.0)


def test_on_delivery_windows_use_injected_clock():
    logs = []
    for clock_cls, mod in ((VirtualClock, port_ctl),
                           (simclock.VirtualClock, _ref_controller())):
        clock = clock_cls()
        store = {"credits": 2}
        knob = mod.Knob("credits", (1, 2, 3, 4), value=2,
                        apply=lambda v: store.__setitem__("credits", v),
                        kind="queue", bytes_per_unit=1 << 20)
        ctl = mod.PipelineController([knob], mode="occupancy", clock=clock,
                                     window_deliveries=4, hysteresis=0)
        decisions = []
        for _ in range(4):
            clock.advance(0.5)
            decisions += ctl.on_delivery(wait_s=0.2, ready_full=False)
        assert [d.action for d in decisions] == ["grow"]
        assert store["credits"] == 3
        logs.append(ctl.decision_log())
    assert logs[0] == logs[1]


def test_knob_rejects_out_of_bounds():
    k = Knob("credits", (1, 2), value=1)
    with pytest.raises(ValueError):
        k.set(3)
    with pytest.raises(ValueError):
        Knob("empty", ())
