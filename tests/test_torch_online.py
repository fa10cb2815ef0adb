"""The port's online-training subsystem (``repro_torch.online``, the
executor's queues, ``fit_incremental``, ``EmbedCache.invalidate``) as
``tests/test_online.py`` tests the JAX package's, and against it: the
incremental refit's tables after the same increments, the Prometheus text,
and an ``OnlineTrainer`` whose every traced batch equals a fresh compile
at its vocabulary version.  Every wait on a thread is bounded (10 s)."""

import threading
import time
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.pipeline import paper_pipeline  # noqa: E402
from repro_torch.data.source import Source  # noqa: E402
from repro_torch.etl_runtime import metrics as metrics_lib  # noqa: E402
from repro_torch.etl_runtime.lookahead import (EmbedCache,  # noqa: E402
                                               EmbedCacheConfig,
                                               LookaheadPlanner,
                                               cached_embedding_lookup)
from repro_torch.etl_runtime.runtime import (CreditQueue,  # noqa: E402
                                             RuntimeStats, StreamingExecutor)
from repro_torch.models import dlrm  # noqa: E402
from repro_torch.online import (BusClient, BusServer, EventBus,  # noqa: E402
                                FreshnessShedder, OnlineConfig,
                                OnlineTrainer, replay)
from repro_torch.session import EtlJob  # noqa: E402
from repro_torch.training import checkpoint as ck  # noqa: E402
from repro_torch.training.train_loop import (TrainState,  # noqa: E402
                                             make_train_step)

WAIT_S = 10.0


def _batches(n, *, batch=32, seed=0, schema="I"):
    return list(Source.synth(schema, rows=batch * n, batch_size=batch,
                             seed=seed))


def _toy_batch(i):
    return {"x": np.full((4,), i, dtype=np.int32)}


def _run_thread(fn) -> threading.Thread:
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    return t


# ---------------- event bus ----------------

def test_bus_publish_subscribe_fifo():
    bus = EventBus()
    sub = bus.subscribe("t")
    for i in range(5):
        bus.publish("t", _toy_batch(i))
    got = [sub.get(timeout=WAIT_S) for _ in range(5)]
    assert all(ev is not None for ev in got)
    assert [int(ev[0]["x"][0]) for ev in got] == [0, 1, 2, 3, 4]
    arrivals = [ev[1] for ev in got]
    assert arrivals == sorted(arrivals)
    bus.close()


def test_bus_bounded_drop_oldest():
    bus = EventBus(capacity=4)
    sub = bus.subscribe("t")
    shed = sum(bus.publish("t", _toy_batch(i)) for i in range(10))
    assert shed == 6 and sub.dropped == 6
    vals = [int(ev[0]["x"][0]) for ev in iter(sub.get_nowait, None)]
    assert vals == [6, 7, 8, 9]
    bus.close()


def test_bus_fanout_and_unrouted():
    bus = EventBus()
    a, b = bus.subscribe("t"), bus.subscribe("t")
    bus.publish("t", _toy_batch(1))
    bus.publish("nobody", _toy_batch(2))
    assert a.get(timeout=WAIT_S) is not None
    assert b.get(timeout=WAIT_S) is not None
    c = bus.counts()
    assert c["t"]["published"] == 1 and c["nobody"]["unrouted"] == 1
    bus.close()


def test_bus_close_wakes_blocked_get():
    bus = EventBus()
    sub = bus.subscribe("t")
    t0 = time.monotonic()
    timer = threading.Timer(0.05, bus.close)
    timer.start()
    assert sub.get(timeout=WAIT_S) is None
    assert time.monotonic() - t0 < WAIT_S  # woke on close, not timeout
    with pytest.raises(RuntimeError):
        bus.publish("t", _toy_batch(0))
    timer.join(WAIT_S)


def test_bus_socket_transport_roundtrip():
    bus = EventBus()
    sub = bus.subscribe("t")
    server = BusServer(bus)
    client = BusClient(server.address)
    sent = {"x": np.arange(6, dtype=np.int32).reshape(2, 3),
            "y": np.ones((2,), np.float32)}
    client.publish("t", sent)
    ev = sub.get(timeout=WAIT_S)
    assert ev is not None
    got, arrival = ev
    np.testing.assert_array_equal(got["x"], sent["x"])
    np.testing.assert_array_equal(got["y"], sent["y"])
    assert arrival <= time.monotonic()
    client.close()
    server.close()
    bus.close()


def test_replay_paced_and_stoppable():
    bus = EventBus()
    sub = bus.subscribe("t")
    n = replay(bus, "t", [_toy_batch(i) for i in range(3)])
    assert n == 3 and len(sub) == 3
    stop = threading.Event()
    stop.set()
    assert replay(bus, "t", [_toy_batch(9)] * 5, rate_hz=1.0, stop=stop) == 0
    bus.close()


# ---------------- Source.events over the port's bus ----------------

def test_events_source_arrivals_flow_to_executor():
    bus = EventBus()
    src = Source.events(bus, "t")
    feed = _batches(6, batch=16)
    pipe = paper_pipeline("II", small_vocab=64, batch_size=16)
    job = EtlJob(pipe, src, backend="cuda", device="cpu")
    job.compiled.fit(iter(feed))

    def produce():
        replay(bus, "t", feed)
        bus.close()
    t = _run_thread(produce)
    n = 0
    with job.batches() as ex:
        for _ in ex:
            n += 1
    t.join(WAIT_S)
    assert n == 6
    assert job.stats().staleness.count == 6
    pct = job.stats().staleness_percentiles()
    assert pct["p95"] >= pct["p50"] >= 0.0


def test_events_source_close_unblocks_reader():
    bus = EventBus()
    src = Source.events(bus, "t", poll_s=10.0)
    out = []
    t = _run_thread(lambda: out.extend(iter(src)))
    time.sleep(0.1)
    src.close()
    t.join(timeout=WAIT_S)
    assert not t.is_alive() and out == []
    bus.close()


# ---------------- incremental vocab refresh ----------------

def _ranks(state, vid):
    table = np.asarray(state.tables[vid])
    return {int(v): int(r) for v, r in enumerate(table) if r >= 0}


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_fit_incremental_rank_stable_and_appends(backend):
    compiled = paper_pipeline("II", small_vocab=256, batch_size=32).compile(
        backend, device="cpu")
    compiled.fit(iter(_batches(4, batch=32, seed=1)))
    prev = compiled.state
    window = _batches(4, batch=32, seed=99)
    win_tables, _ = compiled._fit_tables(iter(window))
    compiled.fit_incremental(iter(window))
    assert compiled.state.version == prev.version + 1
    tables, n_unique = tp.merge_refit(prev, win_tables)
    assert compiled.state.n_unique == n_unique
    for vid, before in ((v, _ranks(prev, v)) for v in prev.tables):
        np.testing.assert_array_equal(compiled.state.tables[vid],
                                      tables[vid])
        after = _ranks(compiled.state, vid)
        assert all(after[val] == r for val, r in before.items())
        new = [r for v, r in after.items() if v not in before]
        assert not new or min(new) >= prev.n_unique[vid]
        assert sorted(after.values()) == list(range(len(after)))


def test_fit_incremental_matches_reference_after_three_increments():
    """The port's cuda backend (plain versions on the CPU) against the
    reference's pallas backend in interpret mode: the same initial fit and
    three increments give bit-equal tables and n_unique each time."""
    ref_t, port_t = tp.build_pair(tp.paper("II", small_vocab=2048))
    ref = ref_t.compile("pallas", interpret=True)
    port = port_t.compile("cuda", device="cpu")
    first = _batches(2, batch=500, seed=1)
    ref.fit(iter(first))
    port.fit(iter(first))
    for k, seed in enumerate((11, 12, 13)):
        window = _batches(2, batch=500, seed=seed)
        ref.fit_incremental(iter(window))
        port.fit_incremental(iter(window))
        assert port.state.version == ref.state.version
        assert port.state.n_unique == ref.state.n_unique, k
        for vid, t in ref.state.tables.items():
            np.testing.assert_array_equal(port.state.tables[vid],
                                          np.asarray(t), err_msg=str(k))
    raw = tp.raw_batch(seed=3)
    tp.assert_outputs_match(ref(raw), port(raw), "after the increments")


def test_fit_incremental_batches_match_fresh_compile():
    pipe = paper_pipeline("II", small_vocab=128, batch_size=16)
    compiled = pipe.compile("cuda", device="cpu")
    compiled.fit(iter(_batches(2, batch=16, seed=1)))
    compiled.fit_incremental(iter(_batches(2, batch=16, seed=5)))
    fresh = pipe.compile("cuda", device="cpu")
    fresh.state = compiled.state
    for raw in _batches(3, batch=16, seed=9):
        a, b = compiled(raw), fresh(raw)
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_apply_versioned_tags_and_matches_call():
    compiled = paper_pipeline("II", small_vocab=64, batch_size=8).compile(
        "cuda", device="cpu")
    compiled.fit(iter(_batches(1, batch=8, seed=1)))
    raw = _batches(1, batch=8, seed=2)[0]
    packed, version = compiled.apply_versioned(raw)
    assert version == compiled.state.version
    for k, v in compiled(raw).items():
        assert torch.equal(packed[k], v), k


def test_device_tables_hold_one_version():
    """A version swap uploads the new tables and releases the old ones:
    memory does not grow with refits."""
    compiled = paper_pipeline("II", small_vocab=64, batch_size=8).compile(
        "cuda", device="cpu")
    compiled.fit(iter(_batches(1, batch=8, seed=1)))
    raw = _batches(1, batch=8, seed=2)[0]
    compiled(raw)
    old = [weakref.ref(t) for t in compiled._device_tables(
        compiled.state)[0].values()]
    assert old and all(r() is not None for r in old)
    v1 = compiled.state
    compiled.fit_incremental(iter(_batches(1, batch=8, seed=3)))
    compiled(raw)
    assert all(r() is None for r in old)
    # a batch handed the older snapshot gets that snapshot's tables
    resolved, _ = compiled._device_tables(v1)
    assert compiled._table_cache[0] == v1.version


# ---------------- freshness shedding ----------------

class _FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


class _Item:
    def __init__(self, arrival):
        self.arrival = arrival


def _fake_executor(queues: dict, lookahead=None):
    class _Ex:
        pass
    ex = _Ex()
    ex.stats = RuntimeStats()
    ex.lookahead = lookahead
    ex.stage_queues = lambda: dict(queues)
    return ex


def _shedder_on(executor, bound, clock):
    return FreshnessShedder(executor, bound, slack=1.0, poll_s=0.01,
                            clock=clock)


def test_shed_drops_globally_oldest_first():
    stop = threading.Event()
    q1, q2 = CreditQueue(10, stop, name="a"), CreditQueue(10, stop, name="b")
    for a in (5.0, 9.0):
        q1.put(_Item(a))
    for a in (1.0, 7.0):
        q2.put(_Item(a))
    ex = _fake_executor({"a": q1, "b": q2})
    sh = _shedder_on(ex, 4.0, _FakeClock(t=12.0))
    assert sh.shed_once() == 3
    arr = list(sh.stats.dropped_arrivals)
    assert arr == sorted(arr) == [1.0, 5.0, 7.0]
    assert ex.stats.dropped_stale == 3
    assert len(q1) == 1 and len(q2) == 0
    assert q1.peek_oldest_key(lambda it: it.arrival) == 9.0
    assert q1.dropped == 1 and q2.dropped == 2


def test_shed_respects_threshold_and_validates():
    q = CreditQueue(10, threading.Event(), name="a")
    q.put(_Item(10.0))
    ex = _fake_executor({"a": q})
    sh = _shedder_on(ex, 5.0, _FakeClock(t=14.0))
    assert sh.shed_once() == 0
    assert sh.shed_once(now=16.0) == 1
    with pytest.raises(ValueError):
        FreshnessShedder(ex, 0.0)


def test_shed_excludes_ready_queue_under_lookahead():
    stop = threading.Event()
    placed = CreditQueue(10, stop, name="p")
    ready = CreditQueue(10, stop, name="r")
    ready.put(_Item(0.0))
    placed.put(_Item(1.0))
    ex = _fake_executor({"placed": placed, "ready": ready},
                        lookahead=object())
    sh = _shedder_on(ex, 1.0, _FakeClock(t=50.0))
    assert sh.shed_once() == 1
    assert len(ready) == 1 and len(placed) == 0


def test_stage_queues_of_the_executor():
    """The shedder walks the real executor's queues; with a lookahead
    stage it never sees the ready queue."""
    src = iter([{"sparse": np.zeros((4, 2), np.int32)}])
    plain = StreamingExecutor(lambda b: b, src)
    assert list(plain.stage_queues()) == ["raw", "packed", "ready"]
    assert plain.queue_depths() == {"raw": 0, "packed": 0, "ready": 0}
    look = StreamingExecutor(lambda b: b, src,
                             lookahead=EmbedCacheConfig(rows=2, window=2))
    assert list(look.stage_queues()) == ["raw", "packed", "placed", "ready"]
    sh = FreshnessShedder(look, 1.0)
    assert look.stage_queues()["ready"] not in sh._queues
    assert look.stage_queues()["placed"] in sh._queues


# ---------------- EmbedCache invalidation ----------------

def test_embed_cache_invalidate_bit_exact_after_vocab_swap():
    rng = np.random.default_rng(0)
    F, V, D, B = 2, 64, 8, 16
    tables = torch.tensor(rng.normal(size=(F, V, D)).astype(np.float32))
    cfg = EmbedCacheConfig(rows=16, window=2, row_bytes=4 * D, refresh=True)
    planner = LookaheadPlanner(cfg, F)
    cache = EmbedCache(cfg, F, D, device="cpu")

    def one_batch(tbl):
        idx = rng.integers(0, V, size=(B, F)).astype(np.int32)
        planner.push(idx)
        _, plan = planner.pop_plan()
        batch = cache.advance(tbl, plan.as_payload())
        orig = torch.tensor(idx, dtype=torch.int64)
        out = cached_embedding_lookup(tbl, batch["emb_cache"],
                                      batch["emb_slot"], batch["emb_cold"],
                                      orig)
        want = tbl[torch.arange(F), orig]
        assert torch.equal(out, want)

    for _ in range(3):
        one_batch(tables)
    gen0 = cache.generation
    tables2 = torch.tensor(rng.normal(size=(F, V, D)).astype(np.float32))
    cache.invalidate()
    assert cache.generation == gen0 + 1
    assert not cache.ext.any()
    for _ in range(3):
        one_batch(tables2)


def test_embed_cache_invalidate_requires_refresh_for_online():
    pipe = paper_pipeline("II", small_vocab=64, batch_size=8)
    job = EtlJob(pipe, Source.synth("I", rows=32, batch_size=8, seed=0),
                 backend="cuda", device="cpu")
    job.compiled.fit(iter(_batches(1, batch=8, seed=1)))
    cache = EmbedCache(EmbedCacheConfig(rows=8, window=2, row_bytes=32), 2,
                       8, device="cpu")
    bus = EventBus()
    with pytest.raises(ValueError, match="refresh=True"):
        OnlineTrainer(job, object(), lambda s, b: (s, {}),
                      OnlineConfig(refit_every=5), bus=bus,
                      embed_cache=cache)
    with pytest.raises(ValueError, match="needs the bus"):
        OnlineTrainer(job, object(), lambda s, b: (s, {}),
                      OnlineConfig(refit_every=5))
    bus.close()


# ---------------- staleness in the Prometheus text ----------------

def test_staleness_histogram_in_prometheus_text():
    from repro.etl_runtime import metrics as ref_metrics
    from repro.etl_runtime.runtime import RuntimeStats as RefStats

    texts = []
    for stats_cls, mod in ((RuntimeStats, metrics_lib),
                           (RefStats, ref_metrics)):
        stats = stats_cls()
        now = 1000.0
        for age in (0.001, 0.03, 0.3, 3.0):
            stats.note_delivered(now - age, now=now)
        stats.ingest_events = 10
        stats.t_start = now - 5.0
        stats.t_last_ingest = now
        texts.append(mod.stats_to_prometheus(stats))
    text = texts[0]
    assert text == texts[1]
    assert 'repro_etl_delivered_staleness_seconds_bucket{le="+Inf"} 4' in text
    assert "repro_etl_delivered_staleness_seconds_count 4" in text
    assert "repro_etl_ingest_events_per_second" in text
    counts = [int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
              if "_staleness_seconds_bucket" in line]
    assert counts == sorted(counts)
    assert metrics_lib.counters_to_prometheus({"b": 2, "a": 1.5}) == \
        ref_metrics.counters_to_prometheus({"b": 2, "a": 1.5})


# ---------------- OnlineTrainer service ----------------

def _online_setup(*, vocab=64, batch=32, warm=8, seed=0, backend="cuda"):
    pipe = paper_pipeline("II", small_vocab=vocab, batch_size=batch)
    bus = EventBus(capacity=256)
    job = EtlJob(pipe, Source.events(bus, "events"), backend=backend,
                 device="cpu")
    job.compiled.fit(iter(_batches(warm, batch=batch, seed=seed)))
    return pipe, bus, job


def test_online_trainer_checkpoint_rollover(tmp_path):
    _, bus, job = _online_setup(batch=16, warm=2)
    cfg = OnlineConfig(checkpoint_every=3, ckpt_dir=str(tmp_path),
                       keep_ckpts=2, get_timeout_s=0.1)
    tr = OnlineTrainer(job, {"w": np.ones((2, 2), np.float32)},
                       lambda s, b: (s, {}), cfg)

    def producer():
        replay(bus, "events", _batches(12, batch=16, seed=3))
        bus.close()
    t = _run_thread(producer)
    tr.run(deadline_s=WAIT_S)
    t.join(WAIT_S)
    assert tr.stats.steps == 12 and tr.stats.checkpoints == 4
    kept = sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("step_"))
    assert kept == ["step_00000009", "step_00000012"]
    assert ck.latest_step(str(tmp_path)) == 12


def test_online_trainer_stop_is_prompt():
    _, bus, job = _online_setup(batch=16, warm=2)
    tr = OnlineTrainer(job, object(), lambda s, b: (s, {}),
                       OnlineConfig(get_timeout_s=0.1))
    done = threading.Event()

    def run():
        tr.run(deadline_s=30.0)
        done.set()
    t = _run_thread(run)
    time.sleep(0.3)     # quiet bus: trainer parked on get_batch
    tr.stop()
    assert done.wait(timeout=WAIT_S)
    t.join(WAIT_S)
    bus.close()


def test_online_trainer_refits_dlrm_every_batch_matches_its_version(
        tmp_path):
    """A tiny DLRM trained over the bus with refits every 2 steps, an
    EmbedCache (refresh, invalidated per refit) and checkpoints: versions
    rise by one per refit, each refit's tables are the rank-stable merge of
    its window's fit into the previous state, every traced batch equals a
    fresh compile at the version that transformed it, losses are finite,
    and the newest checkpoint restores the final state bit for bit."""
    from repro_torch.training.train_loop import resume_or_init
    pipe, bus, job = _online_setup(vocab=256, batch=32, warm=2, seed=1)
    job = EtlJob(pipe, Source.events(bus, "ev"), backend="cuda",
                 device="cpu", embed_cache=EmbedCacheConfig(
                     rows=16, window=2, tables=tuple(range(26)),
                     refresh=True))
    job.compiled.fit(iter(_batches(2, batch=32, seed=1)))
    cfg = dlrm.DLRMConfig(vocab_size=257, d_emb=8, bot_mlp=(16, 8),
                          top_mlp=(16, 1))

    def make_state():
        gen = torch.Generator().manual_seed(0)
        return TrainState.create(dlrm.DLRM(cfg, device="cpu", generator=gen),
                                 TrainConfig(lr=1e-3))

    losses = []
    step = make_train_step(dlrm.loss_fn, TrainConfig(lr=1e-3))
    feed = _batches(8, batch=32, seed=40)
    published = [2]

    def step_fn(state, batch):
        # the producer moves in step with the trainer, one event a step,
        # so the refit windows are the same in every run
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if published[0] < len(feed):
            bus.publish("ev", feed[published[0]])
            published[0] += 1
            if published[0] == len(feed):
                bus.close()
        return state, m

    refits = []
    compiled = job.compiled
    fit_incremental = compiled.fit_incremental

    def recording(batch_iter):
        window, prev = list(batch_iter), compiled.state
        refits.append((prev, compiled._fit_tables(iter(window))[0]))
        return fit_incremental(iter(window))
    compiled.fit_incremental = recording

    ocfg = OnlineConfig(refit_every=2, window_batches=4, get_timeout_s=0.1,
                        checkpoint_every=4, ckpt_dir=str(tmp_path),
                        keep_ckpts=2)
    cache = EmbedCache(job._executor_kw["lookahead"], cfg.n_sparse,
                       cfg.d_emb, device="cpu")
    tr = OnlineTrainer(job, make_state(), step_fn, ocfg, bus=bus, topic="ev",
                       embed_cache=cache, trace_batches=16)

    replay(bus, "ev", feed[:2])
    tr.run(deadline_s=WAIT_S * 3)
    # windows at steps 2, 4, 6: events 0-3, 4-5, 6-7; step 8's is empty
    assert tr.stats.steps == 8 and tr.stats.swaps == 3
    assert tr.stats.refit_skipped == 1 and tr.stats.refit_batches == 8
    v0 = min(tr.state_history)
    assert tr.stats.versions == [v0 + 1, v0 + 2, v0 + 3]
    assert cache.generation == 3
    for (prev, win), version in zip(refits, tr.stats.versions):
        tables, n_unique = tp.merge_refit(prev, win)
        got = tr.state_history[version]
        assert got.version == prev.version + 1 and got.n_unique == n_unique
        for vid in tables:
            np.testing.assert_array_equal(got.tables[vid], tables[vid])
    assert len(tr.trace) == 8
    for version, raw, packed in tr.trace:
        fresh = pipe.compile("cuda", device="cpu")
        fresh.state = tr.state_history[version]
        for k, v in fresh(raw).items():
            np.testing.assert_array_equal(packed[k], v.numpy(), err_msg=k)
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert ck.latest_step(str(tmp_path)) == 8
    restored = resume_or_init(make_state, str(tmp_path))
    for a, b in zip(dlrm.state_to_jax_leaves(tr.state),
                    dlrm.state_to_jax_leaves(restored)):
        assert torch.equal(a, b)


def test_online_launcher_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.online import main
    tr = main(["--device", "cpu", "--etl-backend", "torch", "--duration",
               "20", "--steps", "6", "--batch", "64", "--vocab", "512",
               "--d-emb", "8", "--refit-every", "3", "--refit-window", "4",
               "--checkpoint-every", "3", "--ckpt-dir", str(tmp_path),
               "--keep-ckpts", "1", "--log-every", "0",
               "--shed-max-staleness", "5"])
    assert tr.stats.steps == 6
    assert tr.stats.swaps >= 1 and tr.stats.swaps + tr.stats.refit_skipped == 2
    assert ck.latest_step(str(tmp_path)) == 6
    out = capsys.readouterr().out
    assert "[online] 6 steps" in out and f"swaps={tr.stats.swaps}" in out
