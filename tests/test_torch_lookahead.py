"""The lookahead training path of ``repro_torch`` against the JAX package.

- ``LookaheadPlanner``: the same batches give the same plans (every
  ``PrefetchPlan`` array) and the same ``CacheStats``, refresh on and off.
- The executor's lookahead stage: annotates, drains at EOS, handles a column
  subset, reads CUDA-or-CPU tensor payloads, and fills ``stats.cache``; the
  Prometheus text equals the reference's for the same stats.
- ``EmbedCache``: ``ext`` bit-equal to the JAX package's after every plan.
- ``cached_embedding_lookup``: forward equal to JAX's, gradient within
  rtol 1e-5 of JAX's and bit-equal to the port's own uncached gather's.
- DLRM: the cached forward equals the plain forward bit for bit, and the
  JAX cached forward at ``tests/test_torch_dlrm.py``'s tolerance.
- End to end: ``EtlJob(embed_cache=...)`` -> ``train_loop(embed_cache=...)``
  gives the uncached run's losses (rtol 1e-6), as the reference's
  ``tests/test_dlrm_e2e.py`` requires of itself.

Everything runs on the CPU (the kernels' plain versions); the CUDA kernels
meet the same plain versions on the card.  The gradient comparisons run
with ``torch.use_deterministic_algorithms(True)``: on the CPU,
``index_put_(accumulate=True)`` otherwise adds with unordered atomics above
a grain size, where CUDA's sort-based kernel is deterministic anyway."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.etl_runtime import lookahead as rla  # noqa: E402
from repro.etl_runtime import metrics as rmetrics  # noqa: E402
from repro.etl_runtime import runtime as rrt  # noqa: E402
from repro.models import dlrm as rdlrm  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.pipeline import paper_pipeline  # noqa: E402
from repro_torch.data.source import Source  # noqa: E402
from repro_torch.etl_runtime import lookahead as la  # noqa: E402
from repro_torch.etl_runtime import metrics as pmetrics  # noqa: E402
from repro_torch.etl_runtime import runtime as prt  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.models import dlrm  # noqa: E402
from repro_torch.session import EtlJob  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402

V, T, B, D, ROWS = 300, 3, 48, 8, 40
CFG = dict(rows=ROWS, window=4, row_bytes=4 * D)


def _skewed_batches(n, seed=0):
    """tests/test_lookahead.py's stream: Zipf(1.3) rows, 5 % padding."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = (rng.zipf(1.3, size=(B, T)).clip(max=V) - 1).astype(np.int64)
        b[rng.random(b.shape) < 0.05] = -1
        out.append(b)
    return out


def _drain_plans(planner, batches):
    plans = []
    for b in batches:
        planner.push(b)
        if planner.window_depth() >= planner.cfg.window:
            plans.append(planner.pop_plan())
    while planner.window_depth():
        plans.append(planner.pop_plan())
    return plans


def _cfgs(**kw):
    kw = {**CFG, **kw}
    return rla.EmbedCacheConfig(**kw), la.EmbedCacheConfig(**kw)


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _tables(seed=5):
    return np.random.default_rng(seed).standard_normal((T, V, D)).astype(
        np.float32)


@pytest.mark.parametrize("stage_max", [0, 8])
@pytest.mark.parametrize("refresh", [False, True])
def test_planner_plans_and_stats_equal(refresh, stage_max):
    rcfg, pcfg = _cfgs(refresh=refresh, stage_max=stage_max)
    rp, pp = rla.LookaheadPlanner(rcfg, T), la.LookaheadPlanner(pcfg, T)
    batches = _skewed_batches(10, seed=3)
    want, got = _drain_plans(rp, batches), _drain_plans(pp, batches)
    assert len(want) == len(got) == len(batches)
    for (ri, rplan), (pi, pplan) in zip(want, got):
        np.testing.assert_array_equal(ri, pi)
        for k, a in rplan.as_payload().items():
            np.testing.assert_array_equal(a, pplan.as_payload()[k], err_msg=k)
    assert dataclasses.asdict(rp.stats) == dataclasses.asdict(pp.stats)
    assert rp.stats.as_dict() == pp.stats.as_dict()
    assert pp.stats.hits > 0 and pp.stats.admitted > 0
    if stage_max:
        assert pp.stats.staged > 0 and pp.stats.overflow_cold > 0


def _run_executor(mod, cfg, batches, wrap=lambda b: b):
    ex = mod.StreamingExecutor(lambda x: x,
                               ({"sparse": wrap(b.astype(np.int32)),
                                 "tag": len(b)} for b in batches),
                               lookahead=cfg)
    return list(ex), ex


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_executor_stage_annotates_like_the_reference(payload):
    rcfg, pcfg = _cfgs()
    batches = _skewed_batches(9, seed=7)
    want, rex = _run_executor(rrt, rcfg, batches)
    wrap = torch.tensor if payload == "torch" else (lambda b: b)
    got, ex = _run_executor(prt, pcfg, batches, wrap)
    assert len(got) == len(want) == len(batches)  # EOS drained the window
    for w, g in zip(want, got):
        assert g["tag"] == B  # original keys ride along
        for k in la.PLAN_KEYS:
            assert isinstance(g[k], np.ndarray)  # plans stay on the host
            np.testing.assert_array_equal(w[k], g[k], err_msg=k)
    st = ex.stats
    assert list(st.stages) == ["read", "transform", "place", "lookahead",
                               "deliver"]
    assert st.stages["lookahead"].items == len(batches)
    assert st.produced == st.consumed == len(batches)
    assert isinstance(st.cache, la.CacheStats)
    assert st.cache.as_dict() == rex.stats.cache.as_dict()
    assert st.cache.lookups > 0


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_executor_column_subset(payload):
    _, pcfg = _cfgs(rows=16, window=2, tables=(0, 2))
    batches = _skewed_batches(4, seed=9)
    rp = la.LookaheadPlanner(pcfg, 2)
    plans = _drain_plans(rp, [b[:, [0, 2]] for b in batches])
    wrap = torch.tensor if payload == "torch" else (lambda b: b)
    got, ex = _run_executor(prt, pcfg, batches, wrap)
    assert len(got) == len(plans) == len(batches)
    for g, (_, plan) in zip(got, plans):
        assert g["emb_slot"].shape == (B, 2)
        np.testing.assert_array_equal(g["emb_slot"], plan.slot)
        np.testing.assert_array_equal(g["emb_cold"], plan.cold)
    assert ex.stats.stages["lookahead"].items == len(batches)


def test_prometheus_text_with_cache_identical():
    def fill(mod, stats_cls, stage_cls):
        stats = mod.RuntimeStats()
        stats.stages["place"] = stage_cls("place", items=5, drop_oldest=3)
        stats.stages["lookahead"] = stage_cls("lookahead", items=4,
                                              busy_s=0.75)
        stats.cache = stats_cls(lookups=10, hits=8, misses=2, admitted=4,
                                evicted=1, staged=3, overflow_cold=1,
                                row_bytes=64)
        return stats

    want = rmetrics.stats_to_prometheus(
        fill(rrt, rla.CacheStats, rrt.StageStats), labels={"job": "x"})
    got = pmetrics.stats_to_prometheus(
        fill(prt, la.CacheStats, prt.StageStats), labels={"job": "x"})
    assert got == want
    assert "repro_etl_embed_cache_hit_rate" in got


def _planned(refresh=False, stage_max=8, n=8, seed=13):
    rcfg, pcfg = _cfgs(refresh=refresh, stage_max=stage_max)
    return rcfg, pcfg, _drain_plans(la.LookaheadPlanner(pcfg, T),
                                    _skewed_batches(n, seed=seed))


def test_embed_cache_ext_bit_equal_to_jax():
    rcfg, pcfg, plans = _planned(refresh=True)
    tables = _tables()
    rcache = rla.EmbedCache(rcfg, T, D)
    pcache = la.EmbedCache(pcfg, T, D, device="cpu")
    for _, plan in plans:
        want = rcache.advance(jnp.asarray(tables), plan.as_payload())
        got = pcache.advance(torch.tensor(tables), plan.as_payload())
        np.testing.assert_array_equal(np.asarray(want["emb_cache"]),
                                      got["emb_cache"].numpy())
        for k in ("emb_slot", "emb_cold"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy())
    pcache.invalidate()
    assert pcache.generation == 1 and not pcache.ext.any()


def test_embed_cache_advance_passthrough_without_plan():
    _, pcfg = _cfgs()
    cache = la.EmbedCache(pcfg, T, D, device="cpu")
    batch = {"sparse": np.zeros((B, T), np.int32)}
    assert cache.advance(torch.zeros(T, V, D), batch) is batch


def _uncached(tables, orig):
    feat = torch.arange(T)
    valid = orig >= 0
    rows = tables[feat, torch.where(valid, orig, 0).long()]
    return torch.where(valid[..., None], rows, 0)


def test_cached_lookup_forward_and_gradient(deterministic):
    rcfg, pcfg, plans = _planned(refresh=True, n=3)
    tables = _tables(seed=17)
    rcache = rla.EmbedCache(rcfg, T, D)
    pcache = la.EmbedCache(pcfg, T, D, device="cpu")
    g = np.random.default_rng(2).standard_normal((B, T, D)).astype(np.float32)
    for idx, plan in plans:
        orig = idx.astype(np.int32)
        rb = rcache.advance(jnp.asarray(tables), plan.as_payload())
        pb = pcache.advance(torch.tensor(tables), plan.as_payload())

        def rloss(tb):
            out = rla.cached_embedding_lookup(tb, rb["emb_cache"],
                                              rb["emb_slot"], rb["emb_cold"],
                                              jnp.asarray(orig))
            return (out * g).sum(), out

        (_, want), rgrad = jax.value_and_grad(rloss, has_aux=True)(
            jnp.asarray(tables))
        t = torch.tensor(tables, requires_grad=True)
        got = la.cached_embedding_lookup(t, pb["emb_cache"], pb["emb_slot"],
                                         pb["emb_cold"], torch.tensor(orig))
        np.testing.assert_array_equal(np.asarray(want), got.detach().numpy())
        (grad,) = torch.autograd.grad(got, t, torch.tensor(g))
        tp.assert_match(rgrad, grad, "cached lookup gradient")
        t2 = torch.tensor(tables, requires_grad=True)
        (plain,) = torch.autograd.grad(_uncached(t2, torch.tensor(orig)), t2,
                                       torch.tensor(g))
        assert torch.equal(grad, plain)


# ---------------------------------------------------------------------------
# DLRM and the end-to-end lookahead training path
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=2049, d_emb=16, bot_mlp=(64, 32, 16),
             top_mlp=(64, 32, 1))
N_SPARSE = 26


def _cache_kw(**kw):
    return {"rows": 96, "window": 3, "tables": tuple(range(N_SPARSE)), **kw}


def test_dlrm_cached_forward_matches_plain_and_jax():
    rcfg = rdlrm.DLRMConfig(**SMALL)
    params = rdlrm.init(jax.random.key(1), rcfg)
    model = dlrm.DLRM(dlrm.DLRMConfig(**SMALL), device="cpu")
    model.load_state_dict(dlrm.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(4)
    batch = {"dense": rng.normal(size=(128, 16)).astype(np.float32),
             "sparse": (rng.zipf(1.2, size=(128, 32)) % 2049).astype(np.int32),
             "label": (rng.random(128) < 0.3).astype(np.float32)}
    kw = _cache_kw(stage_max=16)
    planner = la.LookaheadPlanner(la.EmbedCacheConfig(**kw), N_SPARSE)
    planner.push(batch["sparse"][:, :N_SPARSE])
    _, plan = planner.pop_plan()
    assert (plan.slot < 0).any() and (plan.slot >= 96).any()  # three branches
    rb = rla.EmbedCache(rla.EmbedCacheConfig(**kw), N_SPARSE, 16).advance(
        params["tables"], {**{k: jnp.asarray(v) for k, v in batch.items()},
                           **plan.as_payload()})
    tb = la.EmbedCache(la.EmbedCacheConfig(**kw), N_SPARSE, 16,
                       device="cpu").advance(
        model.tables, {**{k: torch.tensor(v) for k, v in batch.items()},
                       **plan.as_payload()})
    assert "emb_cache" in tb
    with torch.no_grad():
        got = model(tb)
        plain = model({k: torch.tensor(v) for k, v in batch.items()})
    assert torch.equal(got, plain)
    want = np.asarray(rdlrm.forward(params, rb, rcfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_etl_cached_training_matches_uncached(deterministic):
    """EtlJob(embed_cache=...) -> train_loop(embed_cache=...) on the CPU at
    the reference e2e test's sizes: the cached run's losses equal the
    uncached run's (rtol 1e-6) and the cache hits."""
    tmpl = paper_pipeline("II", small_vocab=2048, batch_size=256)
    fit = Source.synth("I", rows=3000, batch_size=1000, seed=1)
    steps, tcfg = 6, TrainConfig(lr=3e-3)

    def run(cache_cfg):
        job = EtlJob(tmpl, Source.synth("I", rows=steps * 256, batch_size=256,
                                        seed=2),
                     backend="cuda", device="cpu", fit_source=fit,
                     embed_cache=cache_cfg)
        job.fit()
        torch.manual_seed(0)
        model = dlrm.DLRM(dlrm.DLRMConfig(**SMALL), device="cpu")
        state = ttl.TrainState.create(model, tcfg)
        cache = (la.EmbedCache(cache_cfg, N_SPARSE, 16, device="cpu")
                 if cache_cfg else None)
        metrics = []
        with job.batches() as ex:
            ttl.train_loop(state, ttl.make_train_step(dlrm.loss_fn, tcfg), ex,
                           ttl.LoopConfig(total_steps=steps, log_every=1),
                           device="cpu", on_metrics=metrics.append,
                           embed_cache=cache)
        return [m["loss"] for m in metrics], metrics, job.stats()

    plain, _, _ = run(None)
    before = dict(backend.LAUNCHES)
    cached, metrics, stats = run(la.EmbedCacheConfig(
        **_cache_kw(refresh=True, min_admit_freq=1)))
    assert backend.LAUNCHES == before  # the CPU run launches no kernel
    assert len(cached) == steps
    np.testing.assert_allclose(cached, plain, rtol=1e-6)
    assert stats.cache.hits > 0 and stats.cache.hit_rate() > 0.2
    assert metrics[-1]["emb_cache_hit_rate"] == stats.cache.hit_rate()
    assert stats.stages["lookahead"].items == steps
