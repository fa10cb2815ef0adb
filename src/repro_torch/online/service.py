"""OnlineTrainer: the continuous-training control loop.

One thread interleaves four duties over an endless event-bus feed:

  train        pull the next delivered batch, run the step
  refit/swap   every ``refit_every`` steps, fit ONLY the window of events
               that arrived since the last refit (``fit_incremental`` —
               rank-stable, so live embedding rows keep meaning) and swap
               the ``PipelineState`` atomically with a version bump; the
               compiled pipeline's per-version resolved/staged table caches
               refresh themselves and the lookahead ``EmbedCache`` is
               invalidated (+ re-admitted via ``refresh``) on the spot
  eval         every ``eval_every`` steps, call the user's ``eval_fn``
  checkpoint   every ``checkpoint_every`` steps, async-save + prune to
               ``keep_ckpts`` committed checkpoints (rollover)

Version correctness: the transform stage runs in the executor's thread
concurrently with swaps, so the compiled program snapshots its state once
per batch (``apply_versioned``) and every delivered batch is tagged with
the version that transformed it — post-swap batches are bit-identical to a
from-scratch compile at the same state version.  On a CUDA pipeline the
transform stage runs on its own stream (``etl_runtime/transfer.py``); the
refit's fit kernels run on the trainer's.

Freshness: an optional ``FreshnessShedder`` (``shed_max_staleness_s``)
drops the globally-oldest in-flight event when ingest outruns training;
staleness percentiles ride ``RuntimeStats.staleness_percentiles`` and the
Prometheus histogram.
"""

from __future__ import annotations

import collections
import queue as queue_lib
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.etl_runtime import metrics as metrics_lib
from repro_torch.online.shed import FreshnessShedder, ShedStats
from repro_torch.training import checkpoint as ckpt_lib


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class _VersionedApply:
    """Transform-stage wrapper: stamp each packed batch with the vocabulary
    state version that transformed it (``apply_versioned`` snapshots the
    state exactly once per batch).  It carries the compiled program's
    ``device``, so the executor runs it as it would run the program (on a
    stream of its own for CUDA).  With ``trace`` set,
    keeps bounded ``(version, raw, packed)`` triples on the host for the
    bit-equality acceptance check — test/debug only: the copy to the host
    waits for the batch's kernels."""

    KEY = "_pipe_version"

    def __init__(self, compiled, trace=None):
        self.compiled = compiled
        self.trace = trace
        self.device = getattr(compiled, "device", None)

    def __call__(self, raw: dict) -> dict:
        out, version = self.compiled.apply_versioned(raw)
        out = dict(out)
        out[self.KEY] = version
        if self.trace is not None:
            self.trace.append(
                (version, {k: np.asarray(v) for k, v in raw.items()},
                 {k: _host(v) for k, v in out.items() if k != self.KEY}))
        return out


@dataclass
class OnlineConfig:
    """Knobs of the online control loop (CLI: ``launch/online.py``)."""

    refit_every: int = 0          # steps between incremental refits (0=off)
    refit_min_batches: int = 1    # skip a refit tick with a smaller window
    window_batches: int = 64      # refit window bound (newest kept)
    shed_max_staleness_s: float = 0.0   # global shed bound (0 = off)
    shed_poll_s: float = 0.02
    shed_slack: float = 0.7
    checkpoint_every: int = 0     # steps between checkpoints (0 = off)
    ckpt_dir: str = ""
    keep_ckpts: int = 3
    eval_every: int = 0           # steps between eval_fn calls (0 = off)
    log_every: int = 0            # steps between progress lines (0 = quiet)
    get_timeout_s: float = 0.25   # deliver poll (deadline/stop granularity)


@dataclass
class OnlineStats:
    steps: int = 0
    swaps: int = 0                # incremental vocab refits applied
    refit_batches: int = 0        # window events consumed by refits
    refit_skipped: int = 0        # ticks skipped (window under the minimum)
    checkpoints: int = 0
    evals: int = 0
    last_eval: Optional[dict] = None
    versions: list = field(default_factory=list)  # version after each swap

    def as_dict(self) -> dict:
        return {"steps": self.steps, "swaps": self.swaps,
                "refit_batches": self.refit_batches,
                "checkpoints": self.checkpoints, "evals": self.evals,
                "versions": list(self.versions)}


class OnlineTrainer:
    """Continuous online training over an event bus; see module docstring.

    Parameters
    ----------
    job : ``EtlJob`` whose source is (typically) ``Source.events(bus,
        topic)``.  The trainer builds and owns the job's executor.
    state : initial train state (``training.train_loop.TrainState`` for
        real models; anything ``step_fn`` takes otherwise).
    step_fn : ``step_fn(state, batch) -> (state, metrics)`` — e.g. the
        ``make_train_step`` product.  A ``metrics["loss"]`` is read to the
        host after each step, which waits for the step's kernels.
    cfg : ``OnlineConfig``.
    bus, topic : when refits are enabled, the trainer taps its own bounded
        subscription of the same topic for the refit window (every
        subscriber sees every event), so refit ingest never steals batches
        from training.
    embed_cache, embed_tables : a lookahead ``EmbedCache`` advanced before
        every step (as in ``train_loop``) plus the current-tables accessor
        ``embed_tables(state)`` (default ``state.model.tables``).  With refits enabled the
        cache config must set ``refresh=True`` (swap invalidation is only
        bit-exact when referenced residents are re-admitted every batch).
    eval_fn : optional ``eval_fn(state) -> dict`` for the eval duty.
    trace_batches : keep the last N ``(version, raw, packed)`` triples on
        the host (acceptance/debug; waits for each batch's kernels).
    """

    def __init__(self, job, state, step_fn: Callable, cfg: OnlineConfig, *,
                 bus=None, topic: str = "events",
                 embed_cache=None, embed_tables: Optional[Callable] = None,
                 eval_fn: Optional[Callable] = None,
                 trace_batches: int = 0):
        self.job = job
        self.state = state
        self.step_fn = step_fn
        self.cfg = cfg
        self.eval_fn = eval_fn
        self.embed_cache = embed_cache
        if embed_cache is not None and embed_tables is None:
            embed_tables = lambda st: st.model.tables
        self.embed_tables = embed_tables
        self.stats = OnlineStats()
        self.executor = None
        self.shedder: Optional[FreshnessShedder] = None
        self.state_history: dict = {}   # version -> PipelineState snapshot
        self._stop = False
        self._ckpt = ckpt_lib.AsyncCheckpointer()
        self._refit_sub = None
        self._window: collections.deque = collections.deque(
            maxlen=max(1, cfg.window_batches))
        self.trace = (collections.deque(maxlen=trace_batches)
                      if trace_batches else None)
        if cfg.refit_every > 0:
            compiled = job.compiled
            if not hasattr(compiled, "fit_incremental"):
                raise TypeError("incremental refit needs a CompiledPipeline")
            if bus is None:
                raise ValueError("refit_every > 0 needs the bus (the "
                                 "trainer taps its own refit subscription)")
            if embed_cache is not None and not embed_cache.cfg.refresh:
                raise ValueError(
                    "online refits with an EmbedCache require "
                    "EmbedCacheConfig(refresh=True): swap invalidation is "
                    "only bit-exact when referenced residents are "
                    "re-admitted every batch")
            self._refit_sub = bus.subscribe(topic)

    # ---- duties ----------------------------------------------------------

    def _drain_window(self) -> list:
        """Events arrived since the last refit, newest ``window_batches``
        kept (the bounded subscription + bounded deque cap both ends)."""
        while True:
            ev = self._refit_sub.get_nowait()
            if ev is None:
                break
            self._window.append(ev[0])
        window = list(self._window)
        self._window.clear()
        return window

    def _refit(self) -> bool:
        window = self._drain_window()
        if len(window) < max(1, self.cfg.refit_min_batches):
            self.stats.refit_skipped += 1
            return False
        compiled = self.job.compiled
        new_state = compiled.fit_incremental(iter(window))
        # the swap happened inside fit_incremental (single attribute store);
        # drop stale cached rows NOW so no post-swap batch trains on them
        if self.embed_cache is not None:
            self.embed_cache.invalidate()
        self.stats.swaps += 1
        self.stats.refit_batches += len(window)
        self.stats.versions.append(new_state.version)
        self.state_history[new_state.version] = new_state
        return True

    def _checkpoint(self) -> None:
        cfg = self.cfg
        self._ckpt.save_async(self.state, cfg.ckpt_dir, self.stats.steps)
        ckpt_lib.prune(cfg.ckpt_dir, keep=cfg.keep_ckpts)
        self.stats.checkpoints += 1

    # ---- main loop -------------------------------------------------------

    def run(self, *, max_steps: Optional[int] = None,
            deadline_s: Optional[float] = None):
        """Consume delivered batches until ``max_steps`` steps, the
        ``deadline_s`` wall-clock budget, ``stop()``, or the bus closing —
        whichever first.  Returns the final train state."""
        cfg = self.cfg
        compiled = self.job.compiled
        if hasattr(compiled, "state"):
            self.state_history.setdefault(compiled.state.version,
                                          compiled.state)
        transform = (_VersionedApply(compiled, trace=self.trace)
                     if hasattr(compiled, "apply_versioned") else compiled)
        ex = self.executor = self.job.executor(transform=transform)
        if cfg.shed_max_staleness_s > 0:
            self.shedder = FreshnessShedder(
                ex, cfg.shed_max_staleness_s,
                slack=cfg.shed_slack, poll_s=cfg.shed_poll_s)
            self.shedder.start()
        ex.start()
        t_end = (time.monotonic() + deadline_s) if deadline_s else None
        try:
            while not self._stop:
                if max_steps is not None and self.stats.steps >= max_steps:
                    break
                if t_end is not None and time.monotonic() >= t_end:
                    break
                try:
                    payload = ex.get_batch(timeout=cfg.get_timeout_s)
                except queue_lib.Empty:
                    continue        # quiet feed: re-check deadline/stop
                except StopIteration:
                    break           # bus closed (EOS) or executor stopped
                batch = dict(payload)
                batch.pop(_VersionedApply.KEY, None)
                if self.embed_cache is not None:
                    batch = self.embed_cache.advance(
                        self.embed_tables(self.state), batch)
                self.state, metrics = self.step_fn(self.state, batch)
                if isinstance(metrics, dict) and "loss" in metrics:
                    float(metrics["loss"])  # waits for the step to finish
                self.stats.steps += 1
                s = self.stats.steps
                if cfg.refit_every and s % cfg.refit_every == 0:
                    self._refit()
                if (cfg.checkpoint_every and cfg.ckpt_dir
                        and s % cfg.checkpoint_every == 0):
                    self._checkpoint()
                if cfg.eval_every and self.eval_fn is not None \
                        and s % cfg.eval_every == 0:
                    self.stats.last_eval = self.eval_fn(self.state)
                    self.stats.evals += 1
                if cfg.log_every and s % cfg.log_every == 0:
                    pct = ex.stats.staleness_percentiles()
                    print(f"[online] step {s} swaps {self.stats.swaps} "
                          f"staleness p95 {pct['p95'] * 1e3:.1f}ms "
                          f"shed {self.shed_stats().dropped}")
        finally:
            if self.shedder is not None:
                self.shedder.stop()
            ex.stop()
            ex.join(timeout=5.0)
            self._ckpt.wait()
            if self.stats.checkpoints and cfg.ckpt_dir:
                # the last async save commits after the prune that followed
                # it; one final prune restores the exact keep-window size
                ckpt_lib.prune(cfg.ckpt_dir, keep=cfg.keep_ckpts)
            if getattr(self.job, "metrics_file", ""):
                metrics_lib.write_metrics_file(
                    self.job.metrics_file,
                    metrics_lib.stats_to_prometheus(
                        ex.stats, labels=self.job.metrics_labels))
        return self.state

    def stop(self) -> None:
        self._stop = True
        if self.executor is not None:
            self.executor.stop()

    # ---- observability ---------------------------------------------------

    def shed_stats(self):
        return self.shedder.stats if self.shedder else ShedStats()

    def staleness_percentiles(self) -> dict:
        return (self.executor.stats.staleness_percentiles()
                if self.executor else {"p50": 0.0, "p95": 0.0, "p99": 0.0})
