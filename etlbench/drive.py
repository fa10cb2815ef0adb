"""The general driver of one run: data from the seed, the program's ETL
job fitted, the cell's traffic mode (``modes/<mode>.py``) through set-up
and its measured window, then the check against the plain reference.

The program under test is ``repro_torch``; it is imported here, inside
the functions, never by the reference.
"""

from __future__ import annotations

import gc
import importlib.util
import itertools
import math
import os
import random
import time

import numpy as np
import torch

from etlbench import devtrace, gen, reference, work

HERE = os.path.dirname(os.path.abspath(__file__))


def load_file_module(path: str, name: str):
    """Import the Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def percentile(values: list, q: float) -> float:
    """The nearest-rank ``q``-quantile of ``values``."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


class Feed:
    """The executor's delivered batches, counted: each carries the index
    of the pool batch it was made from (the source replays the pool in
    order)."""

    def __init__(self, executor):
        self._it = iter(executor)
        self.delivered = 0

    def _next(self):
        batch = next(self._it)
        self.index = self.delivered
        self.delivered += 1
        return batch

    def take(self, n: int):
        for _ in range(n):
            yield self._next()

    def until(self, deadline: float):
        while time.perf_counter() < deadline:
            yield self._next()


class Sample:
    """A reservoir of ``k`` delivered batches (by delivery index), drawn
    from the seed: the batches of a window that the check compares."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(int(seed))
        self.seen = 0
        self.kept: list = []

    def offer(self, index: int, batch: dict) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((index, batch))
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.kept[j] = (index, batch)


class Run:
    """What set-up builds and the mode fills in: the config, the traffic,
    the seed, the raw data, the program's fitted job and the readings."""

    def __init__(self, cell: str, cfg: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device, t0: float):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = torch.device(device)
        self.t0 = t0
        self.shape = work.model_shape(cfg)
        self.rows = int(cfg["assumed"]["batch_rows"])
        self.checked: list = []     # (delivery index, host batch) to compare
        self.cards = work.cardinalities(cfg)
        self.fresh: list = []       # an event stream's fresh rows, by event
        self.e2e: dict = {}
        self.readings: dict = {}    # what the per-layer metrics read
        self.attempted = self.failed = 0
        self.summary = None         # the profiler's, in a traced run
        self.program: dict = {}     # the program's numbers to compare
        self.phases: list = []      # (set-up phase, seconds)
        self._mark = t0

    def phase(self, name: str) -> None:
        """Close a set-up phase (host clock, for the log)."""
        now = time.perf_counter()
        self.phases.append((name, now - self._mark))
        self._mark = now

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def raw(self, k: int) -> dict:
        """The raw batch of delivery (or event) ``k``: the pool replayed in
        order, with the event's fresh rows where the mix has them."""
        return gen.event(self.pool, self.fresh, k) if self.fresh \
            else self.pool[k % len(self.pool)]

    def keep(self, index: int, batch: dict) -> None:
        """Hold a delivered batch on the host for the check."""
        self.checked.append((index, {k: v.detach().cpu().numpy()
                                     for k, v in batch.items()}))

    def setup_done(self) -> None:
        self.sync()
        self.phase("warm-up")
        self.e2e["setup_s"] = time.perf_counter() - self.t0


def prepare(run: Run, source=None) -> None:
    """Raw data from the seed, the program's library, its ETL job fitted.
    The job reads ``source`` (default: the pool replayed in order, without
    end)."""
    from repro_torch.core.pipeline import paper_pipeline
    from repro_torch.data.source import Source
    from repro_torch.session import EtlJob

    run.phase("start")
    if run.device.type == "cuda":
        from repro_torch.kernels import backend
        backend.build_library()
        backend.load_library()
    run.phase("library")
    tr, etl = run.traffic, run.cfg["assumed"]
    run.fit_raw = gen.batches(run.seed, 0, int(tr["fit_chunks"]), run.rows,
                              tr, run.cards)
    run.pool = gen.batches(run.seed, 1, int(tr["pool_batches"]), run.rows,
                           tr, run.cards)
    pool = run.pool
    run.phase("data")
    tmpl = paper_pipeline(etl["pipeline"],
                          large_vocab=int(etl["vocab_capacity"]),
                          batch_size=run.rows)
    if source is None:
        source = Source.stream(lambda: itertools.cycle(pool))
    run.job = EtlJob(tmpl, source,
                     backend="cuda", device=run.device,
                     fit_source=Source.stream(list(run.fit_raw)))
    run.job.fit()
    (table,) = run.job.state.tables.values()
    run.program["table"] = np.asarray(table).copy()
    run.phase("fit")
    if run.trace:
        devtrace.warm(run.device)
        run.phase("profiler")


def build_trainer(run: Run) -> tuple:
    """The program's DLRM with the benchmark's weights from the seed, its
    AdamW state and its train step: ``(model, params, state, step)``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import dlrm
    from repro_torch.training import train_loop as tl

    s, a = run.shape, run.cfg["assumed"]
    model = dlrm.DLRM(dlrm.DLRMConfig(
        name=run.cfg["name"], n_dense=s["n_dense"], n_sparse=s["n_sparse"],
        vocab_size=s["rows_per_table"], d_emb=s["d_emb"],
        bot_mlp=tuple(s["bot_mlp"]), top_mlp=tuple(s["top_mlp"]),
        dense_padded=s["dense_padded"]), device=run.device)
    made = {n: (i, shape, fan) for i, (n, shape, fan)
            in enumerate(reference.leaf_shapes(s))}
    params = dict(model.named_parameters())
    if sorted(params) != sorted(made):
        raise RuntimeError(f"DLRM parameters {sorted(params)}")
    for name, p in params.items():
        i, shape, fan = made[name]
        if tuple(p.shape) != shape:
            raise RuntimeError(f"{name}: {tuple(p.shape)} != {shape}")
        reference.init_leaf(p.data, run.seed, i, fan)
    run.phase("model")
    tcfg = TrainConfig(optimizer=a["optimizer"], lr=a["lr"],
                       weight_decay=a["weight_decay"], beta1=a["beta1"],
                       beta2=a["beta2"], eps=a["eps"],
                       max_grad_norm=a["max_grad_norm"])
    state = tl.TrainState.create(model, tcfg)
    return model, params, state, tl.make_train_step(dlrm.loss_fn, tcfg)


def first_steps(run: Run, params: dict, opt_state, one_step,
                losses: list) -> None:
    """Drive ``setup_steps`` steps (``one_step()`` runs one through the
    window's own call and feed) and read what the check compares: each
    step's loss (appended to ``losses`` by the step), the first step's
    gradient from AdamW's first moment, each leaf's change after the
    last."""
    b1 = run.cfg["assumed"]["beta1"]
    grads = None
    for k in range(int(run.traffic["setup_steps"])):
        one_step()
        if k == 0:
            grads = {n: float(torch.linalg.vector_norm(m)) / (1 - b1)
                     for n, m in zip(params, opt_state()["m"])}
    run.program.update(losses=[float(x) for x in losses], grad_norms=grads,
                       change_norms=reference.change_norms(
                           params, run.shape, run.seed))
    losses.clear()


def release(run: Run) -> None:
    """Free the program's state before the reference runs."""
    run.job = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

def leaf_gaps(prog: dict, ref: dict, names) -> list:
    """Each leaf's ``|prog - ref|`` over the larger of the reference's norm
    of that leaf and its median leaf's."""
    names = list(names)
    med = float(np.median([ref[n] for n in names])) if names else 0.0
    return [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names]


def batch_checks(run: Run, tables: list) -> dict:
    """The delivered batches held for the check against the reference's:
    sparse ids and labels exactly (against whichever of the reference's
    vocabulary versions ``tables`` matches best, where refits ran), the
    dense columns by their largest gap relative to max(1, |reference|)."""
    etl, s = run.cfg["assumed"], run.shape
    sp = int(etl["sparse_padded"])
    distinct = list({t.tobytes(): t for t in tables}.values())
    mismatch, dense_gap = 0, 0.0
    for i, got in run.checked:
        raw = run.raw(i)
        want = reference.etl_apply(
            raw, tables[0], n_dense=s["n_dense"], n_sparse=s["n_sparse"],
            dense_padded=s["dense_padded"], sparse_padded=sp)
        mismatch += int(got["label"].size) \
            if got["label"].shape != want["label"].shape \
            else int(np.sum(got["label"] != want["label"]))
        ids = reference.sparse_ids(raw, s["n_sparse"], len(tables[0]))
        mismatch += min(
            int(got["sparse"].size) if got["sparse"].shape != (len(ids), sp)
            else int(np.sum(got["sparse"] != reference.vocab_map(ids, t, sp)))
            for t in distinct)
        g, w = got["dense"], want["dense"]
        if g.shape != w.shape:
            dense_gap = math.inf
            continue
        gap = np.abs(g.astype(np.float64) - w) / np.maximum(1.0, np.abs(w))
        dense_gap = max(dense_gap, float(np.nan_to_num(gap, nan=np.inf)
                                         .max()))
    return {"batch_mismatch": mismatch, "dense_gap": dense_gap}


def refit_checks(run: Run, tables: list) -> int:
    """The program's refits against the reference's chain, appended to
    ``tables``; returns the entries that differ.  A refit after step ``s``
    reads the events published since the one before it, the newest
    ``window_batches`` kept.  The mode records, at each step after which a
    refit runs, how many events had been published when the step ended
    and how many refits the program had made, and after the window the
    program's states in refit order.  One more event may be published
    before the refit drains its tap, so the newest event read is one of
    two: the reference takes the one whose refit matches, else the first,
    and counts every entry that differs.  A refit made where the
    reference's window is empty, or one the reference expects and the
    program did not make, counts as the whole table."""
    cap, n = len(tables[0]), run.shape["n_sparse"]
    wb = int(run.traffic["window_batches"])
    m = len(run.fresh[0]["label"]) if run.fresh and run.fresh[0] else 0
    pool_ids = [reference.sparse_ids(b, n, cap) for b in run.pool]

    def event_ids(k):
        base = pool_ids[k % len(pool_ids)]
        if not m:
            return base
        return np.concatenate([reference.sparse_ids(run.fresh[k], n, cap),
                               base[m:]])

    prog = run.program
    versions = list(prog["refit_tables"])
    marks = prog["refit_marks"]
    made = [after - before for (_, before), (_, after)
            in zip(marks, marks[1:] + [(None, len(versions))])]
    mismatch, last = 0, -1
    for (mark, _), n_made in zip(marks, made):
        tried = []
        for newest in (mark - 1, mark):
            window = list(range(max(last + 1, newest - wb + 1), newest + 1))
            if newest >= prog["published"] or not window:
                continue
            want = reference.etl_refit(tables[-1],
                                       [event_ids(k) for k in window])
            got = versions[0] if n_made == 1 else None
            diff = cap if got is None or got.shape != want.shape \
                else int(np.sum(got != want))
            tried.append((newest, want, diff))
            if not diff:
                break
        if not tried:               # nothing had arrived: no refit due
            mismatch += cap * n_made
            versions = versions[n_made:]
            continue
        newest, want, diff = min(tried, key=lambda t: t[2] != 0)
        mismatch += diff
        versions = versions[n_made:]
        tables.append(want)
        last = newest
    return mismatch


def train_checks(prog: dict, ref: dict) -> dict:
    """The program's first steps against the reference's: the worst step's
    loss, the worst leaf's first gradient, and the median leaf's change
    over the steps (one small leaf's change swings with Adam's step on its
    near-zero gradients, seed by seed: the median is steady)."""
    loss = max(abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a)
               else math.inf
               for a, b in zip(prog["losses"], ref["losses"]))
    grads = ref["grad_norms"]
    med = float(np.median(list(grads.values())))
    moving = [n for n, g in grads.items() if g >= 1e-3 * med]
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], moving)
    return {"loss_gap": loss,
            "grad_gap": max(leaf_gaps(prog["grad_norms"], grads, grads)),
            "update_gap": float(np.median(change)) if change else 0.0}


def check(run: Run) -> dict:
    """The numbers compared, each against its limit."""
    s, etl = run.shape, run.cfg["assumed"]
    tables = [reference.etl_fit(run.fit_raw, s["n_sparse"],
                                int(etl["vocab_capacity"]))]
    found = {"vocab_mismatch": int(np.sum(run.program["table"] != tables[0]))}
    if "refit_marks" in run.program:
        found["refit_mismatch"] = refit_checks(run, tables)
    found.update(batch_checks(run, tables))
    if "losses" in run.program:
        batches = [reference.etl_apply(
            run.raw(i), tables[0], n_dense=s["n_dense"],
            n_sparse=s["n_sparse"], dense_padded=s["dense_padded"],
            sparse_padded=int(etl["sparse_padded"]))
            for i in range(int(run.traffic["setup_steps"]))]
        ref = reference.train_three(s, etl, run.seed, batches, run.device)
        found.update(train_checks(run.program, ref))
    limits = run.cfg["limits"]
    return {k: {"value": v, "limit": limits[k]}
            for k, v in found.items() if k in limits}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def execute(cell: str, cfg: dict, traffic: dict, seed: int, seconds: float,
            trace: bool, device, t0: float, metrics: dict) -> dict:
    """Set-up, window and check of one run; ``metrics`` maps each
    per-layer metric to report in a traced run to its reader module.
    Returns the result (without ``device``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(cell, cfg, traffic, seed, seconds, trace, device, t0)
    mode = load_file_module(os.path.join(HERE, "modes",
                                         f"{traffic['mode']}.py"),
                            f"etlbench_mode_{traffic['mode']}")
    mode.run(run)
    run.memory_peak = (torch.cuda.max_memory_allocated(run.device)
                       if run.device.type == "cuda" else 0)
    release(run)
    checks = check(run)
    correct = run.failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(correct), "attempted": run.attempted,
           "failed": run.failed}
    if trace:
        found = {}
        for name, reader in metrics.items():
            v = reader.read(run)
            if v is not None:
                found[name] = v
        out["metrics"] = found
    else:
        out["metrics"] = dict(run.e2e)
    out["memory_peak_bytes"] = int(run.memory_peak)
    out["summary"] = run.summary
    out["phases"] = run.phases
    out["readings"] = run.readings
    out["checks"] = checks
    return out
