"""Lookahead embedding prefetch with a device-resident hot-row cache.

The port of the JAX package's ``etl_runtime/lookahead.py``.  The executor
sees batches several steps before the train step does; at recommender scale
the skewed hot set of embedding rows is small, so peeking ahead, deduping
indices and keeping hot rows in a device-resident cache turns most of the
irregular table gather into a lookup in a small cache.

Three pieces, split host/device like the rest of the runtime:

- ``LookaheadPlanner`` — host-side policy, pure numpy, a copy of the
  reference's that gives its plans bit for bit.  It keeps per-table row
  frequency over a window of W upcoming batches and, when the oldest batch
  is released, emits a ``PrefetchPlan``: a per-table index remap (hot row
  -> cache slot, cold row -> original id), the rows to stage for this batch,
  and a cache-update plan (admit/evict chosen by window frequency).
- ``LookaheadStage`` — the executor stage (after **place**, before
  deliver).  It buffers W in-flight envelopes, feeds the planner, and
  annotates each released payload with the plan arrays under
  ``PLAN_KEYS``.  The index matrix of a CUDA payload was written on the
  transform stream: the stage waits on the envelope's event before it
  copies the selected columns to the host.
- ``EmbedCache`` — the device-side consumer.  ``advance(tables, batch)``
  applies the batch's plan in place to the stacked
  ``[T, rows + stage_max, dim]`` cache tensor (admits + per-batch staging)
  and returns kernel-ready inputs; ``cached_embedding_lookup`` (defined
  beside its kernel in ``kernels/embedding_bag.py``, re-exported here) is
  the differentiable lookup: its forward is one ``embedding_bag_cached``
  launch over every feature of the plan (the JAX package makes one call
  per feature and stacks them), and its backward scatter-adds into the
  table through the ORIGINAL row ids, so training gradients are exact.

Slot layout: slots ``[0, rows)`` are the resident hot set (persist across
batches, admit/evict managed by the planner), slots ``[rows, rows +
stage_max)`` are the per-batch staging region.  A cold row that overflows
the staging region keeps ``slot == -1`` and falls through to the table in
``embedding_bag_cached``, so the remap is total and exact whatever the
cache pressure.

Coherence: with a static table rows are copied on admit only.  Under
training the table changes every step, so ``EmbedCacheConfig(refresh=True)``
re-admits every *referenced* resident row from the current table each batch
and cached training stays bit-exact.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from dataclasses import replace
from typing import Callable, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.etl_runtime import transfer as transfer_lib
from repro_torch.etl_runtime.clock import SYSTEM_CLOCK
from repro_torch.kernels.backend import resolve_device
# the differentiable lookup lives beside its kernel; re-exported here, where
# the reference keeps it
from repro_torch.kernels.embedding_bag import \
    cached_embedding_lookup  # noqa: F401

# Keys the lookahead stage adds to each released payload (host numpy arrays).
PLAN_KEYS = ("emb_slot", "emb_cold", "emb_stage_rows",
             "emb_admit_slots", "emb_admit_rows")


@dataclasses.dataclass(frozen=True)
class EmbedCacheConfig:
    """Knobs for the lookahead prefetch + embedding cache layer.

    rows : resident cache slots per table (the device hot set).
    window : lookahead window W in batches; frequency (and therefore the
        hot set) is computed over the W in-flight envelopes.
    stage_max : per-batch staging slots appended after the resident region
        (0 -> ``rows``).  Cold rows beyond this fall through to the table.
    tables : feature columns of the index matrix that get a cache (per-table
        on/off); None = every column.
    key : payload key holding the int32 ``[B, F]`` index matrix.
    min_admit_freq : window occurrences before a row may displace a resident.
    refresh : re-admit referenced resident rows from the current table every
        batch (exactness under training updates; leave False for static
        tables).
    row_bytes : bytes per embedding row, for gather-bytes-saved accounting.
    """

    rows: int
    window: int = 4
    stage_max: int = 0
    tables: Optional[tuple] = None
    key: str = "sparse"
    min_admit_freq: int = 2
    refresh: bool = False
    row_bytes: int = 0

    def stage_slots(self) -> int:
        return self.stage_max if self.stage_max > 0 else self.rows

    def admit_slots(self) -> int:
        # admits are bounded by the cache size; refresh adds at most one
        # entry per resident slot on top
        return self.rows * (2 if self.refresh else 1)


@dataclasses.dataclass
class CacheStats:
    """Lookahead/cache accounting (exported by ``etl_runtime.metrics``)."""

    lookups: int = 0        # index entries planned (excl. -1 padding)
    hits: int = 0           # served by a row already resident before the plan
    misses: int = 0         # lookups whose row was not resident
    admitted: int = 0       # rows copied table -> resident slots (incl. refresh)
    evicted: int = 0        # resident rows displaced by admission
    staged: int = 0         # unique cold rows staged per batch
    overflow_cold: int = 0  # lookups left to the table fall-through
    row_bytes: int = 0

    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def gather_bytes_saved(self) -> float:
        """Table gather traffic avoided vs the uncached kernel: every lookup
        would have been one table-row fetch; the cached path fetches only
        admitted + staged + fall-through rows."""
        fetched = self.admitted + self.staged + self.overflow_cold
        return max(0, self.lookups - fetched) * self.row_bytes

    def as_dict(self) -> dict:
        return {"lookups": self.lookups, "hits": self.hits,
                "misses": self.misses, "admitted": self.admitted,
                "evicted": self.evicted, "staged": self.staged,
                "overflow_cold": self.overflow_cold,
                "hit_rate": self.hit_rate(),
                "gather_bytes_saved": self.gather_bytes_saved()}


@dataclasses.dataclass
class PrefetchPlan:
    """Per-batch annotation, all host numpy, shapes static per config:

    slot  : int32[B, T]  ext-cache slot per lookup (-1 = fall through)
    cold  : int32[B, T]  original row where slot == -1 (-1 = padding lane)
    stage_rows  : int32[T, E]  rows staged into slots [rows, rows+E) (-1 pad)
    admit_slots : int32[T, A]  resident slots to overwrite before the batch
    admit_rows  : int32[T, A]  table rows to copy into those slots (-1 pad)
    """

    slot: np.ndarray
    cold: np.ndarray
    stage_rows: np.ndarray
    admit_slots: np.ndarray
    admit_rows: np.ndarray

    def as_payload(self) -> dict:
        return dict(zip(PLAN_KEYS, (self.slot, self.cold, self.stage_rows,
                                    self.admit_slots, self.admit_rows)))


class LookaheadPlanner:
    """Host-side window frequency + hot set + remap planner.

    Drive it with ``push(idx)`` as batches enter the window and
    ``pop_plan()`` as the oldest batch is released (idx is that batch's
    int ``[B, T]`` column-selected index matrix).  The plan for a batch is
    computed while the batch itself and its W-1 successors are in the window.
    """

    def __init__(self, cfg: EmbedCacheConfig, n_tables: int,
                 stats: Optional[CacheStats] = None):
        self.cfg = cfg
        self.n_tables = n_tables
        self.stats = stats if stats is not None \
            else CacheStats(row_bytes=cfg.row_bytes)
        self._window: collections.deque = collections.deque()
        self._freq = [collections.Counter() for _ in range(n_tables)]
        self._slot_of = [dict() for _ in range(n_tables)]   # row -> slot
        self._row_of = [np.full(cfg.rows, -1, np.int64)
                        for _ in range(n_tables)]           # slot -> row
        self._free = [list(range(cfg.rows - 1, -1, -1))
                      for _ in range(n_tables)]

    # -- window maintenance ------------------------------------------------

    def push(self, idx: np.ndarray) -> None:
        """A batch entered the window: count its rows (padding -1 ignored)."""
        idx = np.asarray(idx)
        self._window.append(idx)
        for t in range(self.n_tables):
            col = idx[:, t]
            u, c = np.unique(col[col >= 0], return_counts=True)
            self._freq[t].update(dict(zip(u.tolist(), c.tolist())))

    def window_depth(self) -> int:
        return len(self._window)

    def resident_rows(self, t: int) -> np.ndarray:
        return self._row_of[t][self._row_of[t] >= 0]

    # -- planning ----------------------------------------------------------

    def pop_plan(self) -> tuple[np.ndarray, PrefetchPlan]:
        """Release the oldest window batch: plan it, retire its counts."""
        if not self._window:
            raise ValueError("pop_plan on an empty window")
        idx = self._window[0]
        plan = self._plan(idx)
        self._retire(self._window.popleft())
        return idx, plan

    def _retire(self, idx: np.ndarray) -> None:
        for t in range(self.n_tables):
            col = idx[:, t]
            u, c = np.unique(col[col >= 0], return_counts=True)
            freq = self._freq[t]
            freq.subtract(dict(zip(u.tolist(), c.tolist())))
            for r in u.tolist():
                if freq[r] <= 0:
                    del freq[r]

    def _plan(self, idx: np.ndarray) -> PrefetchPlan:
        cfg = self.cfg
        B, T = idx.shape
        E, A = cfg.stage_slots(), cfg.admit_slots()
        slot = np.full((B, T), -1, np.int32)
        cold = np.full((B, T), -1, np.int32)
        stage_rows = np.full((T, E), -1, np.int32)
        admit_slots = np.full((T, A), -1, np.int32)
        admit_rows = np.full((T, A), -1, np.int32)
        for t in range(self.n_tables):
            self._plan_table(t, idx[:, t], slot[:, t], cold[:, t],
                             stage_rows[t], admit_slots[t], admit_rows[t])
        return PrefetchPlan(slot, cold, stage_rows, admit_slots, admit_rows)

    def _plan_table(self, t: int, col, slot_out, cold_out, stage_out,
                    admit_slot_out, admit_row_out) -> None:
        cfg, st = self.cfg, self.stats
        freq, slot_of, row_of = self._freq[t], self._slot_of[t], self._row_of[t]
        valid = col >= 0
        u, inv = np.unique(col[valid], return_inverse=True)
        resident_before = np.fromiter(
            (slot_of.get(int(r), -1) for r in u), np.int32, len(u))

        # admission: window-frequent rows displace the coldest residents
        desired = [r for r, c in freq.most_common(cfg.rows)
                   if c >= cfg.min_admit_freq]
        admits = [r for r in desired if r not in slot_of]
        n_admit = 0
        if admits:
            desired_set = set(desired)
            victims = sorted((r for r in row_of[row_of >= 0].tolist()
                              if r not in desired_set),
                             key=lambda r: freq[r] if r in freq else 0)
            for row in admits:
                if self._free[t]:
                    s = self._free[t].pop()
                elif victims:
                    old = victims.pop(0)
                    s = slot_of.pop(old)
                    st.evicted += 1
                else:
                    break  # cache full of desired rows: stop admitting
                slot_of[row] = s
                row_of[s] = row
                admit_slot_out[n_admit] = s
                admit_row_out[n_admit] = row
                n_admit += 1
        st.admitted += n_admit

        # remap against the post-admission resident set
        resident_after = np.fromiter(
            (slot_of.get(int(r), -1) for r in u), np.int32, len(u))
        hit_u = (resident_before >= 0) & (resident_after >= 0)
        counts = np.bincount(inv, minlength=len(u))
        st.lookups += int(valid.sum())
        st.hits += int(counts[hit_u].sum())
        st.misses += int(valid.sum()) - int(counts[hit_u].sum())

        # stage this batch's cold rows just-in-time (dedup'd); overflow
        # falls through to the table
        cold_u = np.flatnonzero(resident_after < 0)
        staged_u = cold_u[: len(stage_out)]
        stage_out[: len(staged_u)] = u[staged_u]
        ext_slot = resident_after.copy()
        ext_slot[staged_u] = cfg.rows + np.arange(len(staged_u), dtype=np.int32)
        st.staged += len(staged_u)
        overflow_u = np.zeros(len(u), bool)
        overflow_u[cold_u[len(stage_out):]] = True
        st.overflow_cold += int(counts[overflow_u].sum())

        if cfg.refresh:
            # exactness under training: re-copy every referenced resident
            # row from the current table (device memory still touched once
            # per unique row — the dedup win — never once per lookup)
            ref_u = np.flatnonzero(hit_u)
            n_ref = min(len(ref_u), len(admit_slot_out) - n_admit)
            admit_slot_out[n_admit:n_admit + n_ref] = resident_after[ref_u[:n_ref]]
            admit_row_out[n_admit:n_admit + n_ref] = u[ref_u[:n_ref]]
            st.admitted += n_ref

        slot_out[valid] = ext_slot[inv]
        cold_full = np.where(ext_slot < 0, u, -1).astype(np.int32)
        cold_out[valid] = cold_full[inv]


class LookaheadStage(threading.Thread):
    """Executor stage: window W envelopes after place, annotate with plans.

    Mirrors ``_SortStage``'s shape: bounded buffering, EOS drains the
    partial window, stop aborts promptly, errors surface via ``on_error``.
    Reading the index matrix of a CUDA payload waits for the transform
    stream's event (host sync of that one batch) and copies the selected
    columns to the host; the stage's host work is the point (plans ride the
    envelope, device work at the consumer stays dense).
    """

    def __init__(self, stats, in_q, out_q, cfg: EmbedCacheConfig, *,
                 cache_stats: Optional[CacheStats] = None,
                 on_put: Optional[Callable[[int], None]] = None,
                 on_error: Optional[Callable[[BaseException], None]] = None,
                 clock=None):
        super().__init__(name=f"etl-{stats.name}", daemon=True)
        self.stats = stats
        self.in_q = in_q
        self.out_q = out_q
        self.cfg = cfg
        self.cache_stats = cache_stats
        # the planner is built on the first batch: with cfg.tables=None the
        # index-matrix width is only known once a payload arrives
        self.planner: Optional[LookaheadPlanner] = None
        self.on_put = on_put
        self.on_error = on_error
        self._clock = clock or SYSTEM_CLOCK
        self._buf: collections.deque = collections.deque()
        self._window = max(1, cfg.window)

    def set_window(self, window: int) -> None:
        """Retarget the lookahead depth W; takes effect on the next batch
        (a shrink releases the now-excess envelopes then)."""
        self._window = max(1, int(window))

    def _indices(self, env) -> np.ndarray:
        x = env.payload[self.cfg.key]
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        elif env.event is not None:
            env.event.synchronize()  # the transform stream wrote x
        if x.ndim != 2:
            raise ValueError(
                f"lookahead key {self.cfg.key!r} must be a [batch, tables] "
                f"index matrix, got shape {tuple(x.shape)}")
        if self.cfg.tables is not None:
            x = x[:, list(self.cfg.tables)]
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()  # only the planned columns cross to the host
        return x.astype(np.int64, copy=False)

    def _release(self) -> bool:
        from repro_torch.etl_runtime.runtime import _STOPPED
        env = self._buf.popleft()
        _, plan = self.planner.pop_plan()
        payload = dict(env.payload)
        payload.update(plan.as_payload())
        mono = self._clock.monotonic
        t0 = mono()
        r = self.out_q.put(replace(env, payload=payload))
        self.stats.wait_out_s += mono() - t0
        if r is _STOPPED:
            return False
        self.stats.items += 1
        if self.on_put:
            self.on_put(r)
        return True

    def run(self):
        from repro_torch.etl_runtime.runtime import _EOS, _STOPPED
        mono = self._clock.monotonic
        while True:
            t0 = mono()
            item = self.in_q.get()
            self.stats.wait_in_s += mono() - t0
            if item is _STOPPED:
                return
            if item is _EOS:
                while self._buf:
                    t1 = mono()
                    ok = self._release()
                    self.stats.busy_s += mono() - t1
                    if not ok:
                        return
                self.out_q.put(_EOS)
                return
            t1 = mono()
            try:
                idx = self._indices(item)
                if self.planner is None:
                    self.planner = LookaheadPlanner(
                        self.cfg, idx.shape[1], stats=self.cache_stats)
                self.planner.push(idx)
                self._buf.append(item)
                ok = True
                # drain to the live window target (a shrunk window releases
                # the excess; at steady state this pops one per push)
                while ok and len(self._buf) >= self._window:
                    ok = self._release()
            except Exception as e:
                if self.on_error:
                    self.on_error(e)
                return
            self.stats.busy_s += mono() - t1
            if not ok:
                return


# ---------------------------------------------------------------------------
# device side: cache tensor lifecycle + differentiable cached lookup
# ---------------------------------------------------------------------------

def _data_sharded_rows(tables, feat: np.ndarray,
                       row: np.ndarray) -> torch.Tensor:
    """``tables[feat, row]`` (``[N, dim]``) where FSDP holds the stacked
    tables sharded over the data axes (a DTensor ``Shard(d)`` of a 1-D data
    mesh, on whatever dim the rule chose), each data rank asking for the
    rows of its own plan.  The table is never gathered: the ranks' requests
    are all-gathered (ids, a few KB), each rank fills the part of every
    request it holds (its columns, or the whole rows in its range of tables
    or rows) and zero elsewhere, and one reduce-scatter over the data group
    sums the parts into each rank's own rows.  Both collectives count in
    ``tensor_parallel.TRAFFIC["embed_cache_gather"]``."""
    mesh = tables.device_mesh
    (pl,) = tables.placements
    local = tables.to_local().detach()
    dev = local.device
    feat = torch.as_tensor(feat, dtype=torch.int64, device=dev)
    row = torch.as_tensor(row, dtype=torch.int64, device=dev)
    d = pl.dim
    dax = tp.ModelAxis(mesh.get_group(), mesh.get_local_rank(), mesh.size())
    kind = "embed_cache_gather"
    n = feat.shape[0]
    counts = tp.all_gather(torch.tensor([n], device=dev), 0, dax, kind)
    most = int(counts.max())
    req = torch.zeros(2, most, dtype=torch.int64, device=dev)
    req[0, :n], req[1, :n] = feat, row
    every = tp.all_gather(req, 1, dax, kind)  # [2, ranks * most]
    # the part of each request this rank holds: its slice of dim d
    lo = dax.rank * -(-tables.shape[d] // dax.size)
    if d == 2:
        part = local.new_zeros(every.shape[1], tables.shape[2])
        part[:, lo:lo + local.shape[2]] = local[every[0], every[1]]
    else:  # (the rule shards a dim the data degree divides: never empty)
        at = [every[0], every[1]]
        held = (at[d] >= lo) & (at[d] < lo + local.shape[d])
        at[d] = (at[d] - lo).clamp(0, local.shape[d] - 1)
        part = local[at[0], at[1]]
        part = torch.where(held[:, None], part, part.new_zeros(()))
    return tp.reduce_scatter_sum(part, 0, dax, kind)[:n]


class EmbedCache:
    """Device-resident stacked cache ``ext [T, rows + stage_max, dim]`` plus
    the per-batch ``advance`` that consumes ``PLAN_KEYS`` annotations.

    ``advance(tables, batch)`` pops the plan arrays from the payload dict,
    applies the admit plan and the per-batch staging from the CURRENT
    ``tables`` (``[T, vocab, dim]``) in place under ``no_grad`` — one gather
    and one ``index_copy_`` for the admits, one gather for the staging
    region — and returns the batch with ``emb_cache`` / ``emb_slot`` /
    ``emb_cold`` kernel inputs.  The ``-1`` admit entries are dropped on the
    host, where the plan lives, so no device sync is needed; ``-1`` stage
    rows read row 0 as the reference's ``clip(r, 0)`` does, so ``ext`` is
    bit-equal to the JAX package's.  ``ext`` is updated in place (the JAX
    package returns a new array): a batch's ``emb_cache`` is valid until
    the next ``advance``.  Batches carrying plans must be advanced in
    delivery order — the planner's host mirror assumes every admit executes.

    On a table row-sharded over the model axis ``tables`` is this rank's
    rows (``[T, vocab / m, dim]``): each rank's ``ext`` holds the rows in
    its range and zero in every other slot (``_apply``), and the model
    ranks of one data coordinate, which receive the same rows, apply the
    same plan.
    """

    def __init__(self, cfg: EmbedCacheConfig, n_tables: int, dim: int, *,
                 device=None):
        self.cfg = cfg
        self.n_tables = n_tables
        self.dim = dim
        # f32, as the kernels take (both packages' DLRM keep f32 tables)
        self.ext = torch.zeros(n_tables, cfg.rows + cfg.stage_slots(), dim,
                               dtype=torch.float32,
                               device=resolve_device(device))
        self.generation = 0  # bumped by invalidate() on state-version swaps

    def invalidate(self) -> None:
        """Zero every cache row on a vocabulary state-version swap.

        An incremental refit keeps existing value->rank assignments, so the
        planner's slot->row mapping stays valid across the swap — but cached
        row *contents* may belong to the pre-swap embedding landscape, so the
        trainer drops them all.  Requires ``cfg.refresh=True`` to be
        bit-exact afterwards: refresh re-admits every referenced resident
        from the current tables before its next use.  ``generation`` counts
        swaps for observability.
        """
        self.ext.zero_()
        self.generation += 1

    def _apply(self, tables: torch.Tensor, admit_slots: np.ndarray,
               admit_rows: np.ndarray, stage_rows: np.ndarray) -> None:
        """The plan's admits and staging from ``tables``: the whole stacked
        tables, or this rank's rows of them where they are sharded over the
        model axis (``tp.shard_of`` names dim 1): then only the rows in the
        rank's range are copied, and every other admitted or staged slot is
        zeroed, so the ranks' caches sum to the whole cache.  Tables that
        FSDP holds sharded over the data axes (a DTensor) give each rank
        the whole rows its own plan asks for (``_data_sharded_rows``)."""
        n_t, n_ext, dim = self.ext.shape
        vocab = tables.shape[1]
        d, ax = tp.shard_of(tables)
        first = ax.rank * vocab if d == 1 else 0
        t_of, j = np.nonzero(admit_slots >= 0)
        # the admitted rows, then the staged ones; a -1 row reads (global)
        # row 0, as the reference's clip(r, 0) does
        feat = np.concatenate([t_of, np.repeat(np.arange(n_t),
                                               stage_rows.shape[1])])
        row = np.clip(np.concatenate([admit_rows[t_of, j],
                                      stage_rows.reshape(-1)]), 0, None) \
            - first
        ids = {"admit_dst": t_of * n_ext + admit_slots[t_of, j]}
        out = np.flatnonzero((row < 0) | (row >= vocab))
        if len(out):  # rows another rank holds
            ids["out"] = out
        row = np.clip(row, 0, vocab - 1)
        if not isinstance(tables, DTensor):
            ids["src"] = feat * vocab + row
        ids = transfer_lib.to_device(
            {k: v.astype(np.int64) for k, v in ids.items()}, self.ext.device)
        with torch.no_grad():
            if isinstance(tables, DTensor):
                vals = _data_sharded_rows(tables, feat, row)
            else:
                vals = tables.detach().reshape(-1, dim).index_select(
                    0, ids["src"])
            if "out" in ids:
                vals.index_fill_(0, ids["out"], 0)
            if len(t_of):
                self.ext.view(-1, dim).index_copy_(0, ids["admit_dst"],
                                                   vals[:len(t_of)])
            self.ext[:, self.cfg.rows:, :] = vals[len(t_of):].view(
                n_t, -1, dim)

    def advance(self, tables: torch.Tensor, batch: dict) -> dict:
        if PLAN_KEYS[0] not in batch:
            return batch  # un-planned batch (e.g. warmup before the window)
        batch = dict(batch)
        slot, cold, stage_rows, admit_slots, admit_rows = (
            np.asarray(batch.pop(k)) for k in PLAN_KEYS)
        self._apply(tables, admit_slots, admit_rows, stage_rows)
        ids = transfer_lib.to_device({"emb_slot": slot, "emb_cold": cold},
                                     self.ext.device)
        batch["emb_cache"] = self.ext
        batch.update(ids)
        return batch
