"""Concurrent pipeline instances on one GPU (paper §3.4 Q1/Q2, §4.8).

PipeRec hosts up to 7 heterogeneous pipelines in FPGA dynamic regions via
partial reconfiguration.  Here each tenant is an independently compiled
pipeline; "reconfiguration within milliseconds" is swapping which compiled
pipelines are active — no recompilation.

Each tenant is an ``EtlJob`` (``repro_torch.session``): the manager is a
thin composition layer that splits two shared budgets across the jobs:

- **staging credits** (``total_credits``): the shared staging-buffer budget
  is split in proportion to tenant weights, so a heavy tenant's in-flight
  batches cannot crowd a light tenant's staging memory — the FPGA dynamic-
  region partitioning, expressed as queue capacity.
- **transform service** (``service_weighted``): a smooth weighted
  round-robin arbiter grants the transform stage's dispatch slot among the
  tenants currently requesting one, so a 3:1 weight split yields a
  deterministic a,a,b,a grant cycle rather than whoever's thread wakes
  first.  Credits bound memory; service bounds dispatch.

On CUDA every executor runs its transform on a stream of its own, so a
grant orders the tenants' kernel *launches*; their device work may still
overlap on the card.  Host stages run concurrently, so aggregate throughput
scales until the device (or host ingest) saturates — Fig 17, where scaling
is linear until NIC/PCIe bandwidth binds.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.data.source import Source
from repro_torch.session import EtlJob


class WeightedRoundRobin:
    """Smooth weighted round-robin (nginx-style): each pick adds every
    eligible tenant's weight to its running balance, grants the largest
    balance (ties break in registration order — fully deterministic), and
    charges the winner the eligible total.  Over any window the grant
    counts track the weight ratios as closely as integer grants allow.
    """

    def __init__(self, weights: dict):
        if not weights:
            raise ValueError("WeightedRoundRobin needs at least one tenant")
        if any(w <= 0 for w in weights.values()):
            raise ValueError("tenant weights must be positive")
        self.weights = {n: float(w) for n, w in weights.items()}
        self._order = list(weights)
        self._balance = {n: 0.0 for n in weights}

    def pick(self, eligible=None) -> str:
        names = [n for n in self._order
                 if eligible is None or n in eligible]
        if not names:
            raise ValueError("no eligible tenants")
        total = sum(self.weights[n] for n in names)
        best = None
        for n in names:
            self._balance[n] += self.weights[n]
            if best is None or self._balance[n] > self._balance[best]:
                best = n
        self._balance[best] -= total
        return best


class TransformService:
    """Arbitrates transform-stage dispatch slots across tenants.

    One slot exists; ``gate(name)`` hands a tenant its acquire/release
    handle.  Acquire blocks until the WRR arbiter grants ``name`` a turn
    among the tenants *currently requesting* (an idle tenant never blocks
    the others); release frees the slot and re-arbitrates.
    """

    _GRANT_TRACE = 1024  # bounded: observability, not a full history

    def __init__(self, weights: dict):
        self._wrr = WeightedRoundRobin(weights)
        self._cv = threading.Condition()
        self._waiting: dict = {}
        self._grant: Optional[str] = None
        # most recent grant order (observability / tests); bounded so a
        # long-running job never grows it past _GRANT_TRACE entries
        self.grants: collections.deque = collections.deque(
            maxlen=self._GRANT_TRACE)

    def gate(self, name: str) -> "_TenantGate":
        if name not in self._wrr.weights:
            raise KeyError(name)
        return _TenantGate(self, name)

    def _acquire(self, name: str, stop=None) -> bool:
        with self._cv:
            self._waiting[name] = self._waiting.get(name, 0) + 1
            try:
                while True:
                    if self._grant is None:
                        self._grant = self._wrr.pick(set(self._waiting))
                        self.grants.append(self._grant)
                        self._cv.notify_all()
                    if self._grant == name:
                        return True
                    if stop is not None and stop.is_set():
                        return False  # teardown: run unarbitrated
                    self._cv.wait(timeout=0.1)
            finally:
                self._waiting[name] -= 1
                if not self._waiting[name]:
                    del self._waiting[name]

    def _release(self, name: str) -> None:
        with self._cv:
            if self._grant == name:
                self._grant = None
                self._cv.notify_all()


@dataclass
class _TenantGate:
    service: TransformService
    name: str

    def acquire(self, stop=None) -> bool:
        return self.service._acquire(self.name, stop=stop)

    def release(self) -> None:
        self.service._release(self.name)


@dataclass
class TenantResult:
    name: str
    batches: int = 0
    rows: int = 0
    seconds: float = 0.0
    weight: float = 1.0
    credits: int = 1
    stage_breakdown: dict = field(default_factory=dict)

    @property
    def rows_per_s(self) -> float:
        return self.rows / self.seconds if self.seconds else 0.0


def _wait_for(batch: dict) -> None:
    """Block until ``batch``'s device work is done: the delivered batch's
    tensors are ready on the consumer's current stream (the executor made
    it wait on the transform's event), so that stream is synchronized once
    per device.  CPU tensors are ready already."""
    devices = {v.device for v in batch.values()
               if isinstance(v, torch.Tensor) and v.is_cuda}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


@dataclass
class PipelineManager:
    """Run N compiled pipelines concurrently as weighted ``EtlJob``s."""

    tenants: dict = field(default_factory=dict)
    weights: dict = field(default_factory=dict)
    total_credits: int = 8
    service_weighted: bool = True  # WRR arbitration of transform dispatch

    def add(self, name: str, pipeline, source, *, weight: float = 1.0):
        """Register a tenant.  ``source`` is a ``Source``, or (legacy) a
        zero-arg factory returning a fresh raw-batch iterator per run."""
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} already registered")
        if weight <= 0:
            raise ValueError("tenant weight must be positive")
        self.tenants[name] = (pipeline, source)
        self.weights[name] = float(weight)

    def swap(self, name: str, pipeline, source) -> None:
        """Partial-reconfiguration analogue: replace a tenant's pipeline.

        The new pipeline must already be compiled; the swap itself is O(1)
        and keeps the tenant's weight.
        """
        if name not in self.tenants:
            raise KeyError(name)
        self.tenants[name] = (pipeline, source)

    def credit_allocation(self) -> dict:
        """Weighted split of the staging-credit budget (each tenant ≥ 1).

        Largest-remainder apportionment so the shares actually sum to
        ``total_credits`` (never oversubscribing the staging budget), except
        when there are more tenants than credits — then the ≥ 1 floor wins.
        """
        if not self.tenants:
            return {}
        total_w = sum(self.weights[n] for n in self.tenants)
        exact = {n: self.total_credits * self.weights[n] / total_w
                 for n in self.tenants}
        alloc = {n: max(1, int(exact[n])) for n in self.tenants}
        leftover = self.total_credits - sum(alloc.values())
        for n in sorted(self.tenants, key=lambda n: exact[n] - int(exact[n]),
                        reverse=True):
            if leftover <= 0:
                break
            alloc[n] += 1
            leftover -= 1
        return alloc

    def jobs(self, service: Optional[TransformService] = None) -> dict:
        """One EtlJob per tenant under the shared budgets (the manager is
        composition, not a parallel code path).  ``service`` is the
        transform service to gate them with (default: a new one when
        ``service_weighted`` and there is more than one tenant)."""
        alloc = self.credit_allocation()
        svc = service
        if svc is None and self.service_weighted and len(self.tenants) > 1:
            svc = TransformService(self.weights)
        out = {}
        for name, (pipeline, source) in self.tenants.items():
            src = (source if isinstance(source, Source)
                   else Source.stream(source))
            out[name] = EtlJob(
                pipeline, src, credits=alloc[name],
                transform_service=svc.gate(name) if svc else None,
                name=name)
        return out

    def run(self, n_batches: int,
            service: Optional[TransformService] = None) -> dict:
        """Run every tenant for ``n_batches`` batches, each on its own
        thread; a tenant's time counts until its last batch's device work
        is done.  ``service`` as in ``jobs`` (pass one to read its
        ``grants`` afterwards)."""
        alloc = self.credit_allocation()
        results = {n: TenantResult(n, weight=self.weights[n],
                                   credits=alloc[n])
                   for n in self.tenants}
        errors: list = []

        def worker(name: str, job: EtlJob):
            try:
                with job.batches() as ex:
                    t0 = time.perf_counter()
                    for out in itertools.islice(ex, n_batches):
                        _wait_for(out)  # so throughput numbers are honest
                        results[name].batches += 1
                        results[name].rows += int(
                            next(iter(out.values())).shape[0])
                    results[name].seconds = time.perf_counter() - t0
                results[name].stage_breakdown = (
                    job.stats().stage_breakdown())
            except Exception as e:  # pragma: no cover
                errors.append((name, e))
            finally:
                job.close()

        threads = [threading.Thread(target=worker, args=(n, j), daemon=True)
                   for n, j in self.jobs(service).items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise RuntimeError(f"tenant failures: {errors}")
        return results
