"""The profiler reader: ``torch.profiler`` over a traced run's window,
reduced from its Chrome trace to what the per-layer metrics read.  Only
the CUDA activity is recorded (kernels, copies, memsets and the CUDA
runtime calls that launch them): recording every host operator as well
costs the host a few microseconds a launch more.  The profiler's first
start in a process takes seconds: ``warm`` pays it in set-up.

- ``busy_s``: the union of the intervals in which a kernel, a copy or a
  memset ran on the device (streams that overlap count once);
- ``kernels``: device seconds and launches by name;
- ``h2d_s`` / ``h2d_n``: host-to-device copies;
- ``device_ops``: the ten names with the most device time;
- ``idle_gaps``: the ten longest intervals with nothing on the device,
  each named by the innermost host operation running at its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op", "user_annotation")


def activity():
    import torch
    from torch.profiler import ProfilerActivity
    # (the CPU's activity only where there is no card: the CPU tests)
    return ProfilerActivity.CUDA if torch.cuda.is_available() \
        else ProfilerActivity.CPU


def warm(device) -> None:
    """Start and stop the profiler once around one kernel: its first start
    in a process (CUPTI's set-up) takes seconds, during which nothing is
    launched, so a traced run pays it in set-up, not in its window."""
    import torch
    from torch.profiler import profile
    x = torch.zeros(1, device=device)
    with profile(activities=[activity()]):
        x.add_(1)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)


@contextlib.contextmanager
def profiled(enabled: bool):
    """Yield a running profiler, or None when ``enabled`` is false."""
    if not enabled:
        yield None
        return
    from torch.profiler import profile
    with profile(activities=[activity()]) as prof:
        yield prof


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="etlbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def summarize(prof, window_s: float, top: int = 10) -> dict:
    events = _events(prof)
    dev, host = [], []
    for e in events:
        ts, dur = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("name", "?"), e["cat"]))
        elif e.get("cat") in HOST_CATS:
            host.append((ts, ts + dur, e.get("name", "?")))
    kernels: dict = {}
    h2d_us, h2d_n = 0.0, 0
    for s, e, name, cat in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) / 1e6
        k[1] += 1
        if cat == "gpu_memcpy" and "HtoD" in name:
            h2d_us += e - s
            h2d_n += 1
    merged = _union([(s, e) for s, e, _, _ in dev])
    busy_s = sum(e - s for s, e in merged) / 1e6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:top]
    host.sort()
    starts = [h[0] for h in host]
    idle = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        i = bisect.bisect_right(starts, mid)
        inner = None
        for hs, he, name in host[max(0, i - 2000):i]:
            if he >= mid and (inner is None or he - hs < inner[1] - inner[0]):
                inner = (hs, he, name)
        if inner is None and i:
            inner = (0, 0, "after " + host[i - 1][2])
        idle.append([inner[2] if inner else "no host call",
                     length / 1e6])
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return {"busy_s": busy_s, "window_s": window_s,
            "kernels": {k: tuple(v) for k, v in kernels.items()},
            "h2d_s": h2d_us / 1e6, "h2d_n": h2d_n,
            "device_ops": [[k, v[0]] for k, v in ops],
            "idle_gaps": idle}


def kernel_time(summary: dict, base: str) -> tuple:
    """``(device seconds, launches)`` of the kernels whose name has
    ``base`` as a whole word (a CUDA kernel's demangled name carries its
    template arguments and parameters)."""
    pat = re.compile(rf"\b{re.escape(base)}\b")
    s = n = 0
    for name, (sec, count) in summary["kernels"].items():
        if pat.search(name):
            s += sec
            n += count
    return s, n
