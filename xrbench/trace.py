"""One profiled batch, kept whole for the per-layer metrics' readers.

``torch.profiler`` (CPU and CUDA activities) records the batch; its trace
is written with the profiler's own exporter into the checkout's
``build/xrbench/`` and read back as JSON, then deleted.  While it runs, the
program's own span tracer and metrics registry (``repro_torch.obs``) are
installed fresh, and its kernel launch counters are read before and after.
``profile`` returns all of it, so that a reader of a new span, range or
counter needs no edit here:

- ``events``: the profiler's complete events (host ops, runtime calls,
  user ranges such as ``record_function``'s, device kernels, copies and
  memsets), as the exporter wrote them;
- ``spans``: the program tracer's events (``repro_torch.obs.trace``);
- ``counters``: the program registry's snapshot (``repro_torch.obs.metrics``);
- ``launches``: the program's kernel launches during the batch, by name;
- ``window_s``, ``busy_s``, ``device_ops``, ``idle_gaps``: what the result
  line's ``device`` and ``breakdown`` carry (``digest``).

The helpers below (``range_of``, ``device_events``, ``host_ops``) are what
the readers share.
"""
from __future__ import annotations

import bisect
import json
import time
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
WINDOW = "xrbench.window"
TOP = 10
MAX_GAPS = 20000           # longest idle gaps put to a host operation


def profile(fn, trace_dir: Path) -> dict:
    """Run ``fn`` under the profiler (its device activity too, where a card
    is present) with the program's tracer and registry installed; returns
    what the module's docstring lists, with the host seconds the reduction
    took (``reduce_s``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function

    from repro_torch.kernels import ops
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace

    trace_dir.mkdir(parents=True, exist_ok=True)
    path = trace_dir / "trace.json"
    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    tracer, registry = obs_trace.Tracer(), obs_metrics.MetricsRegistry()
    prev_tracer = obs_trace.set_tracer(tracer)
    prev_registry = obs_metrics.set_registry(registry)
    n0 = ops.launch_counts()
    try:
        with tprofile(activities=acts) as prof:
            with record_function(WINDOW):
                fn()
                if card:
                    torch.cuda.synchronize()
    finally:
        obs_trace.set_tracer(prev_tracer)
        obs_metrics.set_registry(prev_registry)
    n1 = ops.launch_counts()
    t0 = time.perf_counter()
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    out = digest(events)
    out["spans"] = tracer.chrome_trace()["traceEvents"]
    out["counters"] = registry.snapshot()
    out["launches"] = {k: n1[k] - n0.get(k, 0) for k in n1}
    out["reduce_s"] = time.perf_counter() - t0
    return out


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def range_of(events: list, name: str):
    """(start, end) in microseconds of the first user range ``name``, or
    None."""
    for e in events:
        if e.get("name") == name and e.get("cat") == "user_annotation":
            return e["ts"], e["ts"] + e["dur"]
    return None


def device_events(prof: dict) -> list:
    """Kernels, copies and memsets that overlap the traced window."""
    w0, w1 = prof["window"]
    return [e for e in prof["events"] if e.get("cat") in DEVICE_CATS
            and e["ts"] < w1 and e["ts"] + e["dur"] > w0]


def host_ops(prof: dict, within: str, prefix: str = "aten::") -> list:
    """Host ops named ``prefix...`` that start inside the user range
    ``within`` (nested ops included); None where the range is missing."""
    r = range_of(prof["events"], within)
    if r is None:
        return None
    return [e for e in prof["events"] if e.get("cat") == "cpu_op"
            and e["name"].startswith(prefix) and r[0] <= e["ts"] <= r[1]]


def digest(events: list) -> dict:
    """The complete events, the traced window, the device's busy time in it
    (the union of kernel, copy and memset intervals), the device operations
    that took most time, and the device's idle gaps, each put to the
    innermost host operation running at its middle."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = range_of(xs, WINDOW)
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    w0, w1 = win
    prof = {"events": xs, "window": win}
    dev = device_events(prof)
    busy = _merge([max(e["ts"], w0), min(e["ts"] + e["dur"], w1)]
                  for e in dev)
    busy_us = sum(b - a for a, b in busy)

    by_name = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += e["dur"]
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    edges = [w0] + [t for ab in busy for t in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted((e for e in xs if e.get("cat") in HOST_CATS),
                  key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    idle = defaultdict(float)
    for a, b in gaps[:MAX_GAPS]:
        mid = (a + b) / 2
        j = bisect.bisect_right(starts, mid) - 1
        name, best = "host code between ops", None
        for e in host[max(0, j - 400):j + 1]:
            if e["ts"] <= mid <= e["ts"] + e["dur"] and (
                    best is None or e["dur"] < best):
                name, best = e["name"], e["dur"]
        idle[name] += b - a
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]

    prof.update({
        "window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
        "device_ops": [[n[:160], us / 1e6] for n, us in device_ops],
        "idle_gaps": [[n[:160], us / 1e6] for n, us in idle_gaps]})
    return prof
