"""The program's spans on the profiler's clock: the device time they
launched and the host waits inside them.

While the profiler records, each span of the program's tracer
(``repro_torch.obs.trace``) also holds a profiler range of its name, so the
traced batch's events (``trace.profile``) carry it as a ``user_annotation``
event on the kernels' clock.  A span's device work is what the runtime and
driver calls that start inside it launched (``cudaLaunchKernel``,
``cuLaunchKernelEx`` for Triton, copies, memsets), joined to the device's
kernels, copies and memsets by their correlation ids.  The helpers below
are what the span readers under ``metrics/`` share; each returns None where
the ranges it reads are missing (a program without the spans) and, for the
device, where nothing was launched (no card).
"""
from __future__ import annotations

import bisect

from xrbench import trace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFILL, DECODE = "xrbench.prefill", "xrbench.decode"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
COPIES = ("cudaMemcpyAsync", "cudaMemcpy")


def _found(prof: dict, names, within: str):
    """The user ranges named in ``names`` that start inside the first user
    range ``within``; None where ``within`` is missing."""
    outer = None if prof is None else trace.range_of(prof["events"], within)
    if outer is None:
        return None
    return [e for e in prof["events"]
            if e.get("cat") == "user_annotation" and e["name"] in names
            and outer[0] <= e["ts"] <= outer[1]]


def ranges(prof: dict, names, within: str):
    """(start, end) in microseconds of the user ranges named in ``names``
    inside ``within``, in order; ranges that overlap (same-name ranges
    nested) are merged into one.  None where there are none."""
    found = _found(prof, names, within)
    if not found:
        return None
    return trace._merge([e["ts"], e["ts"] + e["dur"]] for e in found)


def durations_ms(prof: dict, names, within: str):
    """Host milliseconds of each user range named in ``names`` inside
    ``within`` (nested ones counted alone); None where there are none."""
    found = _found(prof, names, within)
    return [e["dur"] / 1e3 for e in found] if found else None


def calls_in(prof: dict, spans: list) -> list:
    """The runtime and driver calls that start inside each of ``spans``
    (sorted, disjoint): one list a span."""
    starts = [a for a, _ in spans]
    per = [[] for _ in spans]
    for e in prof["events"]:
        if e.get("cat") in LAUNCH_CATS:
            i = bisect.bisect_right(starts, e["ts"]) - 1
            if i >= 0 and e["ts"] <= spans[i][1]:
                per[i].append(e)
    return per


def _correlation(e: dict):
    return e.get("args", {}).get("correlation")


def device_index(prof: dict) -> dict:
    """Correlation id -> the kernels, copies and memsets it launched."""
    out = {}
    for e in prof["events"]:
        if e.get("cat") in trace.DEVICE_CATS and _correlation(e) is not None:
            out.setdefault(_correlation(e), []).append(e)
    return out


def device_ms(index: dict, calls: list) -> float:
    """Milliseconds of the union of the device intervals that ``calls``
    launched: a kernel counts once, and overlapping work once."""
    spans = [[d["ts"], d["ts"] + d["dur"]] for c in calls
             for d in index.get(_correlation(c), ())]
    return sum(b - a for a, b in trace._merge(spans)) / 1e3


def launched_ms(prof: dict, names, within: str):
    """Device milliseconds launched inside the ranges ``names`` within
    ``within``; None where the ranges are missing or launched nothing."""
    spans = ranges(prof, names, within)
    if spans is None:
        return None
    calls = [c for per in calls_in(prof, spans) for c in per]
    ms = device_ms(device_index(prof), calls)
    return ms if ms > 0 else None


def per_range_ms(prof: dict, name: str, within: str):
    """Device milliseconds launched inside each range ``name`` within
    ``within``, one number a range; None where the ranges are missing or
    launched nothing."""
    spans = ranges(prof, (name,), within)
    if spans is None:
        return None
    index = device_index(prof)
    out = [device_ms(index, per) for per in calls_in(prof, spans)]
    return out if any(out) else None


def waits(prof: dict, name: str, within: str):
    """Runtime calls inside each range ``name`` within ``within`` that
    block the host: the stream, device and event synchronizes, and each
    memcpy whose copy is device-to-host; one count a range.  None where the
    ranges are missing or hold no runtime call (no card)."""
    spans = ranges(prof, (name,), within)
    if spans is None:
        return None
    index = device_index(prof)
    per = calls_in(prof, spans)
    if not any(per):
        return None

    def blocks(c):
        if c["name"] in SYNCS:
            return True
        return c["name"] in COPIES and any(
            "DtoH" in d["name"] for d in index.get(_correlation(c), ()))

    return [sum(blocks(c) for c in calls) for calls in per]
