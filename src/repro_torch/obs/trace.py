"""Span tracer: nested wall-clock spans with Chrome trace-event export.

Port of ``repro.obs.trace``.  Where the reference fences a span with
``jax.block_until_ready``, the port synchronises the CUDA device of every
tensor in the fenced value; a value with no CUDA tensor (CPU tensors,
numpy, plain Python) needs no fence.

Design constraints (the reasons this file is small and boring):

* **Near-zero overhead when off.**  Instrumented hot paths call the
  module-level ``span(...)`` helper; with no tracer installed it returns a
  shared no-op singleton — one global load and one ``is None`` test per
  call site, no allocation.
* **Deterministic replay stays deterministic.**  Spans record wall clock,
  but only into the tracer's own buffer — never into any value the
  instrumented code returns: a fleet run with tracing on ships the same
  packets as one with tracing off (tests/test_torch_obs.py).
* **On the profiler's clock.**  While ``torch.profiler`` records, an
  open span also holds a profiler range of its name (``record_function``),
  so the exported trace carries it as a ``user_annotation`` event on the
  kernels' clock, and a reader can put the device work it launched, and
  the idle gaps inside it, to the span.  Off the profiler, and with no
  tracer installed, no range is opened.
* **Fenced on request.**  CUDA work is queued asynchronously, so a span
  can *fence*: hand the result (a tensor or a tuple / list / NamedTuple
  of them) to ``Span.fence`` and — on a ``Tracer(fenced=True)`` — the
  exit timestamp is taken after ``torch.cuda.synchronize`` of each CUDA
  device the value lives on, so a span covering a fleet collect measures
  the real device cost, not the enqueue.  Fencing is opt-in because the
  extra syncs serialize work that would otherwise overlap (it trades
  wall-clock overhead for attribution honesty).

Export is the Chrome trace-event JSON format (chrome://tracing, Perfetto
UI): complete events (``"ph": "X"``) with microsecond timestamps; nesting
is implicit from containment per (pid, tid).
"""
from __future__ import annotations

import functools
import json
import time
from dataclasses import dataclass, field

__all__ = ["Span", "Tracer", "block_until_ready", "get_tracer", "set_tracer",
           "span", "traced"]


class _NullSpan:
    """Shared no-op span: the disabled-path cost is one ``is None`` test."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def fence(self, value):
        return value

    def set(self, **args):
        pass


_NULL_SPAN = _NullSpan()


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of every tensor in ``value`` (nested tuples, lists,
    NamedTuples and dicts)."""
    import torch
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    return out


def block_until_ready(value):
    """Wait for the queued work of every CUDA device ``value`` lives on (a
    no-op for CPU tensors and host values); returns ``value``."""
    import torch
    for dev in _cuda_devices(value, set()):
        torch.cuda.synchronize(dev)
    return value


@dataclass
class Span:
    """One open span; append-to-buffer happens at exit."""
    tracer: "Tracer"
    name: str
    cat: str
    t0: float = 0.0
    tid: int = 0
    args: dict = None
    _fence: object = None
    _range: object = None

    def __enter__(self):
        import torch
        if torch.autograd._profiler_enabled():
            self._range = torch.autograd.profiler.record_function(self.name)
            self._range.__enter__()
        self.tid = self.tracer._depth
        self.tracer._depth += 1
        self.t0 = time.perf_counter()
        return self

    def fence(self, value):
        """Block on ``value`` (tensors, possibly nested) before the span
        closes — queued device work must not make the stage look free."""
        self._fence = value
        return value

    def set(self, **args):
        """Attach key/value args shown in the trace viewer."""
        if self.args is None:
            self.args = {}
        self.args.update(args)

    def __exit__(self, *exc):
        if self._fence is not None and self.tracer.fenced:
            block_until_ready(self._fence)
        t1 = time.perf_counter()
        tr = self.tracer
        tr._depth -= 1
        tr.events.append((self.name, self.cat, self.t0, t1, self.tid,
                          self.args))
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


@dataclass
class Tracer:
    """Collects spans; export with ``chrome_trace()`` / ``save()``."""
    events: list = field(default_factory=list)   # (name, cat, t0, t1,
    #                                               depth, args)
    # fencing is opt-in: Tracer(fenced=True) blocks on each span's fenced
    # tensors before closing, charging queued device work to the span that
    # dispatched it.  Off by default — the extra syncs serialize work that
    # would otherwise overlap, so the unfenced tracer stays in the <5%
    # overhead budget while the fenced one trades overhead for honesty.
    fenced: bool = False
    _depth: int = 0
    _origin: float = field(default_factory=time.perf_counter)

    def span(self, name: str, cat: str = "", **args) -> Span:
        return Span(self, name, cat, args=args or None)

    def clear(self) -> None:
        self.events.clear()
        self._depth = 0
        self._origin = time.perf_counter()

    def __len__(self) -> int:
        return len(self.events)

    # ------------------------------------------------------------------
    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (``{"traceEvents": [...]}``).

        Spans become complete events; the recorded nesting depth maps to
        ``tid`` so sibling stacks render as lanes and containment shows
        parent/child (Perfetto infers nesting from time containment per
        track, which holds by construction here: a child's [t0, t1] lies
        inside its parent's).
        """
        evs = []
        for name, cat, t0, t1, depth, args in self.events:
            ev = {"name": name, "cat": cat or "default", "ph": "X",
                  "pid": 1, "tid": 1,
                  "ts": (t0 - self._origin) * 1e6,
                  "dur": max((t1 - t0) * 1e6, 0.0),
                  "args": dict(args) if args else {}}
            ev["args"]["depth"] = depth
            evs.append(ev)
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)

    # ------------------------------------------------------------------
    def durations_ms(self, name: str | None = None) -> list:
        """[ms] span durations (optionally filtered by name) — the bridge
        from traces to metrics histograms."""
        return [(t1 - t0) * 1e3 for n, _, t0, t1, _, _ in self.events
                if name is None or n == name]


# ---------------------------------------------------------------------------
# the process-wide tracer (None = tracing off, the default)
# ---------------------------------------------------------------------------
_TRACER: Tracer | None = None


def get_tracer() -> Tracer | None:
    return _TRACER


def set_tracer(tracer: Tracer | None) -> Tracer | None:
    """Install (or clear, with None) the process-wide tracer; returns the
    previous one so callers can restore it."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


def span(name: str, cat: str = "", **args):
    """Open a span on the process-wide tracer (no-op when tracing is off).

        with obs.span("fleet.collect", cat="sync", zone=z) as sp:
            pkt = sess.collect(...)
            sp.fence(pkt.batch)
    """
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return t.span(name, cat, **args)


def traced(name: str | None = None, cat: str = ""):
    """Decorator form: trace every call of ``fn`` as one span."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            t = _TRACER
            if t is None:
                return fn(*a, **kw)
            with t.span(label, cat):
                return fn(*a, **kw)
        return wrapper
    return deco
