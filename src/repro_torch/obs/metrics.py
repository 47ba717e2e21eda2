"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

Port of ``repro.obs.metrics`` (pure Python: the same code).  The port's
modules record only into this registry, never into the reference's.
Unifies the ad-hoc accounting (``update_nbytes`` byte totals,
``ClientSession.up_bytes`` / fault counters, tick wall times) behind one
API with two export formats (Prometheus text, JSON snapshot).

Determinism rules:

* Values flow INTO metrics; nothing ever flows back out into computation,
  so attaching a registry to a run cannot perturb a bit-exact replay.
* Histogram percentiles come from **fixed bucket bounds + integer counts**
  — pure arithmetic over recorded samples, no wall clock, no sampling.
  The percentile estimate is the *upper edge* of the bucket holding the
  rank-``ceil(p/100 * n)``-th sample (nearest-rank rule), so two runs that
  observe the same samples report identical percentiles to the bit.
* ``exact_percentiles`` computes nearest-rank percentiles over a raw
  sample list (used for the small ``wall_ms`` vectors where keeping every
  sample is cheap) — it always returns an actual observed sample.
"""
from __future__ import annotations

import bisect
import json
import math
from dataclasses import dataclass, field

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "set_registry", "exact_percentiles",
           "default_latency_buckets"]


def default_latency_buckets() -> tuple:
    """Log-spaced ms buckets, 10 us .. ~100 s: 5 per decade, fixed across
    runs so recorded histograms are comparable between PRs."""
    return tuple(round(10.0 ** (e / 5.0), 6) for e in range(-10, 26))


def exact_percentiles(samples, ps=(50, 95, 99)) -> dict:
    """Nearest-rank percentiles over raw samples (deterministic, returns
    actual observed values).  Empty input -> all-zero, n = 0."""
    out = {"n": len(samples)}
    xs = sorted(float(x) for x in samples)
    for p in ps:
        if not xs:
            out[f"p{p}"] = 0.0
            continue
        rank = max(int(math.ceil(p / 100.0 * len(xs))), 1)
        out[f"p{p}"] = xs[rank - 1]
    if xs:
        out["mean"] = sum(xs) / len(xs)
        out["max"] = xs[-1]
    else:
        out["mean"] = out["max"] = 0.0
    return out


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


# ---------------------------------------------------------------------------
def _number(v):
    """A counter's value as a Python number: a 0-d tensor is read here."""
    return v.item() if hasattr(v, "item") else v


@dataclass
class Counter:
    """Monotonic counter, one value per label set.

    ``inc`` also takes a 0-d tensor, which it adds on the tensor's device
    with no host read, so a count the device holds (copies an MoE kept)
    costs no sync where it is made; ``value``, ``total`` and the exports
    read it as a Python number, after the caller's own synchronize."""
    name: str
    help: str = ""
    values: dict = field(default_factory=dict)    # label key -> number

    def inc(self, v=1, **labels) -> None:
        k = _label_key(labels)
        self.values[k] = self.values.get(k, 0) + v

    def value(self, **labels):
        return _number(self.values.get(_label_key(labels), 0))

    def total(self):
        return sum(_number(v) for v in self.values.values())


@dataclass
class Gauge:
    """Last-write-wins value, one per label set."""
    name: str
    help: str = ""
    values: dict = field(default_factory=dict)

    def set(self, v, **labels) -> None:
        self.values[_label_key(labels)] = v

    def value(self, **labels):
        return self.values.get(_label_key(labels), 0)


@dataclass
class Histogram:
    """Fixed-bucket histogram with deterministic percentile math.

    ``bounds`` are the inclusive upper edges of each bucket; samples above
    the last bound land in a +inf overflow bucket.  Bounds are fixed at
    construction, so the bucket layout — and therefore every percentile —
    is a pure function of the observed samples.
    """
    name: str
    help: str = ""
    bounds: tuple = field(default_factory=default_latency_buckets)
    series: dict = field(default_factory=dict)    # label key ->
    #                                               (counts list, sum, n)

    def _series(self, labels: dict):
        k = _label_key(labels)
        s = self.series.get(k)
        if s is None:
            s = self.series[k] = [[0] * (len(self.bounds) + 1), 0.0, 0]
        return s

    def observe(self, v, **labels) -> None:
        s = self._series(labels)
        s[0][bisect.bisect_left(self.bounds, v)] += 1
        s[1] += v
        s[2] += 1

    def count(self, **labels) -> int:
        k = _label_key(labels)
        return self.series[k][2] if k in self.series else 0

    def percentile(self, p: float, **labels) -> float:
        """Nearest-rank percentile from bucket counts: the upper edge of
        the bucket containing the rank-``ceil(p/100 * n)``-th sample (0.0
        for an empty series; +inf only if that sample overflowed the last
        bound).  For a single-sample series every percentile is that
        sample's bucket edge."""
        k = _label_key(labels)
        if k not in self.series:
            return 0.0
        counts, _, n = self.series[k]
        if n == 0:
            return 0.0
        rank = max(int(math.ceil(p / 100.0 * n)), 1)
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= rank:
                return self.bounds[i] if i < len(self.bounds) \
                    else float("inf")
        return float("inf")      # unreachable: seen == n >= rank

    def summary(self, **labels) -> dict:
        """{n, mean, p50, p95, p99} for one label set."""
        k = _label_key(labels)
        if k not in self.series or self.series[k][2] == 0:
            return {"n": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        _, tot, n = self.series[k]
        return {"n": n, "mean": tot / n,
                "p50": self.percentile(50, **labels),
                "p95": self.percentile(95, **labels),
                "p99": self.percentile(99, **labels)}


# ---------------------------------------------------------------------------
@dataclass
class MetricsRegistry:
    """Named metric registry; metrics are created on first use.

    ``counter/gauge/histogram`` return the existing instance when the name
    is already registered (help/bounds from the first registration win),
    so call sites don't need to coordinate.
    """
    counters: dict = field(default_factory=dict)
    gauges: dict = field(default_factory=dict)
    histograms: dict = field(default_factory=dict)

    def counter(self, name: str, help: str = "") -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name, help)
        return c

    def gauge(self, name: str, help: str = "") -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name, help)
        return g

    def histogram(self, name: str, help: str = "",
                  bounds: tuple | None = None) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = Histogram(name, help) if bounds is None \
                else Histogram(name, help, bounds=tuple(bounds))
            self.histograms[name] = h
        return h

    def clear(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able snapshot: counters/gauges by label string, histograms
        as {n, mean, p50, p95, p99} summaries per label set."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, c in sorted(self.counters.items()):
            out["counters"][name] = {_label_str(k) or "_": _number(v)
                                     for k, v in sorted(c.values.items())}
        for name, g in sorted(self.gauges.items()):
            out["gauges"][name] = {_label_str(k) or "_": v
                                   for k, v in sorted(g.values.items())}
        for name, h in sorted(self.histograms.items()):
            out["histograms"][name] = {
                _label_str(k) or "_": h.summary(**dict(k))
                for k in sorted(h.series)}
        return out

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (counters/gauges plus histogram
        _bucket/_sum/_count series with cumulative ``le`` labels)."""
        lines = []
        for name, c in sorted(self.counters.items()):
            if c.help:
                lines.append(f"# HELP {name} {c.help}")
            lines.append(f"# TYPE {name} counter")
            for k, v in sorted(c.values.items()):
                lines.append(f"{name}{_label_str(k)} {_number(v)}")
        for name, g in sorted(self.gauges.items()):
            if g.help:
                lines.append(f"# HELP {name} {g.help}")
            lines.append(f"# TYPE {name} gauge")
            for k, v in sorted(g.values.items()):
                lines.append(f"{name}{_label_str(k)} {v}")
        for name, h in sorted(self.histograms.items()):
            if h.help:
                lines.append(f"# HELP {name} {h.help}")
            lines.append(f"# TYPE {name} histogram")
            for k in sorted(h.series):
                counts, tot, n = h.series[k]
                cum = 0
                for b, c in zip(h.bounds, counts):
                    cum += c
                    lk = list(k) + [("le", repr(float(b)))]
                    lines.append(f"{name}_bucket{_label_str(tuple(lk))} "
                                 f"{cum}")
                lk = list(k) + [("le", "+Inf")]
                lines.append(f"{name}_bucket{_label_str(tuple(lk))} {n}")
                lines.append(f"{name}_sum{_label_str(k)} {tot}")
                lines.append(f"{name}_count{_label_str(k)} {n}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# the process-wide registry (None = metrics off, the default)
# ---------------------------------------------------------------------------
_REGISTRY: MetricsRegistry | None = None


def get_registry() -> MetricsRegistry | None:
    return _REGISTRY


def set_registry(reg: MetricsRegistry | None) -> MetricsRegistry | None:
    """Install (or clear, with None) the process-wide registry; returns
    the previous one so callers can restore it."""
    global _REGISTRY
    prev, _REGISTRY = _REGISTRY, reg
    return prev
