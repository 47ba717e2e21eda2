"""Unified observability for the port: span tracing, metrics, BENCH
trajectories (port of ``repro.obs``).

* ``obs.trace``     — near-zero-overhead span tracer (context manager +
                      decorator, nested spans, optional CUDA fencing) with
                      Chrome/Perfetto trace-event JSON export.
* ``obs.metrics``   — process-wide registry of counters / gauges /
                      fixed-bucket histograms with deterministic
                      percentile math and Prometheus-text / JSON export.
* ``obs.trajectory``— git-sha-stamped BENCH run history
                      (``BENCH_history/<suite>.jsonl``).

Wall-clock only ever flows INTO spans/metrics, never back into the values
the instrumented code computes, so observing never perturbs a replay.
"""
from repro_torch.obs.metrics import (Histogram, MetricsRegistry,
                                     get_registry, set_registry)
from repro_torch.obs.trace import (Tracer, get_tracer, set_tracer, span,
                                   traced)

__all__ = ["Histogram", "MetricsRegistry", "get_registry", "set_registry",
           "Tracer", "get_tracer", "set_tracer", "span", "traced"]
