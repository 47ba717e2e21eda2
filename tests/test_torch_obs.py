"""The port's observability package (``repro_torch.obs``) against the rules
of ``tests/test_obs.py`` and against ``repro.obs`` itself.

Percentiles and exports must equal the reference's bit for bit on the same
samples; a Chrome trace round-trips; a disabled span is a shared no-op; a
fenced span waits only on CUDA tensors; the trajectory file keeps the
reference's format; and observing a fleet run never perturbs it.  The
port's modules record only into the port's registry.
"""
import json

import numpy as np
import pytest
import torch

from repro.obs import metrics as jmetrics
from repro.obs import trajectory as jtraj

from repro_torch.core.knobs import Knobs
from repro_torch.core.runtime import ClientSession, DeviceClient, NetworkModel
from repro_torch.core.store import synthetic_store
from repro_torch.obs import (Histogram, MetricsRegistry, Tracer, get_registry,
                             get_tracer, set_registry, set_tracer, span,
                             traced)
from repro_torch.obs import trace as ttrace
from repro_torch.obs.metrics import exact_percentiles
from repro_torch.obs.trajectory import append_run, latest_run, load_history
from repro_torch.server import FleetServer, ZoneGrid


@pytest.fixture
def obs():
    """Install a fresh port tracer + registry; restore whatever was there."""
    tr, reg = Tracer(), MetricsRegistry()
    prev_tr, prev_reg = set_tracer(tr), set_registry(reg)
    yield tr, reg
    set_tracer(prev_tr), set_registry(prev_reg)


# ------------------------------------------------------- percentile math
@pytest.mark.parametrize("n", [0, 1, 2, 7, 100, 1001])
def test_exact_percentiles_bit_identical_to_reference(n):
    xs = np.random.default_rng(n).lognormal(size=n).tolist()
    ps = (1, 50, 90, 95, 99, 100)
    got = exact_percentiles(xs, ps)
    want = jmetrics.exact_percentiles(xs, ps)
    assert got == want
    assert json.dumps(got) == json.dumps(want)
    if n:
        assert all(got[f"p{p}"] in xs for p in ps)   # an observed sample


def test_exact_percentiles_empty_single_and_nearest_rank():
    assert exact_percentiles([]) == {"n": 0, "p50": 0.0, "p95": 0.0,
                                     "p99": 0.0, "mean": 0.0, "max": 0.0}
    s = exact_percentiles([7.5])
    assert s["p50"] == s["p95"] == s["p99"] == s["max"] == 7.5
    p = exact_percentiles(list(range(1, 101)))
    assert (p["p50"], p["p95"], p["p99"]) == (50, 95, 99)
    p = exact_percentiles([1.0, 2.0])
    assert p["p50"] == 1.0 and p["p99"] == 2.0


def test_histogram_percentiles_bit_identical_and_order_free():
    samples = np.random.default_rng(3).lognormal(sigma=2.0,
                                                 size=500).tolist()
    mine, ref = Histogram("t"), jmetrics.Histogram("t")
    back = Histogram("t")
    for v in samples:
        mine.observe(v)
        ref.observe(v)
    for v in reversed(samples):
        back.observe(v)
    assert mine.bounds == ref.bounds == jmetrics.default_latency_buckets()
    for p in (1, 50, 95, 99, 100):
        assert mine.percentile(p) == ref.percentile(p) == back.percentile(p)
    assert mine.summary() == ref.summary()


def test_histogram_edges_and_label_series():
    h = Histogram("t", bounds=(1.0, 10.0, 100.0))
    assert h.percentile(50) == 0.0            # empty series
    h.observe(5.0)
    assert h.percentile(50) == h.percentile(99) == 10.0
    h.observe(500.0)                          # overflow bucket
    assert h.percentile(99) == float("inf") and h.count() == 2
    g = Histogram("g", bounds=(1.0, 10.0))
    g.observe(0.5, stage="lift")
    g.observe(5.0, stage="embed")
    assert g.percentile(50, stage="lift") == 1.0
    assert g.percentile(50, stage="embed") == 10.0
    assert g.count() == 0                     # unlabeled series untouched


def _fill(reg):
    reg.counter("bytes_total", "sent bytes").inc(100, client=0)
    reg.counter("bytes_total").inc(50, client=1)
    reg.gauge("live_objects").set(42)
    h = reg.histogram("lat_ms", bounds=(1.0, 10.0))
    h.observe(0.5), h.observe(20.0)
    reg.histogram("tick_ms").observe(3.25, C=8)
    return reg


def test_registry_exports_equal_reference(tmp_path):
    reg, ref = _fill(MetricsRegistry()), _fill(jmetrics.MetricsRegistry())
    snap = reg.snapshot()
    assert snap == ref.snapshot()
    assert snap["counters"]["bytes_total"] == {'{client="0"}': 100,
                                               '{client="1"}': 50}
    prom = reg.to_prometheus()
    assert prom == ref.to_prometheus()
    assert 'lat_ms_bucket{le="+Inf"} 2' in prom and "lat_ms_count 2" in prom
    p = tmp_path / "m.json"
    reg.save(p)
    assert json.loads(p.read_text()) == snap


# -------------------------------------------------------- trace round-trip
def test_chrome_trace_round_trip(tmp_path):
    tr = Tracer()
    with tr.span("outer", cat="engine", tick=3):
        with tr.span("inner", cat="query"):
            pass
        with tr.span("inner2", cat="sync") as sp:
            sp.set(zone=1)
    p = tmp_path / "trace.json"
    tr.save(p)
    evs = json.loads(p.read_text())["traceEvents"]
    assert len(evs) == 3 and all(e["ph"] == "X" for e in evs)
    by = {e["name"]: e for e in evs}
    o = by["outer"]
    for name in ("inner", "inner2"):
        c = by[name]
        assert o["ts"] <= c["ts"]
        assert c["ts"] + c["dur"] <= o["ts"] + o["dur"] + 1e-6
        assert c["args"]["depth"] == o["args"]["depth"] + 1
    assert by["outer"]["args"]["tick"] == 3
    assert by["inner2"]["args"]["zone"] == 1
    assert len(tr.durations_ms("inner")) == 1


def test_span_disabled_path_is_noop():
    prev = set_tracer(None)
    try:
        sp = span("x")
        with sp as s:
            assert s.fence(123) == 123        # fence passes through
        assert span("y") is sp                # shared singleton
        assert get_tracer() is None
    finally:
        set_tracer(prev)


def test_fenced_span_waits_only_on_cuda_tensors(monkeypatch):
    """A fenced span on torch tensors (nested in tuples, lists, dicts)
    synchronises the CUDA devices among them and nothing else: on CPU
    tensors the fence is a no-op."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: calls.append(dev))
    tr = Tracer(fenced=True)
    x = torch.arange(8) * 2
    with tr.span("dispatch", cat="test") as sp:
        assert sp.fence((x, [x + 1], {"a": x})) is not None
    assert len(tr) == 1 and tr.durations_ms("dispatch")[0] >= 0.0
    assert calls == []
    assert ttrace._cuda_devices((x, [x], {"k": x}), set()) == set()
    assert ttrace.block_until_ready(x) is x


def test_traced_decorator(obs):
    tr, _ = obs

    @traced("my.fn", cat="test")
    def f(x):
        return x + 1

    assert f(1) == 2
    assert tr.durations_ms("my.fn")


# ------------------------------------------------------------- trajectory
def test_trajectory_append_and_load_same_format(tmp_path):
    h, hj = tmp_path / "hist", tmp_path / "hist_ref"
    for mod, d in ((None, h), (jtraj, hj)):
        ap = append_run if mod is None else mod.append_run
        p1 = ap("s1", {"tick_ms": 1.0}, git_sha="abc", date="2026-08-08",
                history_dir=d)
        ap("s1", {"tick_ms": 2.0}, git_sha="def", date="2026-08-09",
           smoke=True, history_dir=d)
        assert p1 == d / "s1.jsonl"
    assert (h / "s1.jsonl").read_text() == (hj / "s1.jsonl").read_text()
    assert len(load_history("s1", history_dir=h)) == 2
    assert len(load_history("s1", history_dir=h, smoke=False)) == 1
    last = latest_run("s1", history_dir=h, smoke=True)
    assert last["git_sha"] == "def" and last["result"] == {"tick_ms": 2.0}
    assert latest_run("missing", history_dir=h) is None


# ---------------------------------------------- observing never perturbs
E = 16
KN = Knobs(server_capacity=64, client_capacity=64,
           max_object_points_server=32, max_object_points_client=8,
           min_obs_before_sync=1)


def _fleet_run():
    """A small fleet run: 3 clients over a 2x1 grid, two ticks of version
    bumps; returns every packet's bytes, seqs, ids and versions and the
    clients' maps."""
    fs = FleetServer(knobs=KN, embed_dim=E, n_clients=3,
                     grid=ZoneGrid.for_room(8.0, 2, 1), budget=8,
                     device="cpu")
    st = synthetic_store(20, 64, E, 32, seed=4, device="cpu")
    sess = [ClientSession(dev=DeviceClient(knobs=KN, embed_dim=E,
                                           device="cpu"),
                          net=NetworkModel(), knobs=KN, cid=c)
            for c in range(3)]
    for c, x in enumerate((-2.0, 2.0, 0.0)):
        fs.join(c, np.array([x, 1.0, 0.0], np.float32), 1.5)
    out = []
    for t in range(4):
        st.version[t:t + 3] += 1
        fs.refresh(st)
        pk = fs.tick(np.ones(3, bool), tick=t)
        for z, p in pk:
            out.append((z, p.nbytes.tolist(), p.seqs.tolist(),
                        p.batch.oid.tolist(), p.batch.version.tolist()))
            for c in range(3):
                sess[c].step(float(t), p.packet_for(c))
        fs.ack_tick(pk, tick=t)
    maps = [s.dev.local.ids.tolist() for s in sess]
    return out, maps


def test_fleet_run_unperturbed_by_observability(obs):
    tr, reg = obs
    on = _fleet_run()
    names = {e[0] for e in tr.events}
    assert {"fleet.tick", "session.collect_fleet", "client.step"} <= names
    assert reg.counter("fleet_sent_bytes_total").total() > 0
    assert reg.counter("client_down_bytes_total").total() > 0
    assert reg.counter("fleet_acks_total").total() > 0
    set_tracer(None), set_registry(None)
    assert _fleet_run() == on


def test_port_records_only_into_its_own_registry(obs):
    _, reg = obs
    ref = jmetrics.MetricsRegistry()
    prev = jmetrics.set_registry(ref)
    try:
        _fleet_run()
    finally:
        jmetrics.set_registry(prev)
    assert ref.snapshot() == {"counters": {}, "gauges": {},
                              "histograms": {}}
    assert get_registry() is reg and reg.snapshot()["counters"]
