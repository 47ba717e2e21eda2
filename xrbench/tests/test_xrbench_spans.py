"""The span and counter readers (``xrbench/spans.py``, ``metrics/``) against
a hand-built profile, and the counter readers on a CPU smoke run."""
import pytest

from xrbench import core, spans, trace
from xrbench.tests import smoke


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": float(ts),
         "dur": float(dur)}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _ua(name, ts, dur):
    return _x("user_annotation", name, ts, dur)


def _launch(ts, corr, name="cudaLaunchKernel", cat="cuda_runtime"):
    return _x(cat, name, ts, 1, corr)


EVENTS = [
    _ua("xrbench.window", 0, 1000),
    _ua("xrbench.prefill", 0, 400),
    _ua("mamba.scan", 10, 90),              # [10, 100]
    _ua("mamba.scan", 20, 30),              # nested: counted once
    _launch(15, 1), _launch(25, 2),
    _launch(60, 4, "cuLaunchKernelEx", "cuda_driver"),
    _launch(150, 3),                        # outside every range
    _ua("moe.dispatch", 110, 10), _launch(112, 5),
    _ua("moe.experts", 120, 10), _launch(122, 6),
    _ua("moe.combine", 130, 10), _launch(132, 7, "cudaMemsetAsync"),
    _x("kernel", "scan_a", 200, 30, 1),
    _x("kernel", "scan_b", 220, 30, 2),     # overlaps scan_a: union 50
    _x("kernel", "other", 260, 40, 3),
    _x("kernel", "triton_scan", 300, 10, 4),
    _x("kernel", "route", 320, 5, 5),
    _x("kernel", "bmm", 330, 20, 6),
    _x("gpu_memset", "Memset (Device)", 355, 5, 7),
    _ua("xrbench.decode", 400, 600),
    _ua("lm.decode_step", 400, 100),
    _launch(410, 10),
    _x("cuda_runtime", "cudaMemcpyAsync", 450, 6, 11),
    _x("cuda_runtime", "cudaStreamSynchronize", 461, 3, None),
    _x("cuda_runtime", "cudaMemcpyAsync", 470, 2, 12),
    _x("kernel", "step_a", 420, 30, 10),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 455, 5, 11),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 471, 2, 12),
    _launch(550, 30),                       # between the steps
    _x("kernel", "greedy", 560, 100, 30),
    _ua("lm.decode_step", 600, 80),
    _launch(610, 20),
    _x("cuda_runtime", "cudaStreamSynchronize", 650, 3, None),
    _x("kernel", "step_b", 620, 10, 20),
]


def _run(events=EVENTS, counters=None):
    prof = trace.digest(events)
    prof["counters"] = {"counters": counters or {}}
    return {"profile": prof}


def test_device_time_launched_inside_the_spans():
    run = _run()
    # scan: [200, 250] + [300, 310]; the launch at 150 is outside
    assert core.reader("scan_device_ms")(run) == pytest.approx(0.060)
    assert core.reader("moe_device_ms")(run) == pytest.approx(0.030)
    assert core.reader("moe_dispatch_device_ms")(run) == pytest.approx(
        0.010)
    # steps: 30 + 5 + 2 and 10; the kernel launched between them is not
    assert core.reader("decode_device_ms")(run) == pytest.approx(
        (0.037 + 0.010) / 2)


def test_decode_host_time_and_waits():
    run = _run()
    assert core.reader("decode_host_ms")(run) == pytest.approx(0.090)
    # step 1: the DtoH copy and the synchronize (not the HtoD copy);
    # step 2: the synchronize
    assert spans.waits(run["profile"], "lm.decode_step",
                       spans.DECODE) == [2, 1]
    assert core.reader("decode_host_syncs")(run) == pytest.approx(1.5)


def test_nested_same_name_ranges_count_a_kernel_once():
    prof = _run()["profile"]
    r = spans.ranges(prof, ("mamba.scan",), spans.PREFILL)
    assert r == [[10.0, 100.0]]
    calls = spans.calls_in(prof, r)[0]
    assert sorted(c["args"]["correlation"] for c in calls) == [1, 2, 4]


SPAN_METRICS = ("scan_device_ms", "moe_device_ms", "moe_dispatch_device_ms",
                "decode_device_ms", "decode_host_ms", "decode_host_syncs")
COUNTER_METRICS = ("moe_slot_use", "moe_dropped_pct")


def test_none_where_the_spans_or_counters_are_missing():
    bare = [e for e in EVENTS if e["cat"] != "user_annotation"
            or e["name"].startswith("xrbench.")]
    for name in SPAN_METRICS + COUNTER_METRICS:
        assert core.reader(name)(_run(bare)) is None, name
        assert core.reader(name)({"profile": None}) is None, name
    # ranges but no runtime call (the CPU): no device time, no waits
    host = [e for e in EVENTS if e["cat"] == "user_annotation"]
    for name in SPAN_METRICS:
        v = core.reader(name)(_run(host))
        assert (v is not None) == (name == "decode_host_ms"), name


def test_counter_readers_by_hand_counts():
    counters = {"moe_copies_total": {'{phase="prefill"}': 200,
                                     '{phase="decode"}': 8},
                "moe_expert_rows_total": {'{phase="prefill"}': 320,
                                          '{phase="decode"}': 128},
                "moe_copies_kept_total": {'{phase="prefill"}': 190,
                                          '{phase="decode"}': 8}}
    run = _run(counters=counters)
    assert core.reader("moe_slot_use")(run) == pytest.approx(6.25)
    assert core.reader("moe_dropped_pct")(run) == pytest.approx(5.0)
    counters.pop("moe_copies_kept_total")
    for name in COUNTER_METRICS:
        assert core.reader(name)(_run(counters=counters)) is None


def test_cpu_smoke_run_reports_the_counter_metrics():
    """The harness on the jamba smoke configuration, traced on the CPU: the
    counter metrics and the decode step's host time are reported; the
    device-time readers find no launch there and leave theirs out."""
    conf = smoke.jamba()
    metrics = [(n, "x") for n in SPAN_METRICS + COUNTER_METRICS]
    out = core.run_cell(
        "smoke", 2 ** 31 + 5, 0.2, True, device="cpu",
        workload=smoke.workload(conf["name"], "smoke", smoke.loose()),
        conf=conf, traffic=smoke.traffic(), metrics=metrics,
        log=lambda text: None)["metrics"]
    assert set(out) == {"moe_slot_use", "moe_dropped_pct",
                        "decode_host_ms"}
    # decode at batch 2: 4 copies into 4 experts x 8 rows
    assert out["moe_slot_use"]["value"] == pytest.approx(100 * 4 / 32)
    assert 0.0 <= out["moe_dropped_pct"]["value"] < 100.0
    assert out["decode_host_ms"]["value"] > 0
