"""The harness finds its parts by name, guards its imports and prints the
contract's result line; run at smoke sizes on the CPU."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from xrbench import check, core, costs, trace, weights
from xrbench.tests import smoke

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def smoke_run(conf, traced=False, metrics=None, seed=3, **kw):
    return core.run_cell(
        "smoke", seed, 0.2, traced, device="cpu",
        workload=smoke.workload(conf["name"], "smoke", smoke.loose()), conf=conf,
        traffic=smoke.traffic(**kw), metrics=metrics or [],
        log=lambda text: None)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = core.load("workloads", cell)
    assert (wl["config"], wl["traffic"]) == (entry["config"],
                                             entry["traffic"])
    conf = core.load("configs", wl["config"])
    assert conf["name"] == wl["config"]
    cfg_entry = next(c for c in BENCH["configs"] if c["name"] == conf["name"])
    assert cfg_entry["file"] == f"xrbench/configs/{conf['name']}.json"
    ref, adapter = core.family(conf)
    assert callable(ref.served_logits) and callable(adapter.arch_config)
    traffic = core.load("traffic", wl["traffic"])
    assert callable(core.generator(traffic).window)
    for traced in (False, True):
        for name, _ in core.cell_metrics(BENCH, cell, traced):
            assert callable(core.reader(name))
    assert wl["check"]["batches"] >= 1
    assert set(wl["check"]["limits"]) >= {"widest_gap"}
    assert all(v > 0 for v in wl["check"]["limits"].values())


def test_missing_part_is_named():
    with pytest.raises(FileNotFoundError, match="no_such_mix"):
        core.load("traffic", "no_such_mix")


def test_new_cell_needs_only_new_files(tmp_path, monkeypatch):
    """A cell added as new data files (configuration, mix, workload) runs
    without an edit to any file already there."""
    here = tmp_path / "xrbench"
    shutil.copytree(core.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    conf = smoke.jamba()
    conf["name"] = "jamba-smoke-new"
    (here / "configs" / "jamba-smoke-new.json").write_text(json.dumps(conf))
    (here / "traffic" / "tiny_new.json").write_text(
        json.dumps(smoke.traffic(batch=2, prompt=12, new_tokens=3)))
    (here / "workloads" / "jamba-smoke-new.tiny_new.json").write_text(
        json.dumps(smoke.workload("jamba-smoke-new", "tiny_new", smoke.loose(),
                                  1)))
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "jamba-smoke-new.tiny_new", "config": "jamba-smoke-new",
         "traffic": "tiny_new", "chips": 1, "why": "test"}])
    monkeypatch.setattr(core, "HERE", here)
    out = core.run_cell("jamba-smoke-new.tiny_new", 5, 0.1, False,
                        device="cpu", log=lambda text: None,
                        metrics=core.cell_metrics(
                            bench, "jamba-smoke-new.tiny_new", False))
    assert out["correct"] and out["attempted"] >= 2
    assert set(out["metrics"]) == {"tokens_per_s", "peak_mem_gb", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_import_guard_compares_top_level_names_whole():
    mods = ["jax.numpy", "repro_torch.models.lm", "reprox", "repro.core.store",
            "flax.linen", "jaxtyping", "xrbench.core", "jaxlib"]
    assert core.forbidden_modules(mods) == ["flax", "jax", "jaxlib", "repro"]
    assert core.forbidden_modules(["repro_torch", "jaxtyping", "torch"]) == []


def _python(code: str, cwd=ROOT, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_harness_and_port_load_no_jax():
    """What a run imports (the harness, the references, the port's model
    path) loads neither JAX nor the JAX package; the references load
    nothing of the port."""
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "import xrbench.reference.jamba, xrbench.reference.rwkv6\n"
        "import xrbench.check, xrbench.weights, xrbench.costs\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('repro_torch', 'repro', 'jax')], 'reference imports the program'\n"
        "import xrbench.core, xrbench.trace, xrbench.adapters.jamba\n"
        "import xrbench.adapters.rwkv6, xrbench.generators.offline_batches\n"
        "import repro_torch.models.api, repro_torch.models.lm\n"
        "import repro_torch.kernels.ops, repro_torch.obs.trace\n"
        "import repro_torch.obs.metrics\n"
        "print(xrbench.core.forbidden_modules(list(sys.modules)))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cli_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "xrbench/run.py", "--workload",
                          CELLS[0], "--seed", "2147483659", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    assert out.returncode != 0 and out.stdout == ""


def test_cli_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "xrbench", tmp_path / "xrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "xrbench/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "program" in out.stderr


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    """Exactly the contract's keys, in order: ``breakdown`` when traced,
    and ``compared`` (each number compared with its limit) last."""
    per_layer = [("prefill_ms", "ms"), ("decode_step_ms", "ms"),
                 ("aten_ops_per_prefill", "ops"), ("device_idle", "%"),
                 ("step_mfu", "%"), ("flash_fwd_roofline", "%")]
    e2e = [("tokens_per_s", "tokens/s"), ("peak_mem_gb", "GB"),
           ("setup_s", "s")]
    out = smoke_run(smoke.jamba(), traced, per_layer if traced else e2e)
    keys = LINE_KEYS + (["breakdown"] if traced else []) + ["compared"]
    assert list(out) == keys
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(out)
    if traced:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert out["metrics"]["aten_ops_per_prefill"]["value"] > 0
        # no flash kernel runs on the CPU: its roofline is left out
        assert "flash_fwd_roofline" not in out["metrics"]
    else:
        assert set(out["metrics"]) == {n for n, _ in e2e}
    for c in out["compared"].values():
        assert set(c) == {"value", "limit"}


TRACE_EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "xrbench.window",
     "ts": 0.0, "dur": 100.0},
    {"ph": "X", "cat": "user_annotation", "name": "xrbench.prefill",
     "ts": 0.0, "dur": 50.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1.0, "dur": 2.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 10.0, "dur": 2.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 60.0,
     "dur": 30.0},
    {"ph": "X", "cat": "kernel", "name": "flash_wgmma_kernel<128, 128>",
     "ts": 5.0, "dur": 20.0},
    {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 15.0, "dur": 20.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 90.0,
     "dur": 20.0},
]


def test_trace_digest_hand_counts():
    d = trace.digest(TRACE_EVENTS)
    assert d["window_s"] == pytest.approx(100e-6)
    assert d["busy_s"] == pytest.approx(40e-6)          # [5, 35] + [90, 100]
    assert len(d["events"]) == len(TRACE_EVENTS)
    assert len(trace.device_events(d)) == 3
    assert [e["name"] for e in trace.host_ops(d, "xrbench.prefill")] == [
        "aten::mm", "aten::add"]
    assert trace.host_ops(d, "no.such.range") is None
    assert {n for n, _ in d["device_ops"]} == {
        "flash_wgmma_kernel<128, 128>", "gemm", "Memcpy DtoH"}
    gaps = dict(d["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(55e-6)   # [35, 90]
    assert gaps["aten::mm"] == pytest.approx(5e-6)      # [0, 5]


def test_readers_reduce_the_trace_by_hand_counts():
    """Each trace reader reduces the kept events itself: the aten ops of
    the prefill range, the flash kernels' time against the frozen count,
    the idle share."""
    conf = smoke.jamba()
    _, adapter = core.family(conf)
    traffic = smoke.traffic(batch=2, prompt=16)
    run = {"profile": trace.digest(TRACE_EVENTS), "conf": conf,
           "traffic": traffic, "adapter": adapter}
    assert core.reader("aten_ops_per_prefill")(run) == 2
    assert core.reader("device_idle")(run) == pytest.approx(60.0)
    calls = adapter.flash_calls(conf, 2, 16)    # one attention layer
    assert len(calls) == 1
    assert core.reader("flash_fwd_roofline")(run) == pytest.approx(
        costs.roofline_share(*costs.flash_fwd_cost(*calls[0]), 20e-6))
    run["traffic"] = smoke.traffic(batch=2, prompt=16)
    run["conf"] = dict(conf, num_hidden_layers=16)  # two: one launch short
    assert core.reader("flash_fwd_roofline")(run) is None
    run["profile"] = None
    for name in ("aten_ops_per_prefill", "device_idle", "flash_fwd_roofline"):
        assert core.reader(name)(run) is None


SPAN_READER = '''"""Time inside the program's "mamba.scan" spans over the traced batch."""


def read(run):
    prof = run["profile"]
    spans = [] if prof is None else [
        e for e in prof["spans"] if e["name"] == "mamba.scan"]
    return sum(e["dur"] for e in spans) / 1e3 if spans else None
'''

COUNTER_READER = '''"""Chunk loops the program's "mamba.chunks" counter counts."""


def read(run):
    prof = run["profile"]
    if prof is None:
        return None
    c = prof["counters"]["counters"].get("mamba.chunks")
    return None if c is None else sum(c.values())
'''


def test_new_metric_needs_only_new_files(tmp_path, monkeypatch):
    """A per-layer metric added as one reader file reads a span and a
    counter the program emits in the traced batch, with no edit to any file
    already there."""
    from repro_torch.models import mamba
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace

    here = tmp_path / "xrbench"
    shutil.copytree(core.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    (here / "metrics" / "mamba_scan_ms.py").write_text(SPAN_READER)
    (here / "metrics" / "mamba_chunks.py").write_text(COUNTER_READER)
    scan = mamba._scan

    def spanned_scan(*a, **kw):     # what a tracing change would add
        reg = obs_metrics.get_registry()
        if reg is not None:
            reg.counter("mamba.chunks").inc()
        with obs_trace.span("mamba.scan"):
            return scan(*a, **kw)

    monkeypatch.setattr(mamba, "_scan", spanned_scan)
    monkeypatch.setattr(core, "HERE", here)
    metrics = [("mamba_scan_ms", "ms"), ("mamba_chunks", "calls")]
    out = smoke_run(smoke.jamba(), True, metrics)
    assert out["metrics"]["mamba_scan_ms"]["value"] > 0
    assert out["metrics"]["mamba_chunks"]["value"] > 0
    assert smoke_run(smoke.jamba(), False, metrics)["metrics"] == {}
    assert obs_trace.get_tracer() is None
    assert obs_metrics.get_registry() is None
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_weights_redraw_one_group_alone():
    lay = core.family(smoke.rwkv6())[0].layout(smoke.rwkv6())
    full = weights.draw_model(lay, 2 ** 31 + 11, "cpu")
    alone = weights.draw_group(lay["layers"][2], 2 ** 31 + 11, 2, "cpu")
    for path, _ in weights.leaves(lay["layers"][2]):
        a, b = full["layers"][2], alone
        for k in path:
            a, b = a[k], b[k]
        assert torch.equal(a, b)
    other = weights.draw_group(lay["layers"][2], 12, 2, "cpu")
    assert not torch.equal(other["mixer"]["wr"], alone["mixer"]["wr"])


def test_sample_is_drawn_from_the_seed():
    assert check.sample(3, 5, 1) == [0, 1, 2]
    a, b = check.sample(20, 3, 7), check.sample(20, 3, 7)
    assert a == b and len(set(a)) == 3
    assert any(check.sample(20, 3, s) != a for s in range(8, 20))
