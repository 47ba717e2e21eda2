"""One run of one cell: set-up, the measured window, the traced batch, the
check against the reference, the metrics.

Everything a cell is made of is found by name under ``xrbench/``:
``workloads/<cell>.json`` (its configuration, traffic mix and check
parameters), ``configs/<config>.json`` (the model's sizes and family),
``traffic/<mix>.json`` (the mix's parameters and its generator),
``generators/<generator>.py``, ``reference/<family>.py`` (the plain
reference and the weights' layout), ``adapters/<family>.py`` (the
configuration as the program's ``ArchConfig``, and the model FLOPs) and
``metrics/<metric>.py`` (one reader a metric).  ``BENCHMARK.json`` at the
root says which metrics a cell reports and their units.

A reader's ``read(run)`` gets the whole run and returns a number, or None
where it finds nothing to read: ``batches`` (the window's batch records),
``window_s``, ``setup_s``, ``peak_bytes``, ``workload``, ``conf``,
``traffic``, the cell's ``adapter`` and ``generator`` modules, and
``profile``: ``trace.profile``'s record of the traced batch (the
profiler's events, the program's spans, counters and launches), None in
an untraced run.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

from xrbench import check, weights

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the harness's folder, imported
    from its file (as ``xrbench.<kind>.<name>``)."""
    path = (HERE / kind / f"{name}.py").resolve()
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    key = f"xrbench.{kind}.{name}"
    mod = sys.modules.get(key)
    if mod is None or Path(mod.__file__).resolve() != path:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def family(conf: dict) -> tuple:
    """(reference module, adapter module) of the configuration's family."""
    return (module("reference", conf["family"]),
            module("adapters", conf["family"]))


def generator(traffic: dict):
    return module("generators", traffic["generator"])


def reader(metric: str):
    return module("metrics", metric).read


def cell_metrics(bench: dict, cell: str, traced: bool) -> list:
    """(name, unit) of the metrics ``cell`` reports: its end-to-end ones
    untraced, its per-layer ones traced."""
    rows = bench["per_layer" if traced else "end_to_end"]
    return [(m["name"], m["unit"]) for m in rows
            if cell in m.get("workloads", [cell])]


def forbidden_modules(modules) -> list:
    """Top-level names of ``modules`` (the part before the first dot,
    compared whole) that are JAX or the JAX package."""
    tops = {name.split(".", 1)[0] for name in modules}
    return sorted(t for t in tops if t in FORBIDDEN)


def check_layout(lay: dict, specs: dict) -> None:
    """The drawn tree has the program's parameter names, shapes and
    dtypes."""
    want = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, path + (i,))
        else:
            want[path] = (tuple(tree.shape), tree.dtype)

    walk(specs, ())
    have = {p: (lf.shape, weights.DTYPES[lf.dtype])
            for p, lf in weights.leaves(lay["top"])}
    for i, g in enumerate(lay["layers"]):
        have.update({("layers", i) + p: (lf.shape, weights.DTYPES[lf.dtype])
                     for p, lf in weights.leaves(g)})
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()), key=str)[:8]
        raise RuntimeError(f"the weights' layout differs from the program's "
                           f"parameters: {diff}")


def _free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run_cell(cell: str, seed: int, seconds: float, traced: bool, *,
             device="cuda", t_start: float | None = None,
             workload: dict | None = None, conf: dict | None = None,
             traffic: dict | None = None, metrics: list | None = None,
             log=None) -> dict:
    """The result line's object for one run.  ``workload``, ``conf``,
    ``traffic`` and ``metrics`` replace what is found by name (tests run
    smoke sizes this way); ``log(text)`` takes progress lines."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda text: print(text, file=sys.stderr, flush=True))
    dev = torch.device(device)
    wl = workload or load("workloads", cell)
    conf = conf or load("configs", wl["config"])
    traffic = traffic or load("traffic", wl["traffic"])
    metrics = metrics or cell_metrics(benchmark(), cell, traced)
    ref, adapter = family(conf)
    gen = generator(traffic)

    from repro_torch.models.api import model_api
    from repro_torch.models.lm import LM

    cfg = adapter.arch_config(conf, torch)
    api = model_api(cfg)
    lay = ref.layout(conf)
    check_layout(lay, api.param_specs())
    vocab = conf["vocab_size"]
    model = LM(cfg, weights.draw_model(lay, seed, dev), device=dev)
    gen.run_batch(api, model, traffic, seed, -1, vocab, dev)     # warm-up
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    log(f"xrbench: set-up {setup_s:.3f} s; window of {seconds} s")

    batches, window_s = gen.window(api, model, traffic, seed, seconds,
                                   vocab, dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    log(f"xrbench: {len(batches)} batches in {window_s:.3f} s")
    prof = None
    if traced:
        from xrbench import trace

        def traced_batch():
            gen.run_batch(api, model, traffic, seed, -2, vocab, dev)

        prof = trace.profile(traced_batch, ROOT / "build" / "xrbench")
        log(f"xrbench: traced batch reduced in {prof['reduce_s']:.1f} s")
    del model
    _free(dev)

    # the check, once the window has closed and the program is freed
    t0 = time.perf_counter()
    pick = check.sample(len(batches), wl["check"]["batches"], seed)
    seqs = [gen.served_sequences(traffic, seed, batches[i], vocab, dev)
            for i in pick]
    logits = ref.served_logits(conf, seed, seqs, traffic["prompt"], dev)
    gaps = [check.served_gaps(lg, batches[i]["served"])
            for lg, i in zip(logits["f32"], pick)]
    limits = wl["check"]["limits"]
    flash = adapter.flash_calls(conf, traffic["batch"], traffic["prompt"])
    # the plain attention serves CPU tensors: no flash launch there
    flash_want = len(flash) if dev.type == "cuda" else 0
    comp = check.compared(
        check.gap_stats(gaps), limits,
        sum(not b["finite"] for b in batches),
        max(abs(b["flash_launches"] - flash_want) for b in batches))
    failed = sum(int((g.amax(-1) > limits["widest_gap"]).sum())
                 for g in gaps)
    log(f"xrbench: checked {len(pick)} batches ({sum(s.shape[0] for s in seqs)}"
        f" requests) in {time.perf_counter() - t0:.1f} s")
    del logits, seqs
    _free(dev)

    run = {"batches": batches, "window_s": window_s, "setup_s": setup_s,
           "peak_bytes": peak, "workload": wl, "conf": conf,
           "traffic": traffic, "adapter": adapter, "generator": gen,
           "profile": prof}
    values = {}
    for name, unit in metrics:
        v = reader(name)(run)
        if v is not None:
            values[name] = {"value": v, "unit": unit}
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    result = {"correct": check.passes(comp),
              "attempted": sum(b["served"].shape[0] for b in batches),
              "failed": failed, "metrics": values,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": kind, "count": 1,
                         "memory_peak_bytes": peak}}
    if prof is not None:
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["compared"] = comp
    return result
