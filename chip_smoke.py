#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, in parallel) and prints the build time;
2. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at edge shapes (budget > cap, ragged tiling,
   empty masks, k past the included count, all-equal scores, k = 1024):
   ints exactly, floats within 1e-4 (lift_compact) and 1e-5
   (query_topk_bias scores), and times kernel, plain version and, where
   one PyTorch call computes the same function, that call;
3. drives the single-client loop at the paper's deployment size (Knobs()
   defaults, E = 512, 720x1280 keyframes, 40 keyframes of an 80-object
   scene): MappingServer.process_frame, CloudService.update_tick ->
   DeviceClient.ingest every second keyframe, then an SQ and an LQ per
   mapped class, with every kernel launch counter reset just before and
   read just after;
4. profiles the loop: the server, cloud and client of step 3 take more
   keyframes, each followed by an update tick, the device-side ingest, an
   SQ and an LQ; half of them timed by stage on the host clock, half
   under ``torch.profiler`` (device-busy share, host syncs, top kernels);
5. runs 16 batched full_mix-style queries over a 10,000-object store and
   requires the same top-k as the CPU port, with the launch counters reset
   just before and read just after;
6. replays the first 6 keyframes of step 3 on the CPU port and requires
   the same store.

It imports nothing of JAX or of the JAX package, catches no failure, and
exits non-zero (printing no result) without a CUDA device or outside a
checkout of the repository.  The line before the last is the per-kernel
JSON record; the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data-sheet peaks (at the 700 W limit): HBM3 bandwidth and
# the fp32 rate outside the tensor cores (both kernels compute in fp32 FMA).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

LIFT_TOL = 1e-4          # metres: back-projection + pose in another order
SCORE_TOL = 1e-5         # unit-vector dot products in another order
CROSS_FRAMES = 6         # keyframes replayed on the CPU port (step 6)
PROFILE_KEYFRAMES = 4    # keyframes timed by stage, then as many profiled
# ops whose CPU side waits for the card: each is a host sync in the loop
SYNC_OPS = ("aten::item", "aten::_local_scalar_dense", "aten::nonzero",
            "cudaStreamSynchronize", "cudaDeviceSynchronize",
            "aten::masked_select")

# the paper's deployment: Knobs() defaults (Tab. 2), MobileCLIP's width,
# 720p keyframes every 5th frame, and the 10,000-object query claim
DEPLOYMENT = dict(embed_dim=512, h=720, w=1280, n_frames=200,
                  keyframe_interval=5, n_objects=80)
QUERY_STORE = dict(n=10_000, capacity=10_240, embed_dim=512, max_points=16)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(tag: str, obj) -> None:
    print(f"{tag} {json.dumps(obj)}", flush=True)


# ---------------------------------------------------------------- timing
class Clock:
    """Median CUDA-event time of single calls, each after a write of a
    buffer larger than the 50 MB L2, so every call starts with a cold
    cache as a query against a freshly touched map would.

    ``device`` mode queues a spin kernel ahead of the start event, so the
    host has enqueued the whole call before the card reaches it: the time
    is the card's alone (every kernel of the call and the gaps between
    them).  ``call`` mode omits the spin, so host work in the call that
    outlasts the cache flush is counted too, as a caller sees it."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
        self.spin = 1 << 22              # cycles: ~2 ms at the boost clock

    def _median(self, fn, reps: int, device: bool):
        torch = self.torch
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        ahead = True
        for a, b in ev:
            self.flush.zero_()
            if device:
                torch.cuda._sleep(self.spin)
            a.record()
            fn()
            b.record()
            ahead &= not a.query()       # the card had not started the call
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in ev), ahead

    def ms(self, fn, reps: int = 30) -> float:
        """The card's time for one call of ``fn``."""
        fn()
        self.torch.cuda.synchronize()
        for _ in range(4):
            t, ahead = self._median(fn, reps, device=True)
            if ahead:
                return t
            self.spin *= 4
        raise RuntimeError("chip_smoke: the host never got ahead of the card")

    def call_ms(self, fn, reps: int = 30) -> float:
        """One call of ``fn`` as its caller waits for it."""
        fn()
        self.torch.cuda.synchronize()
        return self._median(fn, reps, device=False)[0]


# ------------------------------------------------------------ step 2 inputs
def lift_inputs(torch, d, h, w, stride, seed, dev):
    """Depth with 25 % holes, D masks of mixed density (some objects under
    the point budget, some past the lift cap), one empty mask."""
    rng = np.random.default_rng(seed)
    depth = np.where(rng.random((h, w)) > 0.25,
                     rng.uniform(0.4, 6.0, (h, w)), 0.0).astype(np.float32)
    dens = rng.uniform(0.002, 0.6, size=(d, 1, 1))
    masks = rng.random((d, h, w)) < dens
    masks[d // 2] = False
    intr = np.array([0.9 * w * stride, 0.9 * w * stride, w * stride / 2,
                     h * stride / 2], np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = q
    pose[:3, 3] = rng.uniform(-2, 2, 3)
    return [torch.from_numpy(a).to(dev) for a in (depth, masks, intr, pose)]


def topk_inputs(torch, Q, N, E, seed, dev, *, frac=0.8, tie=False):
    """Unit-norm queries and rows (as the embedder makes them), a finite
    bias in [0, 0.2) on a ``frac`` share of the slots and NEG elsewhere."""
    rng = np.random.default_rng(seed)
    if tie:      # every included slot scores exactly E / 8
        qs = np.full((Q, E), 0.5, np.float32)
        emb = np.full((N, E), 0.25, np.float32)
    else:
        qs = rng.normal(size=(Q, E)).astype(np.float32)
        qs /= np.linalg.norm(qs, axis=1, keepdims=True)
        emb = rng.normal(size=(N, E)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    inc = rng.random((Q, N)) < frac
    bias = np.where(inc, 0.0 if tie else 0.2 * rng.random((Q, N)),
                    -1e30).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (qs, emb, bias)]


def lift_bytes(d, h, w, budget):
    """Each input read once, each output written once."""
    hw = h * w
    return hw * 4 + d * hw + 16 + 64 + d * budget * 12 + d * 4 + 3 * d * 12


def topk_cost(Q, N, E, k):
    """(bytes, fp32 flops) of one fused score + bias + top-k."""
    return (Q * E + N * E + Q * N) * 4 + Q * k * 8, 2 * Q * N * E + Q * N


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ step 2
def kernel_checks(torch, clock, dev):
    from repro_torch.kernels import lift_compact as lc
    from repro_torch.kernels import query_topk as qt

    # lift_compact: main path (32 detections at 144x256, stride 5, budget
    # 2000, cap 4096) and the edge shapes of tests/test_kernels.py
    lift_cases = [(32, 144, 256, 5, 2000, 4096), (4, 24, 32, 1, 64, 4096),
                  (8, 48, 64, 5, 512, 4096), (3, 20, 26, 2, 16, 32),
                  (6, 30, 40, 3, 100, 80)]
    for case in lift_cases:
        d, h, w, stride, budget, cap = case
        args = lift_inputs(torch, d, h, w, stride, sum(case), dev)
        kw = dict(stride=stride, budget=budget, lift_cap=cap)
        got = lc.lift_compact_cuda(*args, **kw)
        want = lc.lift_compact_plain(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got[1], want[1]), f"lift_compact n at {case}")
        err = max(float((g - x).abs().max()) for g, x in
                  zip(got, want) if g.is_floating_point())
        check(err <= LIFT_TOL, f"lift_compact err {err} at {case}")
        check(int(got[1][d // 2]) == 0 and not got[0][d // 2].any(),
              f"lift_compact empty mask at {case}")
        emit("lift_compact_check", {"shape": case, "max_abs_err": err})
        if case == lift_cases[0]:
            kernel = lambda: lc.lift_compact_cuda(*args, **kw)  # noqa
            b_ms, b_by = bound(lift_bytes(d, h, w, budget), 0)
            lift_row = {
                "ms": clock.ms(kernel), "call_ms": clock.call_ms(kernel),
                "plain_ms": clock.ms(lambda: lc.lift_compact_plain(*args,
                                                                   **kw)),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "max_abs_err": err,
                "shape": f"D={d} H={h} W={w} stride={stride} "
                         f"budget={budget} cap={cap}"}
            emit("lift_compact_time", lift_row)

    # query_topk_bias: SQ (N = 4096), LQ (N = 512) and the batched query
    # phase (Q = 16, N = 10240 slots) at E = 512, k = 5, the SQ shape
    # being the one the kernel record reports; then k past the
    # included count, all-equal scores, k = 1024, a ragged N, more queries
    # than one block holds, and an E that takes the scalar-load path
    topk_cases = [((16, 10240, 512, 5), {}), ((1, 4096, 512, 5), {}),
                  ((1, 512, 512, 5), {}), ((2, 700, 64, 40), {"frac": 0.03}),
                  ((4, 700, 64, 20), {"tie": True}),
                  ((2, 3000, 64, 1024), {}), ((3, 1000, 96, 100), {}),
                  ((37, 2000, 128, 9), {}), ((2, 900, 50, 7), {})]
    timed = {}
    for (Q, N, E, k), kind in topk_cases:
        args = topk_inputs(torch, Q, N, E, Q * N + E + k, dev, **kind)
        gv, gi = qt.query_topk_bias_cuda(*args, k)
        wv, wi = qt.query_topk_bias_plain(*args, k)
        torch.cuda.synchronize()
        tag = f"Q={Q} N={N} E={E} k={k} {kind}"
        check(torch.equal(gi, wi), f"query_topk_bias slots at {tag}")
        err = float((gv - wv).abs().max())
        check(err <= SCORE_TOL, f"query_topk_bias err {err} at {tag}")
        if kind.get("tie"):
            n_inc = int((args[2][0] > -5e29).sum())
            want0 = torch.nonzero(args[2][0] > -5e29)[:k, 0].to(torch.int32)
            check(torch.equal(gi[0, :min(k, n_inc)], want0),
                  "ties go to the lower slot")
        emit("query_topk_bias_check", {"shape": [Q, N, E, k], **kind,
                                       "max_abs_err": err})
        if E == 512:
            qs, emb, bias = args
            kernel = lambda: qt.query_topk_bias_cuda(qs, emb, bias, k)  # noqa
            b_ms, b_by = bound(*topk_cost(Q, N, E, k))
            timed[(Q, N)] = {
                "ms": clock.ms(kernel), "call_ms": clock.call_ms(kernel),
                "plain_ms": clock.ms(
                    lambda: qt.query_topk_bias_plain(qs, emb, bias, k)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": clock.ms(
                    lambda: torch.topk(qs @ emb.T + bias, k)),
                "max_abs_err": err, "shape": f"Q={Q} N={N} E={E} k={k}"}
            emit("query_topk_bias_time", timed[(Q, N)])
    return lift_row, timed[(1, 4096)]


# ------------------------------------------------------------------ step 3
def main_path(torch, dev, knobs, *, embed_dim, h, w, n_frames,
              keyframe_interval, n_objects):
    from repro_torch.core import (CloudService, DeviceClient, MappingServer,
                                  Query)
    from repro_torch.data.scenes import make_scene, scene_stream
    from repro_torch.kernels import ops
    from repro_torch.perception.embedder import OracleEmbedder

    kn, E = knobs, embed_dim
    D = kn.max_detections_per_frame
    emb = OracleEmbedder(embed_dim=E)
    scene = make_scene(n_objects=n_objects, seed=0)
    classes = {o.oid: o.class_id for o in scene.objects}
    srv = MappingServer(knobs=kn, embedder=emb, device=dev)
    cloud = CloudService(knobs=kn, store_ref=srv, device=dev)
    client = DeviceClient(knobs=kn, embed_dim=E, device=dev)
    gen = torch.Generator().manual_seed(0)   # per-view noise, host-drawn so
    kept, snap = [], None                    # step 5 can replay it on the CPU
    ingest_ms, tick_bytes, render_s = [], [], 0.0

    ops.reset_launch_counts()
    t_render = time.perf_counter()
    for i, fr in enumerate(scene_stream(scene, n_frames=n_frames,
                                        keyframe_interval=keyframe_interval,
                                        h=h, w=w)):
        render_s += time.perf_counter() - t_render
        noise = torch.randn((D, E), generator=gen)
        t = srv.process_frame(fr, classes, noise)
        if t.ingest_ms > 0:
            ingest_ms.append(t.ingest_ms)
        if i < CROSS_FRAMES:
            kept.append((fr, noise))
            if i == CROSS_FRAMES - 1:
                snap = srv.store._replace(**{
                    f: v.clone() for f, v in srv.store._asdict().items()
                    if v is not None})
        if i % 2 == 1:
            pkt = cloud.update_tick(network_up=True)
            client.ingest(pkt, user_pos=torch.from_numpy(
                np.asarray(fr.pose[:3, 3], np.float32)))
            tick_bytes.append(pkt.nbytes)
        t_render = time.perf_counter()
    n_keyframes = i + 1

    st, loc = srv.store, client.local
    act, lab = st.active.cpu().numpy(), st.label.cpu().numpy()
    lact, llab = loc.active.cpu().numpy(), loc.label.cpu().numpy()
    mapped = sorted(set(lab[act].tolist()))
    sq_hit = lq_hit = 0
    sq_ms, lq_ms = [], []
    for c in mapped:
        spec = Query(embed=emb.embed_text(c, dev), k=5)
        t0 = time.perf_counter()
        r = cloud.query_spec(spec)
        sq_ms.append((time.perf_counter() - t0) * 1e3)
        check(tuple(r.oids.shape) == (5,) and bool(
            torch.isfinite(r.scores[0])), f"SQ result for class {c}")
        s = int(r.slots[0])
        sq_hit += bool(s >= 0 and act[s] and lab[s] == c)
        t0 = time.perf_counter()
        r = client.query_spec(spec)
        lq_ms.append((time.perf_counter() - t0) * 1e3)
        s = int(r.slots[0])
        lq_hit += bool(s >= 0 and lact[s] and llab[s] == c)
    counts = ops.launch_counts()

    for name in ("embed", "centroid", "points"):
        check(bool(torch.isfinite(getattr(st, name)).all()),
              f"store.{name} finite")
    check(n_keyframes == -(-n_frames // keyframe_interval), "keyframes")
    check(len(mapped) > 0, "objects mapped")
    check(sq_hit >= 0.9 * len(mapped), f"SQ top-1 accuracy {sq_hit}/"
          f"{len(mapped)}")
    check(lq_hit >= 0.9 * len(mapped), f"LQ top-1 accuracy {lq_hit}/"
          f"{len(mapped)}")
    for name, n in counts.items():
        check(n > 0, f"{name} launched on the main path")
    out = {"keyframes": n_keyframes,
           "ingest_ms_p50": float(np.percentile(ingest_ms, 50)),
           "ingest_ms_p95": float(np.percentile(ingest_ms, 95)),
           "render_s_host": render_s,
           "n_mapped": int(act.sum()), "deferred": srv.deferred,
           "downlink_bytes_per_tick": tick_bytes,
           "local_occupancy": int(lact.sum()),
           "local_bytes": client.memory_bytes(),
           "mapped_classes": len(mapped),
           "sq_top1_acc": sq_hit / len(mapped),
           "lq_top1_acc": lq_hit / len(mapped),
           "sq_ms_p50": float(np.percentile(sq_ms, 50)),
           "lq_ms_p50": float(np.percentile(lq_ms, 50)),
           "launches": counts}
    emit("main_path", out)
    loop = SimpleNamespace(srv=srv, cloud=cloud, client=client, emb=emb,
                           gen=gen, scene=scene, classes=classes)
    return out, kept, snap, loop


# ------------------------------------------------------------------ step 4
def profile_phase(torch, dev, loop, *, embed_dim, h, w, n_frames,
                  keyframe_interval, **_):
    """Host ms per stage of PROFILE_KEYFRAMES keyframes (each stage ending
    in a synchronize), then a ``torch.profiler`` window over as many more.
    The keyframes revisit the start of step 3's stream."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Query
    from repro_torch.data.scenes import scene_stream

    srv, cloud, client = loop.srv, loop.cloud, loop.client
    D = srv.knobs.max_detections_per_frame
    spec = Query(embed=loop.emb.embed_text(0, dev), k=5)

    def step(fr):
        ms = {}
        t = srv.process_frame(fr, loop.classes, torch.randn(
            (D, embed_dim), generator=loop.gen))
        ms["detect"], ms["ingest"] = t.detect_ms, t.ingest_ms
        t0 = time.perf_counter()
        pkt = cloud.update_tick(network_up=True)
        torch.cuda.synchronize()
        ms["collect"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        client.ingest(pkt, user_pos=torch.from_numpy(
            np.asarray(fr.pose[:3, 3], np.float32)))
        torch.cuda.synchronize()
        ms["client_ingest"] = (time.perf_counter() - t0) * 1e3
        for name, fn in (("sq", cloud.query_spec), ("lq", client.query_spec)):
            t0 = time.perf_counter()
            fn(spec)
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
        return ms

    frames = scene_stream(loop.scene, n_frames=n_frames,
                          keyframe_interval=keyframe_interval, h=h, w=w)
    todo = [next(frames) for _ in range(2 * PROFILE_KEYFRAMES)]
    stages = [step(fr) for fr in todo[:PROFILE_KEYFRAMES]]
    emit("stages", stages)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for fr in todo[PROFILE_KEYFRAMES:]:
            step(fr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    # device-side events only: a CPU op's row also carries its kernels' time
    on_dev = [e for e in ev if e.device_type != DeviceType.CPU]
    busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3
    check(busy_ms > 0, "the profiler saw device time")
    aten = [e for e in ev if e.key.startswith("aten::")]

    def top(rows, key):
        return [{"name": e.key[:60], "calls": e.count, "ms": key(e) / 1e3}
                for e in sorted(rows, key=key, reverse=True)[:10]]

    out = {"keyframes": PROFILE_KEYFRAMES, "wall_ms": wall_ms,
           "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
           "host_syncs": {e.key: e.count for e in ev if e.key in SYNC_OPS},
           "cpu_ops": sum(e.count for e in aten),
           "top_kernels": top(on_dev, lambda e: e.self_device_time_total),
           "top_cpu_ops": top(aten, lambda e: e.self_cpu_time_total)}
    emit("profile", out)
    return out


# ------------------------------------------------------------------ step 5
def query_phase(torch, dev, *, n, capacity, embed_dim, max_points):
    from repro_torch.core.query import Query, execute_query, stack_queries
    from repro_torch.core.store import synthetic_store
    from repro_torch.kernels import ops

    cap = capacity
    gpu = synthetic_store(n, cap, embed_dim, max_points, device=dev)
    cpu = synthetic_store(n, cap, embed_dim, max_points, device="cpu")
    lab = cpu.label.numpy()[:n]
    qi = np.random.default_rng(1).choice(np.nonzero(lab < 10)[0], 16,
                                         replace=False)
    spec = stack_queries([Query(
        embed=cpu.embed[i], near=(cpu.centroid[i], torch.tensor(4.0)),
        prox_weight=torch.tensor(0.2), labels=tuple(range(10)),
        min_obs=torch.tensor(1, dtype=torch.int32), k=5) for i in qi])

    ops.reset_launch_counts()
    want = execute_query(cpu, spec)
    got = execute_query(gpu, spec)
    lat = []
    for _ in range(50):
        t0 = time.perf_counter()
        execute_query(gpu, spec)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    launched = ops.launch_counts()["query_topk_bias"]
    check(launched > 0, "query_topk_bias launched in the query phase")
    check(torch.equal(got.oids.cpu(), want.oids), "query phase oids")
    check(torch.equal(got.slots.cpu(), want.slots), "query phase slots")
    err = float((got.scores.cpu() - want.scores).abs().max())
    check(err <= SCORE_TOL, f"query phase scores err {err}")
    check(torch.equal(got.oids[:, 0].cpu(),
                      torch.from_numpy(qi + 1).to(torch.int32)),
          "each query's own object ranks first")
    out = {"objects": n, "slots": cap, "queries": 16,
           "batched_ms_p50": float(np.percentile(lat, 50)),
           "batched_ms_p95": float(np.percentile(lat, 95)),
           "max_abs_err_vs_cpu": err, "kernel_launches": launched}
    emit("query_phase", out)
    return out


# ------------------------------------------------------------------ step 6
def cross_device(torch, knobs, embed_dim, kept, snap, classes):
    from repro_torch.core import MappingServer
    from repro_torch.perception.embedder import OracleEmbedder

    srv = MappingServer(knobs=knobs,
                        embedder=OracleEmbedder(embed_dim=embed_dim),
                        device="cpu")
    for fr, noise in kept:
        srv.process_frame(fr, classes, noise)
    errs = {}
    for f, v in srv.store._asdict().items():
        g = getattr(snap, f).cpu()
        if v.is_floating_point():
            errs[f] = float((g - v).abs().max())
            check(errs[f] <= LIFT_TOL, f"cross-device store.{f} {errs[f]}")
        else:
            check(torch.equal(g, v), f"cross-device store.{f}")
    out = {"keyframes": len(kept), "n_active": int(snap.active.sum()),
           "max_abs_err": errs}
    emit("cross_device", out)
    return out


# -------------------------------------------------------------------- main
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import Knobs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = resolve_device("cuda")
    emit("versions", {"python": sys.version.split()[0],
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)})
    t0 = time.perf_counter()
    build.build_all()
    emit("build", {"seconds": time.perf_counter() - t0, "ptxas": {
        n: [ln.strip() for ln in build.build_log(n).splitlines()
            if "registers" in ln
            or ("spill" in ln and " 0 bytes spill" not in ln)]
        for n in build.SOURCES}})

    clock = Clock(torch)
    lift_row, topk_row = kernel_checks(torch, clock, dev)
    knobs = Knobs()
    path, kept, snap, loop = main_path(torch, dev, knobs, **DEPLOYMENT)
    profile_phase(torch, dev, loop, **DEPLOYMENT)
    query_phase(torch, dev, **QUERY_STORE)
    cross_device(torch, knobs, DEPLOYMENT["embed_dim"], kept, snap,
                 loop.classes)

    launches = path["launches"]
    kernels = [
        {"name": "lift_compact", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lift_compact.cu",
         "replaces": "src/repro/kernels/lift_compact.py:229",
         "launches": launches["lift_compact"], **lift_row},
        {"name": "query_topk_bias", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/query_topk.cu",
         "replaces": "src/repro/kernels/query_topk.py:121",
         "launches": launches["query_topk_bias"], **topk_row},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
