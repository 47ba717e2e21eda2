#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, in parallel) and prints the build time;
2. prints each kernel's registers, shared memory and spills from ptxas
   (``kernel_resources``), then holds each kernel against its plain
   PyTorch version on the card, at the main path's shapes and at edge
   shapes (budget > cap, ragged tiling, empty masks, one detection,
   H*W = 1961, 720x1280 at stride 1, every mask empty; k past the
   included count, all-equal scores, k = 1024, N below one 32-row block,
   the cluster index's k = 1024 at the batched shape; the captioner's
   prefill attention, the reference's attention test shapes, a GQA case,
   and the edges of the bf16 kernel's 128-row tiles: S = 17, S = 1025,
   MQA, window 1, non-causal dh = 128 at S = 2048; nearest-neighbour
   distances at the reference's test shapes, a chamfer, a centroid sweep,
   no valid neighbour, N past one staged tile, a stretch of invalid b
   longer than a share, D = 8 and 5, M no multiple of a block's rows):
   ints exactly, floats within 1e-4 (lift_compact, nearest_dist), 1e-5
   (query_topk_bias scores) and rtol = atol = 2e-5 / 2e-2
   (flash_attention in f32 / bf16); requires one launch per
   lift_compact call and the same bits from two calls of lift_compact
   and nearest_dist; and times kernel, plain version and, where one
   PyTorch call computes the same function, that call (with TFLOP/s for
   flash_attention; nearest_dist at the centroid and the chamfer shape);
   then query_topk_bias past its old limits (``query_topk_bias_any_k``):
   k = 2000 at the SQ shape and at the 1M flat shape, k = N + 5, N * E >=
   2^31 (N = 1,048,576, E = 2048) and Q * N >= 2^31 (Q = 2048, N =
   1,048,576, E = 16, against the plain version over chunks of queries),
   on exact-grid values so ties are exact, each timed beside its bound;
3. drives the single-client loop at the paper's deployment size (Knobs()
   defaults, E = 512, 720x1280 keyframes, 40 keyframes of an 80-object
   scene): MappingServer.process_frame, CloudService.update_tick ->
   DeviceClient.ingest every second keyframe, then an SQ and an LQ per
   mapped class, with every kernel launch counter reset just before and
   read just after;
4. profiles the loop: the server, cloud and client of step 3 take more
   keyframes, each followed by an update tick, the device-side ingest, an
   SQ and an LQ; half of them timed by stage on the host clock, half
   under ``torch.profiler`` (device-busy share, host syncs, top kernels;
   one lift kernel on the card for each lift_compact call);
5. runs 16 batched full_mix-style queries over a 10,000-object store and
   requires the same top-k as the CPU port, with the launch counters reset
   just before and read just after;
6. replays the first 6 keyframes of step 3 on the CPU port and requires
   the same store;
7. serves the full-width ``semanticxr-captioner-110m`` (12 layers, d 768,
   12 / 4 heads, vocab 32000, bf16, seeded weights): 8 caption prompts of
   1024 tokens, ``api.prefill`` then 32 greedy ``api.decode`` steps, three
   times, with the launch counters reset just before and read just after
   (12 flash_attention launches per prefill, none per decode step), and
   reads the share of one prefill's device time that flash_attention
   takes from ``torch.profiler``;
8. replays step 7's weights in f32 at B = 1, S = 256 and 8 greedy steps on
   the card and on the CPU port: the same tokens, logits within 1e-4;
9. builds the query engine benchmark's store (1,000,000 clustered objects,
   E = 256) and its ClusterIndex, and runs the full_mix query two-stage:
   equal to the flat sweep (oids and slots exactly, scores within 1e-5) and
   to a numpy oracle (rtol 5e-5, atol 1e-5, modulo ties); query_topk_bias
   launched by stage 1 and by stage 2 (counters reset just before, read
   just after); two-stage and flat ms, the stage split, a
   ``torch.profiler`` window over 5 queries of each (``index_profile``),
   escalations, candidate fraction, peak memory; the kernel against its plain version
   and timed at the index path's shapes (stage 1 at m = 64 and at the
   largest m, stage 2, the 1M flat sweep); then a churn (20,000
   tombstones, 15,000 moves) after which the incremental summaries equal a
   rebuild bit for bit; and at 100,000 objects the same build and query on
   the card and on the CPU port (member tables and exact fields equal,
   float fields within rtol = atol = 1e-6, equal results);
10. serves 64 full_mix requests over step 9's store and index through
    BatchScheduler(batch_size=16) and make_query_step_fn, blocking and
    not: every result equal to the same request run alone; requests/s,
    step ms;
11. runs the four Fig. 3 mapping arms (B, B+P, B+P+SD instrumented, B+P+SD
    fused) at the mapping benchmark's configuration (E = 256, 30 objects,
    8 keyframes of 240x320) on the card and on the CPU port with the same
    host-drawn noise: equal stores (ints exactly, floats within 1e-4),
    top-1 class accuracy >= 0.9, one lift_compact launch per mapped
    keyframe in the SD arms and none in B / B+P; per-stage walls beside the
    reference's CPU-container gate figures (printed, not required);
12. the fleet tier (``fleet_phase``): (a) benchmarks/fleet_scale.py's full
    configuration, C from 1 to 4096 (tick ms p50 / p95, per-client bytes
    and objects, the caller's reused sync tensor untouched, a 4-part mesh
    tier byte-identical to the unsharded one at every C >= 4) and its
    default configuration, whose per-client bytes must be exactly 19748
    at C = 1, 8, 64 and 256; a fenced span around one collect; (b)
    FleetServer at Knobs() defaults, E = 512, over 3,000 objects: 8 clean
    and 8 faulty pose twins through 20 ticks of churn and a clean settle,
    each faulty twin's map equal to its clean twin's, every packet equal
    to the CPU port's tick by tick, one query_topk_bias launch per
    selected flat zone in FleetServer.query; (c) step 9's 1,000,000
    objects mirrored into a 2x2 ZoneShardedStore with a zone index each:
    full_mix equal to the flat sweep (global slots zone * capacity +
    slot), two launches per two-stage shard round, mirror and build s,
    p50 / p95 ms, and the card against the CPU port at 100,000;
13. the scenario engine (``sim_phase``): (a) the golden churn scenario
    (seed 23, 20 objects, 20 + 8 ticks, 3 clients) matches the committed
    ``tests/golden/scenario_churn_v1.json``, two card runs are ``equals``,
    the card run ``equals`` the CPU port's and ``async_loop=True`` the
    sequential tick; (b) scenario_suite's small, mid and large arms:
    sent_bytes_total 15150 and 111840, large ``equals`` the CPU port,
    engine tick ms p50 / p95; (c) fault_tolerance's loss sweep (0, 1, 5,
    20 %) and its crash arm at the benchmark's default shape: down_bytes
    25987, 26533, 27675, 40844 and 31898, every arm converged; (d) the
    network-drop session of ``examples/network_drop_session.py`` (E = 256,
    240x320 keyframes, the stream cut after tick 8) on the card and on the
    CPU port with the same host-drawn noise, ``equals``; one lift_compact
    launch per mapped keyframe and one query_topk_bias launch per SQ and
    LQ; (e) FleetSimulator at the paper's deployment (``Knobs()``, E =
    512, step 3's 40 keyframes at 720x1280, 16 clients on heterogeneous
    links, SQ through BatchScheduler): stats, tick ms, both kernels
    launched, and the card's MetricsLog ``equals`` the CPU port's over the
    first 8 ticks;
14. the serving loop (``serving_loop_phase``) at
    benchmarks/serving_loop.py's non-smoke configuration (C = 256, 120
    ticks, 4096 live objects in a 131,072-slot store, E = 128, P = 128,
    churn 96, budget 32, batches of 4, two a tick, 1 Hz base and 8 Hz
    burst): the sync arm, then the overlapped arm, every per-request result
    byte-identical and equal sent bytes and final stores; ticks/s, tick ms,
    wait / e2e ms and query_topk_bias launches; the overlapped arm again
    with ``enable_index`` (two-stage), equal to the flat results; and
    ``StageTimes.record`` and the index metrics in an installed registry
    after one mapped keyframe and one two-stage query.

``nearest_dist`` has no caller on any system path: its phase drives its
entry point, ``ops.nearest_dist``, at a chamfer and a centroid shape.

It imports nothing of JAX or of the JAX package, catches no failure, and
exits non-zero (printing no result) without a CUDA device or outside a
checkout of the repository.  ``phase_seconds`` gives each step's host
seconds.  The line before the last is the per-kernel JSON record; the last
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
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
# the fp32 rate outside the tensor cores (lift_compact, query_topk_bias and
# nearest_dist compute in fp32 FMA), the dense bf16 tensor-core rate (the
# captioner's flash_attention).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

LIFT_TOL = 1e-4          # metres: back-projection + pose in another order
SCORE_TOL = 1e-5         # unit-vector dot products in another order
CROSS_FRAMES = 6         # keyframes replayed on the CPU port (step 6)
# flash_attention against its plain version (rtol = atol), the reference's
# own tolerances: f32 in another summation order; bf16 p and outputs round
# to 8 bits, so one rounding that lands the other way moves an output by a
# bf16 ulp
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# query_topk_bias past its old limits: (what, (Q, N, E, k), the plain
# version's query chunk or None, timed reps)
TOPK_ANY_K = (("k=2000 at the SQ shape", (1, 4096, 512, 2000), None, 10),
              ("k=2000 at the 1M flat shape", (1, 1_000_000, 256, 2000),
               None, 3),
              ("k=N+5", (2, 3000, 64, 3005), None, 10),
              ("N*E >= 2^31", (2, 1 << 20, 2048, 10), None, 3),
              ("Q*N >= 2^31", (2048, 1 << 20, 16, 10), 128, 3))
ND_TOL = 1e-4            # nearest_dist: |a|^2 + |b|^2 - 2ab in another order
LOGIT_TOL = 1e-4         # step 8: f32 logits, 12 layers in another order
PROFILE_KEYFRAMES = 4    # keyframes timed by stage, then as many profiled
PROFILE_DECODE = 8       # decode steps under the profiler (step 7)
PROFILE_QUERIES = 5      # full_mix queries under the profiler (step 9)
# ops whose CPU side waits for the card: each is a host sync in the loop
SYNC_OPS = ("aten::item", "aten::_local_scalar_dense", "aten::nonzero",
            "cudaStreamSynchronize", "cudaDeviceSynchronize",
            "aten::masked_select")

# the paper's deployment: Knobs() defaults (Tab. 2), MobileCLIP's width,
# 720p keyframes every 5th frame, and the 10,000-object query claim
DEPLOYMENT = dict(embed_dim=512, h=720, w=1280, n_frames=200,
                  keyframe_interval=5, n_objects=80)
QUERY_STORE = dict(n=10_000, capacity=10_240, embed_dim=512, max_points=16)
# the captioner's serving shape (step 7) and the f32 replay (step 8)
SERVE = dict(batch=8, prompt=1024, new_tokens=32, reps=3)
REPLAY = dict(batch=1, prompt=256, new_tokens=8)
# nearest_dist: a detection's cloud against a map object's, both at
# Knobs().max_object_points_server; every kept point of a keyframe's 32
# detections against the 4096-slot store's centroids
ND_PATH_SHAPES = ((2000, 2000, 3), (64000, 4096, 3))
# step 9: the query engine's configuration (benchmarks/query_engine.py): a
# clustered store of 1,000,000 objects at E = 256, its hotspot count, and
# the full_mix spec; a churn of 20,000 tombstones and 15,000 moves; the
# card against the CPU port at 100,000 objects
INDEX = dict(n=1_000_000, embed_dim=256, max_points=16, room=80.0, reps=20,
             tombstones=20_000, moves=15_000, cross_n=100_000)
FULL_MIX = dict(radius=4.0, prox_weight=0.2, labels=tuple(range(10)),
                min_points=4, min_obs=1, zones=(0, 1, 2, 3),
                grid=(-40.0, -40.0, 40.0, 2, 2), k=10)
SUMM_TOL = 1e-6          # cluster summaries' float fields, card vs CPU:
#                          rtol = atol (centroids reach 40 m, where one
#                          f32 ulp is 3.8e-6)
ORACLE_TOL = dict(rtol=5e-5, atol=1e-5)   # the benchmark's _oracle_parity
# step 10: 64 full_mix requests in scheduler batches of 16
SERVING = dict(requests=64, batch_size=16)
# step 11: benchmarks/mapping_latency.py's four arms at default_knobs()
# (benchmarks/common.py), B and B+P with uncapped geometry, and the
# reference's CPU-container gate figures (BENCH_gate.md, printed beside)
ARMS = dict(embed_dim=256, n_objects=30, n_frames=40, keyframe_interval=5,
            h=240, w=320)
ARM_MODES = (("B", "baseline", False), ("B+P", "parallel", False),
             ("B+P+SD", "semanticxr", True),
             ("B+P+SD (fused)", "semanticxr", False))
ARM_KNOBS = dict(server_capacity=256, client_capacity=128,
                 max_object_points_server=512, max_object_points_client=128,
                 max_detections_per_frame=16, min_obs_before_sync=1)
REFERENCE_GATE = {"n_mapped": 31, "mAcc": 100.0}
# step 12: benchmarks/fleet_scale.py's full configuration (:128-130) and
# its default one (:131-133), whose per-client bytes at C = 1, 8, 64 and 256
# are the reference's exact counter (BENCH_fleet_scale.json)
FLEET_SWEEP = (1, 8, 64, 256, 512, 1024, 2048, 4096)
FLEET_FULL = dict(sweep=FLEET_SWEEP, n_obj=256, cap=512, E=256, P=512,
                  budget=32, reps=10, shards=4)
FLEET_DEFAULT = dict(sweep=(1, 8, 64, 256), n_obj=128, cap=256, E=128, P=256,
                     budget=32, reps=3, shards=4)
FLEET_BYTES = 19748
# FleetServer at the paper's deployment: Knobs() defaults, E = 512, a 2x2
# grid over an 8 m room and 3,000 objects, 60 % of them transient (below
# min_obs_before_sync), so each client's one subscribed zone holds fewer
# objects than its 512 local-map slots; 8 clean / faulty pose twins
TWINS = dict(n_objects=3000, embed_dim=512, pairs=8, ticks=20, settle=16,
             transient=0.6, churn=6, radius=1.0,
             faults=dict(loss_prob=0.1, dup_prob=0.05, reorder_prob=0.1,
                         corrupt_prob=0.05))
# step 13: the scenario engine.  The golden churn scenario
# (tests/golden/regen.py) and its committed snapshot; scenario_suite's arms
# (benchmarks/scenario_suite.py:95-100, the large one at its _BIG knobs)
# with the reference's sent_bytes_total (BENCH_scenario_suite.json, None:
# the large arm is held to the CPU port instead); fault_tolerance's default
# shape and arms (benchmarks/fault_tolerance.py:74-91) with their
# down_bytes (BENCH_fault_tolerance.json): (loss, crash, down_bytes)
GOLDEN = dict(seed=23, n_objects=20, n_ticks=20, n_clients=3,
              remove_frac=0.25, drain_ticks=8)
GOLDEN_SNAPSHOT = ROOT / "tests" / "golden" / "scenario_churn_v1.json"
SUITE_KNOBS = dict(server_capacity=256, client_capacity=128,
                   max_object_points_server=64, max_object_points_client=16,
                   min_obs_before_sync=1)
SUITE = (("small", GOLDEN, 15150),
         ("mid", dict(seed=23, n_objects=60, n_ticks=40, n_clients=8,
                      remove_frac=0.3, drain_ticks=8), 111840),
         ("large", dict(seed=23, n_objects=100, n_ticks=60, n_clients=16,
                        remove_frac=0.3, drain_ticks=10), None))
FAULT_SHAPE = dict(seed=29, n_objects=24, n_ticks=24, n_clients=4,
                   drain_ticks=12, outage_frac=0.0, query_prob=0.0)
FAULT_ARMS = ((0.0, False, 25987), (0.01, False, 26533),
              (0.05, False, 27675), (0.2, False, 40844), (0.05, True, 31898))
# examples/network_drop_session.py:36-62: E = 256, 240x320 keyframes, the
# stream cut after tick 8, an outage over ticks 4-8, two removals at tick 9
NETWORK_DROP = dict(n_objects=25, scene_seed=2, embed_dim=256, h=240,
                    w=320, n_frames=60, keyframe_interval=5, stream_ticks=9,
                    knobs=dict(server_capacity=256, client_capacity=64,
                               max_object_points_server=512,
                               max_object_points_client=128,
                               max_detections_per_frame=16,
                               min_obs_before_sync=1))
# FleetSimulator at the paper's deployment over step 3's keyframes: 16
# clients, one tick per keyframe, the card held to the CPU port over the
# first 8 ticks
FLEET_SIM = dict(n_clients=16, seed=3, cross_ticks=8)
# step 14: benchmarks/serving_loop.py's non-smoke configuration (:151-153)
SERVING_LOOP = dict(C=256, ticks=120, n_live=4096, cap=131072, E=128, P=128,
                    nz=1, zcap=6144, churn=96, budget=32, batch=4,
                    max_batches=2, base_hz=1.0, burst_hz=8.0,
                    warm_ticks=6, trace_ticks=40, index_min_flat=1024,
                    hold_every=25)


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
def lift_inputs(torch, d, h, w, stride, seed, dev, empty="one"):
    """Depth with 25 % holes, D masks of mixed density (some objects under
    the point budget, some past the lift cap); ``empty``: one empty mask
    (the middle one), ``none`` or ``all``."""
    rng = np.random.default_rng(seed)
    depth = np.where(rng.random((h, w)) > 0.25,
                     rng.uniform(0.4, 6.0, (h, w)), 0.0).astype(np.float32)
    dens = rng.uniform(0.002, 0.6, size=(d, 1, 1))
    masks = rng.random((d, h, w)) < dens
    if empty == "one":
        masks[d // 2] = False
    elif empty == "all":
        masks[:] = False
    intr = np.array([0.9 * w * stride, 0.9 * w * stride, w * stride / 2,
                     h * stride / 2], np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = q
    pose[:3, 3] = rng.uniform(-2, 2, 3)
    return [torch.from_numpy(a).to(dev) for a in (depth, masks, intr, pose)]


def topk_inputs(torch, Q, N, E, seed, dev, *, frac=0.8, tie=False,
                grid=False):
    """Unit-norm queries and rows (as the embedder makes them), a finite
    bias in [0, 0.2) on a ``frac`` share of the slots and NEG elsewhere.
    ``grid``: every value a multiple of 1/16 (bias of 1/256), so each score
    is exact in f32 under any summation order and equal scores are exact
    ties: the kernel's rank order must then equal the plain version's at
    any k, where at k = 1024 of unit-norm rows two scores closer than the
    rounding of either summation order (about 1e-7) may legitimately swap."""
    rng = np.random.default_rng(seed)
    if tie:      # every included slot scores exactly E / 8
        qs = np.full((Q, E), 0.5, np.float32)
        emb = np.full((N, E), 0.25, np.float32)
    elif grid:
        qs = (rng.integers(-8, 9, size=(Q, E)) / 16).astype(np.float32)
        emb = (rng.integers(-8, 9, size=(N, E)) / 16).astype(np.float32)
    else:
        qs = rng.normal(size=(Q, E)).astype(np.float32)
        qs /= np.linalg.norm(qs, axis=1, keepdims=True)
        emb = rng.normal(size=(N, E)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    inc = rng.random((Q, N)) < frac
    finite = (0.0 if tie else rng.integers(0, 52, size=(Q, N)) / 256 if grid
              else 0.2 * rng.random((Q, N)))
    bias = np.where(inc, finite, -1e30).astype(np.float32)
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
def same_bits(torch, xs, ys) -> bool:
    """Every tensor of ``xs`` equal to its partner in ``ys`` bit for bit."""
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    return all(torch.equal(bits(x), bits(y)) for x, y in zip(xs, ys))


def kernel_checks(torch, clock, dev):
    from repro_torch.kernels import lift_compact as lc
    from repro_torch.kernels import query_topk as qt

    # lift_compact: main path (32 detections at 144x256, stride 5, budget
    # 2000, cap 4096), the edge shapes of tests/test_kernels.py, and the
    # edges of the cluster kernel's split (lift_compact.work_split): one
    # detection (8 blocks on one object), H*W = 1961 (no multiple of 16,
    # so no block share divides it and most masks start unaligned for the
    # 16-byte loads), 720x1280 at stride 1 (8 blocks of 15 register
    # chunks each), and every mask empty
    lift_cases = [((32, 144, 256, 5, 2000, 4096), "one"),
                  ((4, 24, 32, 1, 64, 4096), "one"),
                  ((8, 48, 64, 5, 512, 4096), "one"),
                  ((3, 20, 26, 2, 16, 32), "one"),
                  ((6, 30, 40, 3, 100, 80), "one"),
                  ((1, 144, 256, 5, 2000, 4096), "none"),
                  ((5, 37, 53, 3, 300, 4096), "one"),
                  ((4, 720, 1280, 1, 2000, 4096), "one"),
                  ((6, 144, 256, 5, 2000, 4096), "all")]
    for case, empty in lift_cases:
        d, h, w, stride, budget, cap = case
        args = lift_inputs(torch, d, h, w, stride, sum(case), dev, empty)
        kw = dict(stride=stride, budget=budget, lift_cap=cap)
        n0 = lc.launches
        got = lc.lift_compact_cuda(*args, **kw)
        check(lc.launches == n0 + 1, "lift_compact: one launch per call")
        want = lc.lift_compact_plain(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got[1], want[1]), f"lift_compact n at {case}")
        err = max(float((g - x).abs().max()) for g, x in
                  zip(got, want) if g.is_floating_point())
        check(err <= LIFT_TOL, f"lift_compact err {err} at {case}")
        for k in {"all": range(d), "one": [d // 2], "none": []}[empty]:
            check(int(got[1][k]) == 0 and not got[0][k].any()
                  and not got[2][k].any() and not got[3][k].any(),
                  f"lift_compact empty mask at {case}")
        emit("lift_compact_check", {"shape": case, "empty": empty,
                                    "max_abs_err": err})
        if case == lift_cases[0][0]:
            again = lc.lift_compact_cuda(*args, **kw)
            check(same_bits(torch, got, again),
                  "lift_compact: two calls give the same bits")
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
    # than one block holds, an E that takes the scalar-load path, N below
    # one 32-row block, and the cluster index's k = 1024 at the batched
    # shape (on exact-grid values, see topk_inputs)
    topk_cases = [((16, 10240, 512, 5), {}), ((1, 4096, 512, 5), {}),
                  ((1, 512, 512, 5), {}), ((2, 700, 64, 40), {"frac": 0.03}),
                  ((4, 700, 64, 20), {"tie": True}),
                  ((2, 3000, 64, 1024), {}), ((3, 1000, 96, 100), {}),
                  ((37, 2000, 128, 9), {}), ((2, 900, 50, 7), {}),
                  ((2, 20, 64, 7), {}), ((1, 31, 512, 5), {}),
                  ((16, 10240, 512, 1024), {"grid": True})]
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
        if E == 512 and k == 5 and N >= 512:
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


def grid_topk_inputs(torch, Q, N, E, seed, dev, *, frac=0.8):
    """``topk_inputs(grid=True)`` drawn on the card (the shapes past 2^31
    elements would take minutes of numpy): every value a multiple of 1/16,
    the bias a multiple of 1/256 or NEG, so each score is exact in f32 under
    any summation order and equal scores are exact ties."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def vals(shape):
        return (torch.randint(-8, 9, shape, generator=g, device=dev,
                              dtype=torch.int8).to(torch.float32) / 16)
    qs, emb = vals((Q, E)), vals((N, E))
    bias = torch.empty((Q, N), device=dev)
    rows = max(1, (1 << 28) // N)           # fill the bias in slabs
    for q0 in range(0, Q, rows):
        q1 = min(Q, q0 + rows)
        inc = torch.rand((q1 - q0, N), generator=g, device=dev) < frac
        fin = torch.randint(0, 52, (q1 - q0, N), generator=g, device=dev,
                            dtype=torch.int8).to(torch.float32) / 256
        bias[q0:q1] = torch.where(inc, fin, -1e30)
    return qs, emb, bias


def plain_by_query_chunks(torch, qt, qs, emb, bias, k, rows):
    """The plain version over chunks of ``rows`` queries (queries are
    independent rows), for shapes whose [Q, N] scores would not fit twice."""
    outs = [qt.query_topk_bias_plain(qs[q0:q0 + rows], emb,
                                     bias[q0:q0 + rows], k)
            for q0 in range(0, qs.shape[0], rows)]
    return torch.cat([v for v, _ in outs]), torch.cat([i for _, i in outs])


def topk_any_k_checks(torch, clock, dev) -> list:
    """query_topk_bias past the old limits: k = 2000 at the SQ shape and at
    the 1M flat shape, k = N + 5, N * E >= 2^31 and Q * N >= 2^31; each
    against its plain version (slots exactly, ties to the lower slot,
    scores within SCORE_TOL) and timed beside its byte bound."""
    from repro_torch.kernels import query_topk as qt

    rows = []
    for tag, (Q, N, E, k), chunk, reps in TOPK_ANY_K:
        qs, emb, bias = grid_topk_inputs(torch, Q, N, E, Q + N + E + k, dev)

        def plain(qs=qs, emb=emb, bias=bias, k=k, chunk=chunk):
            if chunk is None:
                return qt.query_topk_bias_plain(qs, emb, bias, k)
            return plain_by_query_chunks(torch, qt, qs, emb, bias, k, chunk)
        gv, gi = qt.query_topk_bias_cuda(qs, emb, bias, k)
        wv, wi = plain()
        torch.cuda.synchronize()
        check(tuple(gi.shape) == (Q, k), f"query_topk_bias shape at {tag}")
        check(torch.equal(gi, wi), f"query_topk_bias slots at {tag}")
        err = float((gv - wv).abs().max())
        check(err <= SCORE_TOL, f"query_topk_bias err {err} at {tag}")
        n_inc = (bias > -5e29).sum(dim=1)
        if k > N:
            check(bool((gi[:, N:] == -1).all())
                  and bool((gv[:, N:] == qt.NEG).all()),
                  f"query_topk_bias pads past N at {tag}")
        del wv, wi
        b_ms, b_by = bound(*topk_cost(Q, N, E, k))
        # past 2^31 elements the caching allocator frees and syncs inside
        # the calls, so the host cannot queue ahead: time them as called
        timer = clock.ms if chunk is None else clock.call_ms
        row = {"case": tag, "shape": [Q, N, E, k], "max_abs_err": err,
               "included_min": int(n_inc.min()),
               "timed": "device" if chunk is None else "call",
               "ms": timer(lambda: qt.query_topk_bias_cuda(qs, emb, bias, k),
                           reps),
               "plain_ms": timer(plain, reps),
               "bound_ms": b_ms, "bound_by": b_by,
               # torch.topk refuses k > N
               "library_ms": None if k > N else timer(
                   lambda: torch.topk(qs @ emb.T + bias, k), reps)}
        emit("query_topk_bias_any_k", row)
        rows.append(row)
        del qs, emb, bias, gv, gi
        torch.cuda.empty_cache()
    return rows


def attn_inputs(torch, B, S, H, Kv, dh, dtype, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((B, S, h, dh), generator=g, device=dev).to(dtype)
            for h in (H, Kv, Kv)]


def attn_cost(q, k, causal, window, elt):
    """(bytes, flops) of one attention call: q, k, v read and o written
    once; 4 * dh flops for each (query, key) pair the masks keep."""
    B, S, H, dh = q.shape
    qp = np.arange(S)[:, None]
    kp = np.arange(S)[None, :]
    keep = np.ones((S, S), bool)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= qp - kp < window
    return ((2 * q.numel() + 2 * k.numel()) * elt,
            4 * dh * B * H * int(keep.sum()))


def attention_checks(torch, clock, dev):
    from repro_torch.kernels import flash_attention as fa

    def close(got, want, dtype):
        tol = ATTN_TOL[str(dtype).split(".")[-1]]
        err = (got.float() - want.float()).abs()
        return float(err.max()), bool(
            (err <= tol + tol * want.float().abs()).all())

    # (B, S, H, Kv, dh, dtype, causal, window, softcap): the captioner's
    # prefill; tests/test_kernels.py:75-81 and a non-causal ragged S, each
    # in the reference's [H, S, dh] layout (strided views, as
    # ops.flash_attention passes them); a GQA case with every option
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(8, 1024, 12, 4, 64, bf, True, 0, 0.0),
             (8, 1024, 12, 4, 64, f32, True, 0, 0.0),
             (1, 128, 2, 2, 64, f32, True, 0, 0.0),
             (1, 256, 4, 4, 64, f32, True, 64, 0.0),
             (1, 200, 2, 2, 128, f32, True, 0, 50.0),
             (1, 128, 1, 1, 64, f32, False, 0, 0.0),
             (1, 256, 2, 2, 64, bf, True, 0, 0.0),
             (1, 200, 2, 2, 64, f32, False, 0, 0.0),
             (1, 200, 2, 2, 64, bf, False, 0, 0.0),
             (2, 333, 12, 4, 128, bf, True, 100, 30.0),
             # edges of the bf16 kernel's 128 x 128 tiling: S below one
             # tile, one row past a tile, MQA, window 1, non-causal dh 128
             (2, 17, 12, 4, 64, bf, True, 0, 0.0),
             (1, 1025, 12, 4, 64, bf, True, 0, 0.0),
             (2, 1024, 12, 1, 64, bf, True, 0, 0.0),
             (1, 300, 4, 4, 64, bf, True, 1, 0.0),
             (1, 2048, 4, 2, 128, bf, False, 0, 0.0)]
    row = None
    for i, (B, S, H, Kv, dh, dt, causal, window, cap) in enumerate(cases):
        if B == 1 and H == Kv:
            hsd = attn_inputs(torch, 1, S, H, H, dh, dt, i, dev)
            q, k, v = (t[0].transpose(0, 1).contiguous().transpose(0, 1)[None]
                       for t in hsd)      # [1, S, H, dh] views of [H, S, dh]
        else:
            q, k, v = attn_inputs(torch, B, S, H, Kv, dh, dt, i, dev)
        kw = dict(causal=causal, window=window, softcap=cap)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err, ok = close(got, want, dt)
        tag = dict(B=B, S=S, H=H, Kv=Kv, dh=dh, dtype=str(dt), **kw)
        check(ok and bool(torch.isfinite(got).all()),
              f"flash_attention err {err} at {tag}")
        emit("flash_attention_check", {**tag, "max_abs_err": err})
        if i == 0:
            nbytes, flops = attn_cost(q, k, causal, window, 2)
            t_ops = flops / BF16_FLOP_PER_S * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            sdpa = [t.transpose(1, 2) for t in (q, k, v)]
            row = {
                "ms": clock.ms(lambda: fa.flash_attention_cuda(q, k, v,
                                                               **kw)),
                "plain_ms": clock.ms(lambda: fa.flash_attention_plain(
                    q, k, v, **kw)),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": clock.ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        *sdpa, is_causal=True, enable_gqa=True)),
                "max_abs_err": err, "flops": flops, "bytes": nbytes,
                "shape": f"B={B} S={S} H={H} Kv={Kv} dh={dh} bf16 causal"}
            row["tflops"] = flops / row["ms"] / 1e9
            row["library_tflops"] = flops / row["library_ms"] / 1e9
            emit("flash_attention_time", row)
    return row


def nd_inputs(torch, M, N, D, seed, dev, frac=0.9, hole=None):
    """Points in a 10 m room (a), map points or centroids (b), a share
    ``frac`` of b valid, none of the rows in ``hole`` = (lo, hi)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = (torch.rand((M, D), generator=g, device=dev) - 0.5) * 10
    b = (torch.rand((N, D), generator=g, device=dev) - 0.5) * 10
    bv = torch.rand((N,), generator=g, device=dev) < frac
    if hole is not None:
        bv[hole[0]:hole[1]] = False
    return a, b, bv


def nd_cost(M, N, D, n_valid):
    """(bytes, fp32 flops) of one nearest_dist call.  The least work is D
    multiply-adds and one min for each (row, valid b row) pair, 2D + 1
    flops: the kernel folds |b|^2 into the first FMA and adds |a|^2 once a
    row, so counting the reference's 2D + 3 would put the kernel's own
    work above its bound."""
    return 4 * (M * D + N * D + M) + N, M * n_valid * (2 * D + 1)


def nearest_checks(torch, clock, dev):
    from repro_torch.kernels import pairwise as pw

    # the reference's test shapes, the two path shapes, no valid
    # neighbour; then the edges of the kernel's tiling (pairwise.nd_split:
    # 1024 rows of a a block, or 256 where M < 16384; b cut among a
    # cluster's blocks and staged 2048 rows (D <= 3) or 512 rows (D <= 8)
    # at a time): N that is no multiple of a tile with shares past one
    # tile, a stretch of invalid b rows longer than a share (a block whose
    # whole share is invalid), D = 8 and D = 5 (the padded 8-lane kernel),
    # M no multiple of a block's rows, and one row against one point
    cases = [((50, 70, 3), 0.9, None), ((256, 512, 3), 0.9, None),
             ((1000, 333, 3), 0.9, None), ((128, 128, 8), 0.9, None),
             ((2000, 2000, 3), 0.9, None), ((64000, 4096, 3), 0.8, None),
             ((300, 200, 3), 0.0, None),
             ((20000, 17000, 3), 0.9, None),
             ((20000, 17000, 3), 0.9, (4000, 9000)),
             ((20000, 17000, 8), 0.9, (4000, 9000)),
             ((513, 2049, 5), 0.9, None), ((1, 1, 3), 1.0, None)]
    rows = {}
    for i, ((M, N, D), frac, hole) in enumerate(cases):
        a, b, bv = nd_inputs(torch, M, N, D, i, dev, frac, hole)
        got = pw.nearest_dist_cuda(a, b, bv)
        want = pw.nearest_dist_plain(a, b, bv)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(((got - want).abs() <= ND_TOL + ND_TOL * want.abs()).all()),
              f"nearest_dist err {err} at {(M, N, D)}")
        if frac == 0.0:
            check(bool((got == pw.INF).all()), "no valid neighbour -> 1e30")
        emit("nearest_dist_check", {"shape": [M, N, D], "valid_share": frac,
                                    "invalid_rows": hole, "max_abs_err": err})
        if (M, N, D) in ND_PATH_SHAPES and (M, N, D) not in rows:
            check(same_bits(torch, [got], [pw.nearest_dist_cuda(a, b, bv)]),
                  f"nearest_dist: two calls give the same bits at {(M, N)}")
            n_valid = int(bv.sum())
            b_ms, b_by = bound(*nd_cost(M, N, D, n_valid))
            rows[(M, N, D)] = {
                "ms": clock.ms(lambda: pw.nearest_dist_cuda(a, b, bv)),
                "plain_ms": clock.ms(lambda: pw.nearest_dist_plain(a, b, bv)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": clock.ms(lambda: torch.cdist(a, b).masked_fill(
                    ~bv[None], torch.inf).amin(1).square()),
                "max_abs_err": err, "n_valid": n_valid,
                "shape": f"M={M} N={N} D={D}"}
            emit("nearest_dist_time", rows[(M, N, D)])
    return {**rows[ND_PATH_SHAPES[1]], "chamfer": rows[ND_PATH_SHAPES[0]]}


def nearest_phase(torch, dev):
    """The whole path of nearest_dist is its entry point: ops.nearest_dist
    at the chamfer and centroid shapes, the chamfer held against the CPU
    port, with the launch counters reset just before and read just after."""
    from repro_torch.kernels import ops

    inputs = [nd_inputs(torch, M, N, D, 100 + i, dev)
              for i, (M, N, D) in enumerate(ND_PATH_SHAPES)]
    ops.reset_launch_counts()
    outs = [ops.nearest_dist(*x) for x in inputs]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = ops.nearest_dist(*(t.cpu() for t in inputs[0]))
    err = float((outs[0].cpu() - want).abs().max())
    check(err <= ND_TOL * (1 + float(want.abs().max())),
          f"nearest_dist chamfer against the CPU port: err {err}")
    check(all(bool(torch.isfinite(o).all()) for o in outs),
          "nearest_dist outputs finite")
    check(counts["nearest_dist"] == len(ND_PATH_SHAPES),
          f"nearest_dist launched on its path: {counts}")
    out = {"shapes": ND_PATH_SHAPES, "max_abs_err_vs_cpu": err,
           "launches": counts}
    emit("nearest_dist_phase", out)
    return out


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
    for name in ("lift_compact", "query_topk_bias"):
        check(counts[name] > 0, f"{name} launched on the main path")
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
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Query
    from repro_torch.data.scenes import scene_stream
    from repro_torch.kernels import ops

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
    n0 = ops.launch_counts()["lift_compact"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for fr in todo[PROFILE_KEYFRAMES:]:
            step(fr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # one lift kernel on the card for each lift_compact call
    lift_calls = ops.launch_counts()["lift_compact"] - n0
    lift_kernels = sum(e.count for e in prof.key_averages()
                       if "lift_cluster_kernel" in e.key)
    check(lift_calls > 0 and lift_kernels == lift_calls,
          f"{lift_kernels} lift kernels for {lift_calls} lift_compact calls")
    out = {"keyframes": PROFILE_KEYFRAMES, "lift_compact_calls": lift_calls,
           "lift_kernels": lift_kernels, **profile_summary(prof, wall_ms)}
    emit("profile", out)
    return out


def profile_summary(prof, wall_ms: float) -> dict:
    """Device-busy share, host syncs and top kernels / CPU ops of a
    ``torch.profiler`` window that lasted ``wall_ms`` on the host."""
    from torch.autograd import DeviceType

    ev = prof.key_averages()
    # device-side events only: a CPU op's row also carries its kernels' time
    on_dev = [e for e in ev if e.device_type != DeviceType.CPU]
    busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3
    check(busy_ms > 0, "the profiler saw device time")
    aten = [e for e in ev if e.key.startswith("aten::")]

    def top(rows, key):
        return [{"name": e.key[:60], "calls": e.count, "ms": key(e) / 1e3}
                for e in sorted(rows, key=key, reverse=True)[:10]]

    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "host_syncs": {e.key: e.count for e in ev if e.key in SYNC_OPS},
            "cpu_ops": sum(e.count for e in aten),
            "top_kernels": top(on_dev, lambda e: e.self_device_time_total),
            "top_cpu_ops": top(aten, lambda e: e.self_cpu_time_total)}


def profiled(torch, fn) -> dict:
    """``profile_summary`` of one call of ``fn`` (ending in a synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return profile_summary(prof, wall_ms)


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


# ------------------------------------------------------------------ step 7
def serve_phase(torch, dev, cfg, *, batch, prompt, new_tokens, reps):
    """The captioner's serving path: prefill, then greedy decode steps,
    through model_api's entry points, ``reps`` times on the same caches."""
    from repro_torch.data.tokens import batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.models.api import model_api
    from repro_torch.models.lm import greedy_token

    api = model_api(cfg)
    t0 = time.perf_counter()
    model = api.init(torch.Generator().manual_seed(0), device=dev)
    init_s = time.perf_counter() - t0
    tokens = torch.from_numpy(next(batch_iterator(
        batch, prompt, seed=0, vocab_size=cfg.vocab_size))["tokens"]).to(dev)
    caches = api.init_cache(batch, prompt + new_tokens, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pre_ms, dec_ms, per_prefill, per_decode, generated = [], [], [], [], []

    ops.reset_launch_counts()
    for _ in range(reps):
        n0 = ops.launch_counts()["flash_attention"]
        t0 = time.perf_counter()
        logits, caches = api.prefill(model, {"tokens": tokens}, caches)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
        n1 = ops.launch_counts()["flash_attention"]
        per_prefill.append(n1 - n0)
        check(bool(torch.isfinite(logits).all()), "prefill logits finite")
        tok = greedy_token(logits)
        gen = [tok]
        for i in range(new_tokens):
            t0 = time.perf_counter()
            logits, caches = api.decode(model, tok, caches, prompt + i)
            tok = greedy_token(logits)
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t0) * 1e3)
            gen.append(tok)
        per_decode.append(ops.launch_counts()["flash_attention"] - n1)
        check(bool(torch.isfinite(logits).all()), "decode logits finite")
        generated.append(torch.cat(gen, dim=1).cpu())
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    check(per_prefill == [cfg.n_layers] * reps,
          f"{cfg.n_layers} flash_attention launches per prefill: "
          f"{per_prefill}")
    check(per_decode == [0] * reps, f"no flash_attention launch while "
          f"decoding: {per_decode}")
    check(all(torch.equal(g, generated[0]) for g in generated),
          "the same greedy tokens from every repetition")
    check(int(caches[0].length) == prompt + new_tokens, "cache length")
    check(counts["flash_attention"] > 0,
          "flash_attention launched on the serving path")
    # where the time goes: one prefill, then PROFILE_DECODE decode steps,
    # each under the profiler (after the checks: these launches are extra)
    state = {}

    def prefill_once():
        state["logits"], state["caches"] = api.prefill(
            model, {"tokens": tokens}, caches)

    def decode_steps():
        tok = greedy_token(state["logits"])
        for i in range(PROFILE_DECODE):
            logits, _ = api.decode(model, tok, state["caches"], prompt + i)
            tok = greedy_token(logits)

    prof = {"prefill": profiled(torch, prefill_once),
            f"decode_{PROFILE_DECODE}_steps": profiled(torch, decode_steps)}
    pre = prof["prefill"]
    flash_ms = sum(r["ms"] for r in pre["top_kernels"] if "flash" in r["name"])
    check(flash_ms > 0, "flash_attention among the prefill's top kernels")
    prof["prefill_flash_device_ms"] = flash_ms
    prof["prefill_flash_share_of_device"] = flash_ms / pre["device_busy_ms"]
    emit("serve_profile", prof)

    dec = float(np.percentile(dec_ms, 50))
    out = {"config": cfg.name, "batch": batch, "prompt": prompt,
           "new_tokens": new_tokens, "reps": reps,
           "params": sum(p.numel() for p in model.parameters()),
           "weights_bytes": sum(p.numel() * p.element_size()
                                for p in model.parameters()),
           "kv_cache_bytes": sum(c.k.nbytes + c.v.nbytes for c in caches),
           "init_s_host": init_s,
           "prefill_ms": pre_ms, "prefill_ms_p50": float(np.median(pre_ms)),
           "decode_ms_per_step_p50": dec,
           "decode_ms_per_step_p95": float(np.percentile(dec_ms, 95)),
           "generated_tokens_per_s": batch / dec * 1e3,
           "max_memory_allocated_bytes": peak,
           "flash_launches_per_prefill": per_prefill,
           "launches": counts,
           "first_tokens": generated[0][0, :8].tolist()}
    emit("serve_phase", out)
    return out


# ------------------------------------------------------------------ step 8
def replay_phase(torch, dev, cfg, *, batch, prompt, new_tokens):
    """Step 7's weights in f32 (the same seeded draw, not rounded to bf16)
    on the card and on the CPU port: greedy tokens equal, logits close."""
    from repro_torch.data.tokens import batch_iterator
    from repro_torch.models.api import model_api
    from repro_torch.models.lm import greedy_token

    api = model_api(cfg.replace(dtype=torch.float32))
    prompt_np = next(batch_iterator(batch, prompt, seed=1,
                                    vocab_size=cfg.vocab_size))["tokens"]

    def run(device):
        model = api.init(torch.Generator().manual_seed(0), device=device)
        caches = api.init_cache(batch, prompt + new_tokens, device=device)
        logits, caches = api.prefill(
            model, {"tokens": torch.from_numpy(prompt_np).to(device)}, caches)
        toks, all_logits = [], [logits.cpu()]
        tok = greedy_token(logits)
        for i in range(new_tokens):
            toks.append(tok.cpu())
            logits, caches = api.decode(model, tok, caches, prompt + i)
            all_logits.append(logits.cpu())
            tok = greedy_token(logits)
        toks.append(tok.cpu())
        return torch.cat(toks, dim=1), torch.stack(all_logits)

    t0 = time.perf_counter()
    gtok, glog = run(dev)
    ctok, clog = run("cpu")
    err = float((glog - clog).abs().max())
    check(torch.equal(gtok, ctok), f"greedy tokens card {gtok.tolist()} vs "
          f"CPU {ctok.tolist()}")
    check(err <= LOGIT_TOL, f"f32 logits card vs CPU err {err}")
    out = {"batch": batch, "prompt": prompt, "new_tokens": new_tokens,
           "tokens": gtok[0].tolist(), "max_abs_logit_err": err,
           "max_abs_logit": float(clog.abs().max()),
           "seconds_host": time.perf_counter() - t0}
    emit("replay_phase", out)
    return out



# ------------------------------------------------------------------ step 9
def full_mix(torch, st, qi):
    """The query engine benchmark's full_mix spec, asked as object ``qi``."""
    from repro_torch.core.query import Query
    f = FULL_MIX
    return Query(embed=st.embed[qi],
                 near=(st.centroid[qi], torch.tensor(f["radius"])),
                 prox_weight=torch.tensor(f["prox_weight"]),
                 labels=f["labels"],
                 min_points=torch.tensor(f["min_points"], dtype=torch.int32),
                 min_obs=torch.tensor(f["min_obs"], dtype=torch.int32),
                 zones=f["zones"], grid=f["grid"], k=f["k"])


def np_oracle_full_mix(st, qi):
    """numpy flat sweep of full_mix (benchmarks/query_engine.py's
    ``_np_oracle_full_mix``): f32 scores, stable argsort.  -> top-k scores."""
    f = FULL_MIX
    host = {c: getattr(st, c).cpu().numpy() for c in
            ("active", "embed", "centroid", "label", "n_points", "obs_count")}
    qe, center = host["embed"][qi], host["centroid"][qi]
    sim = host["embed"] @ qe
    d = np.linalg.norm(host["centroid"] - center, axis=1)
    ok = (host["active"] & (d <= f["radius"])
          & np.isin(host["label"], np.asarray(f["labels"]))
          & (host["n_points"] >= f["min_points"])
          & (host["obs_count"] >= f["min_obs"]))
    score = np.where(ok, sim + np.float32(f["prox_weight"])
                     / (np.float32(1.0) + d), -np.inf).astype(np.float32)
    return score[np.argsort(-score, kind="stable")[:f["k"]]]


def oracle_parity(scores, oracle) -> bool:
    """The k scores equal the oracle's modulo tie order and f32 summation
    order (the benchmark's ``_oracle_parity``)."""
    s = np.sort(scores.cpu().numpy())[::-1]
    o = np.sort(oracle)[::-1]
    fin = np.isfinite(o)
    return bool(np.array_equal(fin, np.isfinite(s))
                and np.allclose(s[fin], o[fin], **ORACLE_TOL))


def same_topk(torch, a, b) -> float:
    """Checks equal oids and slots; returns the largest score difference
    (padded ranks, -inf in both, count as equal)."""
    check(torch.equal(a.oids.cpu(), b.oids.cpu()), "oids equal")
    check(torch.equal(a.slots.cpu(), b.slots.cpu()), "slots equal")
    sa, sb = a.scores.cpu(), b.scores.cpu()
    fin = torch.isfinite(sb)
    check(torch.equal(torch.isfinite(sa), fin), "padded ranks equal")
    return float((sa[fin] - sb[fin]).abs().max()) if bool(fin.any()) else 0.0


def clustered(n, dev, *, embed_dim, max_points, room, **_):
    from repro_torch.core.store import clustered_synthetic_store
    return clustered_synthetic_store(n, n, embed_dim, max_points, seed=0,
                                     room=room,
                                     n_hotspots=max(128, n // 2_000),
                                     device=dev)


def query_object(st) -> int:
    """The benchmark's query: the middle of the objects with label < 10."""
    lab_ok = np.nonzero(st.label.cpu().numpy() < 10)[0]
    return int(lab_ok[len(lab_ok) // 2])


def host_ms(torch, fn, reps):
    """Host-clock ms of ``reps`` calls, each ending in a synchronize."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def topk_spy(ops, fn, keep=lambda i: True, clone=True) -> list:
    """[(inputs or None, (scores, slots))] of every ops.query_topk_bias call
    ``fn`` makes, in order: each call's answer, and its inputs (qs, embeds,
    bias, k) where ``keep(i)`` picks the i-th call, cloned (``clone``) so a
    later in-place write to a store leaves them as the call read them.  The
    calls go through to the real wrapper: a launch count around ``fn``
    stays exact."""
    calls, real = [], ops.query_topk_bias

    def spy(qs, embeds, bias, k):
        args = None
        if keep(len(calls)):
            args = (qs.clone(), embeds.clone() if clone else embeds,
                    bias.clone(), k)
        out = real(qs, embeds, bias, k)
        calls.append((args, tuple(x.clone() for x in out)))
        return out
    ops.query_topk_bias = spy
    try:
        fn()
    finally:
        ops.query_topk_bias = real
    return calls


def captured_topk_calls(ops, fn) -> list:
    """(qs, embeds, bias, k) of every ops.query_topk_bias call ``fn``
    makes (these launches are extra: outside any counted window)."""
    return [args for args, _ in topk_spy(ops, fn, clone=False)]


def hold_topk_calls(torch, calls, where: str) -> dict:
    """The kernel against its plain version on every call of ``calls``
    (``topk_spy``'s list) whose inputs were kept, at the shapes the path
    gave it (a launch each, after the counted window): equal slots, scores
    within SCORE_TOL, and the answer the path got equal to both."""
    from repro_torch.kernels import query_topk as qt

    err, shapes, n = 0.0, set(), 0
    for args, (vals, slots) in calls:
        if args is None:
            continue
        qs, emb, bias, k = args
        gv, gi = qt.query_topk_bias_cuda(qs, emb, bias, k)
        wv, wi = qt.query_topk_bias_plain(qs, emb, bias, k)
        tag = (f"{where}: Q={qs.shape[0]} N={emb.shape[0]} "
               f"E={qs.shape[1]} k={k}")
        check(torch.equal(gi, wi) and torch.equal(slots.to(gi.device), gi),
              f"query_topk_bias slots != plain at {tag}")
        e = max(float((gv - wv).abs().max()),
                float((vals.to(gv.device) - wv).abs().max())) \
            if gv.numel() else 0.0
        check(e <= SCORE_TOL, f"query_topk_bias err {e} at {tag}")
        err, n = max(err, e), n + 1
        shapes.add(tag.split(": ", 1)[1])
    check(n > 0, f"{where}: no query_topk_bias call held to its plain version")
    return {"held": n, "max_abs_err": err, "shapes": sorted(shapes)}


def same_topk_answers(torch, a, b) -> float:
    """Max |score| difference between two runs' query_topk_bias answers
    (``topk_spy``'s lists), call by call; -1 when the call counts, shapes
    or slots differ."""
    if len(a) != len(b):
        return -1.0
    err = 0.0
    for (_, (av, ai)), (_, (bv, bi)) in zip(a, b):
        av, ai, bv, bi = av.cpu(), ai.cpu(), bv.cpu(), bi.cpu()
        if av.shape != bv.shape or not torch.equal(ai, bi):
            return -1.0
        if av.numel():
            err = max(err, float((av - bv).abs().max()))
    return err


def topk_time(torch, clock, qs, emb, bias, k, where):
    """The kernel against its plain version on one captured input, timed
    with the plain version, ``torch.topk`` of the same scores and the byte
    bound."""
    from repro_torch.kernels import query_topk as qt

    gv, gi = qt.query_topk_bias_cuda(qs, emb, bias, k)
    wv, wi = qt.query_topk_bias_plain(qs, emb, bias, k)
    torch.cuda.synchronize()
    Q, E = qs.shape
    N = emb.shape[0]
    tag = f"{where}: Q={Q} N={N} E={E} k={k}"
    check(torch.equal(gi, wi), f"query_topk_bias slots at {tag}")
    err = float((gv - wv).abs().max())
    check(err <= SCORE_TOL, f"query_topk_bias err {err} at {tag}")
    b_ms, b_by = bound(*topk_cost(Q, N, E, k))
    row = {"shape": tag, "max_abs_err": err,
           "included": int((bias > -5e29).sum()),
           "ms": clock.ms(lambda: qt.query_topk_bias_cuda(qs, emb, bias, k)),
           "plain_ms": clock.ms(
               lambda: qt.query_topk_bias_plain(qs, emb, bias, k)),
           "library_ms": clock.ms(lambda: torch.topk(qs @ emb.T + bias, k)),
           "bound_ms": b_ms, "bound_by": b_by}
    emit("query_topk_bias_index_time", row)
    return row


def stage_split(torch, search, fn, reps) -> dict:
    """Mean host ms a query of stage 1 (with the cells' host read), stage 2
    and the host work between (slab assembly, certificate): the stages
    wrapped in synchronizes for this window only."""
    acc = {"stage1": 0.0, "stage2": 0.0}
    real = {"stage1": search._stage1, "stage2": search._stage2}

    def timed(name):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*a, **kw)
            torch.cuda.synchronize()
            acc[name] += (time.perf_counter() - t0) * 1e3
            return out
        return run
    search._stage1, search._stage2 = timed("stage1"), timed("stage2")
    try:
        total = sum(host_ms(torch, fn, reps))
    finally:
        search._stage1, search._stage2 = real["stage1"], real["stage2"]
    out = {k: v / reps for k, v in acc.items()}
    out["host_between"] = total / reps - out["stage1"] - out["stage2"]
    return out


def index_phase(torch, dev, clock, *, n, reps, tombstones, moves, cross_n,
                **cfg):
    """The cluster index's certified two-stage query at the query engine's
    configuration, against the flat sweep and a numpy oracle; churn;
    the card against the CPU port at ``cross_n`` objects."""
    from repro_torch.core.query import execute_query
    from repro_torch.core.store import remove_objects
    from repro_torch.index import ClusterIndex, rebuilt, search
    from repro_torch.index.cluster import ClusterSummaries
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import MetricsRegistry, set_registry

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = clustered(n, dev, **cfg)
    torch.cuda.synchronize()
    store_s = time.perf_counter() - t0
    qi = query_object(st)
    spec = full_mix(torch, st, qi)
    t0 = time.perf_counter()
    idx = ClusterIndex.for_target(st)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(idx.engaged(), "the index engages at this size")

    # the counted run: one two-stage query; stage 1 alone launches once
    reg = MetricsRegistry()
    prev = set_registry(reg)
    ops.reset_launch_counts()
    two = execute_query(st, spec, index=idx)
    torch.cuda.synchronize()
    set_registry(prev)
    counts = ops.launch_counts()
    escalations = reg.counter("query_index_escalations_total").total()
    rounds = 1 + escalations
    check(counts["query_topk_bias"] == 2 * rounds,
          f"query_topk_bias launched by stage 1 and stage 2 in each of "
          f"{rounds} rounds: {counts}")
    ops.reset_launch_counts()
    search._stage1(spec, idx.summaries, m=min(search._C0, idx.grid.n_cells),
                   has_obs=True, has_seen=True)
    torch.cuda.synchronize()
    check(ops.launch_counts()["query_topk_bias"] == 1,
          "stage 1 is one query_topk_bias launch")
    fraction = reg.histogram("query_index_candidate_fraction").summary()

    flat = execute_query(st, spec)
    err = same_topk(torch, two, flat)
    check(err <= SCORE_TOL, f"two-stage scores against flat: err {err}")
    oracle = np_oracle_full_mix(st, qi)
    check(oracle_parity(two.scores, oracle), "two-stage = numpy oracle")
    check(oracle_parity(flat.scores, oracle), "flat = numpy oracle")
    check(int(two.oids[0]) == qi + 1, "the query's own object ranks first")

    two_ms = host_ms(torch, lambda: execute_query(st, spec, index=idx), reps)
    flat_ms = host_ms(torch, lambda: execute_query(st, spec), reps)
    split = stage_split(torch, search,
                        lambda: execute_query(st, spec, index=idx), reps)
    emit("index_profile", {
        f"{name}_{PROFILE_QUERIES}_queries": profiled(torch, lambda: [
            execute_query(st, spec, index=i) for _ in range(PROFILE_QUERIES)])
        for name, i in (("two_stage", idx), ("flat", None))})

    # query_topk_bias at the index path's shapes: stage 1 (k = m = 64, and
    # the largest m the kernel takes), stage 2, the flat sweep
    s1, s2 = captured_topk_calls(
        ops, lambda: execute_query(st, spec, index=idx))[:2]
    (fl,) = captured_topk_calls(ops, lambda: execute_query(st, spec))
    topk_rows = [topk_time(torch, clock, *s1, "stage 1"),
                 topk_time(torch, clock, *s1[:3], idx.grid.n_cells,
                           "stage 1 at the largest m (every cell)"),
                 topk_time(torch, clock, *s2, "stage 2"),
                 topk_time(torch, clock, *fl, "flat sweep")]
    del s1, s2, fl
    peak = torch.cuda.max_memory_allocated()

    # churn: tombstones, then moves with a version bump, then refresh
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    remove_objects(st, rng.choice(np.arange(1, n + 1), tombstones,
                                  replace=False))
    slots = torch.from_numpy(rng.choice(n, moves, replace=False)).to(dev)
    st.centroid[slots] += torch.from_numpy(rng.normal(
        scale=8.0, size=(moves, 3)).astype(np.float32)).to(dev)
    st.version[slots] += 1
    changed = idx.refresh(st)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scratch = rebuilt(idx, st)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    equal = [torch.equal(a, b) for a, b in zip(idx.summaries,
                                               scratch.summaries)]
    check(all(equal), "incremental = rebuilt after churn on the card: "
          + str(dict(zip(ClusterSummaries._fields, equal))))
    check(torch.equal(idx.members, scratch.members),
          "member table = rebuilt after churn")
    del scratch
    err_churn = same_topk(torch, execute_query(st, spec, index=idx),
                          execute_query(st, spec))
    check(err_churn <= SCORE_TOL, f"two-stage = flat after churn: "
          f"{err_churn}")

    cross = index_cross_device(torch, dev, cross_n, cfg)
    out = {"objects": n, "embed_dim": cfg["embed_dim"],
           "n_cells": idx.grid.n_cells, "cell_cap": idx.cell_cap,
           "store_s_host": store_s, "build_s": build_s,
           "two_stage_ms_p50": float(np.percentile(two_ms, 50)),
           "two_stage_ms_p95": float(np.percentile(two_ms, 95)),
           "flat_ms_p50": float(np.percentile(flat_ms, 50)),
           "flat_ms_p95": float(np.percentile(flat_ms, 95)),
           "split_ms_mean": split,
           "escalations": escalations,
           "candidate_fraction": fraction["mean"],
           "two_stage_vs_flat_max_abs_err": err,
           "churn": {"tombstones": tombstones, "moves": moves,
                     "changed_slots": changed, "refresh_s": refresh_s,
                     "rebuild_s": rebuild_s},
           "max_memory_allocated_bytes": peak,
           "launches": counts, "cross_device": cross}
    emit("index_phase", out)
    return out, st, idx, topk_rows


def index_cross_device(torch, dev, n, cfg) -> dict:
    """The same build and query on the card and on the CPU port: equal
    member tables and exact summary fields, float fields within SUMM_TOL,
    equal results."""
    from repro_torch.core.query import execute_query
    from repro_torch.index import ClusterIndex

    built = {}
    for d in (dev, "cpu"):
        st = clustered(n, d, **cfg)
        built[str(d)] = (st, ClusterIndex.for_target(st))
    (gst, gidx), (cst, cidx) = built[str(dev)], built["cpu"]
    check(gidx.grid == cidx.grid and gidx.cell_cap == cidx.cell_cap,
          "grid and cell_cap, card vs CPU")
    check(np.array_equal(gidx._members, cidx._members)
          and torch.equal(gidx.members.cpu(), cidx.members),
          "member tables, card vs CPU")
    errs = {}
    for f, g in gidx.summaries._asdict().items():
        c = getattr(cidx.summaries, f)
        if f in ("centroid", "embed_mean", "res_max"):
            diff = (g.cpu() - c).abs()
            errs[f] = float(diff.max())
            check(bool((diff <= SUMM_TOL + SUMM_TOL * c.abs()).all()),
                  f"summaries.{f} card vs CPU {errs[f]}")
        else:
            check(torch.equal(g.cpu(), c), f"summaries.{f} card vs CPU")
    qi = query_object(cst)
    err = same_topk(torch, execute_query(gst, full_mix(torch, gst, qi),
                                         index=gidx),
                    execute_query(cst, full_mix(torch, cst, qi), index=cidx))
    check(err <= SCORE_TOL, f"two-stage card vs CPU scores err {err}")
    return {"objects": n, "n_cells": gidx.grid.n_cells,
            "summary_max_abs_err": errs, "score_max_abs_err": err}


# ----------------------------------------------------------------- step 10
def serving_phase(torch, dev, st, idx, *, requests, batch_size):
    """Batched full_mix requests through BatchScheduler and the query step
    function over step 9's store and index, blocking and not; each result
    equal to the same request run alone."""
    from repro_torch.core.query import execute_query
    from repro_torch.kernels import ops
    from repro_torch.serving.batching import (BatchScheduler,
                                              make_query_step_fn,
                                              resolve_results)

    rng = np.random.default_rng(3)
    lab_ok = np.nonzero(st.label.cpu().numpy() < 10)[0]
    specs = [full_mix(torch, st, int(q))
             for q in rng.choice(lab_ok, requests, replace=False)]
    alone = [execute_query(st, s, index=idx) for s in specs]
    out = {"requests": requests, "batch_size": batch_size}
    for block in (True, False):
        fn = make_query_step_fn(lambda: st, pad_to=batch_size, block=block,
                                get_index=lambda: idx)
        step_ms = []

        def step_fn(payloads, fn=fn, step_ms=step_ms):
            t0 = time.perf_counter()
            res = fn(payloads)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return res
        sched = BatchScheduler(batch_size=batch_size, step_fn=step_fn)
        rids = [sched.submit(s) for s in specs]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = sched.drain()
        torch.cuda.synchronize()
        if not block:
            resolve_results(done)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        check(counts["query_topk_bias"] > 0,
              "query_topk_bias launched on the serving path")
        err = 0.0
        for rid, want in zip(rids, alone):
            got = done[rid]
            check(np.array_equal(got.oids, want.oids.cpu().numpy())
                  and np.array_equal(got.slots, want.slots.cpu().numpy()),
                  f"request {rid} batched = alone (block={block})")
            w = want.scores.cpu().numpy()
            fin = np.isfinite(w)
            check(np.array_equal(np.isfinite(got.scores), fin),
                  f"request {rid} padded ranks")
            if fin.any():
                err = max(err, float(np.abs(got.scores[fin] - w[fin]).max()))
        check(err <= SCORE_TOL, f"batched scores err {err}")
        out["blocking" if block else "non_blocking"] = {
            "requests_per_s": requests / wall, "wall_s": wall,
            "steps": len(step_ms),
            "step_ms_p50": float(np.percentile(step_ms, 50)),
            "max_abs_err_vs_alone": err, "launches": counts}
    emit("serving_phase", out)
    return out


# ----------------------------------------------------------------- step 11
def mapping_arms_phase(torch, dev, *, embed_dim, n_objects, n_frames,
                       keyframe_interval, h, w):
    """The four Fig. 3 arms on the card and on the CPU port with the same
    host-drawn noise: equal stores, class accuracy, per-stage walls, and
    lift_compact launched once per keyframe in the SD arms only."""
    from repro_torch.core import Knobs, MappingServer, Query
    from repro_torch.core.query import execute_query
    from repro_torch.data.scenes import make_scene, scene_stream
    from repro_torch.kernels import ops
    from repro_torch.perception.embedder import OracleEmbedder

    scene = make_scene(n_objects=n_objects, seed=0)
    classes = {o.oid: o.class_id for o in scene.objects}
    frames = list(scene_stream(scene, n_frames=n_frames,
                               keyframe_interval=keyframe_interval, h=h, w=w))
    D = ARM_KNOBS["max_detections_per_frame"]
    gen = torch.Generator().manual_seed(0)
    noises = [torch.randn((D, embed_dim), generator=gen) for _ in frames]
    emb = OracleEmbedder(embed_dim=embed_dim)
    gt = sorted({o.class_id for o in scene.objects})

    def run(mode, instrument, device):
        kn = dict(ARM_KNOBS)
        if mode != "semanticxr":
            kn["max_object_points_server"] = 2048
        srv = MappingServer(knobs=Knobs(**kn), embedder=emb, mode=mode,
                            instrument=instrument, device=device)
        times = [srv.process_frame(fr, classes, z)
                 for fr, z in zip(frames, noises)]
        return srv, times

    out = {"reference_cpu_container_gate": REFERENCE_GATE}
    for label, mode, instrument in ARM_MODES:
        ops.reset_launch_counts()
        srv, times = run(mode, instrument, dev)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        mapped = sum(t.ingest_ms > 0 or t.embed_ms > 0 for t in times)
        want = mapped if mode == "semanticxr" else 0
        check(counts["lift_compact"] == want,
              f"{label}: {counts['lift_compact']} lift_compact launches for "
              f"{mapped} mapped keyframes (want {want})")
        cpu, _ = run(mode, instrument, "cpu")
        errs = {}
        for f, v in cpu.store._asdict().items():
            g = getattr(srv.store, f).cpu()
            if v.is_floating_point():
                errs[f] = float((g - v).abs().max())
                check(errs[f] <= LIFT_TOL, f"{label} store.{f} card vs CPU "
                      f"{errs[f]}")
            else:
                check(torch.equal(g, v), f"{label} store.{f} card vs CPU")
        act = srv.store.active.cpu().numpy()
        lab = srv.store.label.cpu().numpy()
        hits = 0
        for c in gt:
            s = int(execute_query(srv.store, Query(
                embed=emb.embed_text(c, dev), k=5)).slots[0])
            hits += bool(s >= 0 and act[s] and lab[s] == c)
        macc = hits / len(gt)
        check(macc >= 0.9, f"{label} top-1 class accuracy {macc}")
        warm = times[2:]
        stages = ("embed", "lift", "associate") if label != \
            "B+P+SD (fused)" else ("ingest",)
        out[label] = {
            "n_mapped": int(act.sum()), "mAcc": 100.0 * macc,
            "keyframes": len(frames), "mapped_keyframes": mapped,
            "stage_ms_mean": {
                st: float(np.mean([getattr(t, f"{st}_ms") for t in warm]))
                for st in ("detect",) + stages},
            "max_abs_err_vs_cpu": errs, "launches": counts}
    emit("mapping_arms_phase", out)
    return out

# ----------------------------------------------------------------- step 12
def fleet_sweep(torch, dev, *, sweep, n_obj, cap, E, P, budget, reps,
                shards):
    """benchmarks/fleet_scale.py at one configuration: tick ms (p50, p95)
    of a SessionManager collect for C clients, every rep from the same
    ``fresh`` sync row (which must stay zero: the collect returns new
    tensors), per-client bytes and objects; and at C >= ``shards`` the
    mesh tier of ``shards`` parts against the unsharded tier on fresh
    sessions, byte for byte."""
    from repro_torch.core import Knobs
    from repro_torch.core.store import synthetic_store
    from repro_torch.server import (ClientRoster, MeshSessionTier,
                                    SessionManager)

    kn = Knobs(server_capacity=cap, client_capacity=max(budget * 2, 64),
               max_object_points_server=P,
               max_object_points_client=max(P // 4, 16),
               min_obs_before_sync=1)
    store = synthetic_store(n_obj, cap, E, P, device=dev)
    out = {}
    for C in sweep:
        sm = SessionManager(knobs=kn, n_clients=C, capacity=cap,
                            budget=budget, device=dev)
        fresh = torch.zeros((C, cap), dtype=torch.int32, device=dev)

        def tick_once(sm=sm, fresh=fresh):
            sm.sync = sm.sync._replace(synced_version=fresh)
            return sm.collect(store)
        for _ in range(2):
            tick_once()
        ms = host_ms(torch, tick_once, reps if C <= 256 else
                     max(reps // 2, 3))
        pkt = tick_once()
        check(not bool(fresh.any()), f"C={C}: the collect wrote the "
              "caller's sync tensor")
        row = {"tick_ms_p50": float(np.percentile(ms, 50)),
               "tick_ms_p95": float(np.percentile(ms, 95)),
               "per_client_bytes": float(pkt.nbytes.mean()),
               "objects_per_client": float(pkt.counts.mean())}
        if C >= shards:
            roster = ClientRoster.round_robin(C, shards)
            tier = MeshSessionTier(knobs=kn, capacity=cap, roster=roster,
                                   budget=budget, device=dev)
            tier.set_all(subscribed=np.ones((C,), bool))
            ref = SessionManager(knobs=kn, n_clients=C, capacity=cap,
                                 budget=budget, device=dev)
            a, b = tier.collect(store), ref.collect(store)
            same = all(np.array_equal(getattr(a, f), getattr(b, f))
                       for f in ("counts", "nbytes", "seqs"))
            for part, members in zip(a.parts, roster.members):
                m = torch.from_numpy(members).to(dev)
                same &= part is not None and all(
                    torch.equal(x, y[m]) for x, y in zip(part.batch,
                                                         b.batch))
            check(same, f"mesh tier ({shards} parts) = unsharded at C={C}")
            row["mesh_byte_identical"] = same
            row["tick_ms_mesh_p50"] = float(np.percentile(host_ms(
                torch, lambda tier=tier: tier.collect(store), 3), 50))
        out[C] = row
    return out


def fleet_digest(packets, C) -> list:
    """Per zone packet of one tick: nbytes and seqs, and each client's
    count, crc32, ids, versions, points and centroids (host copies)."""
    out = []
    for z, pkt in packets:
        rows = []
        for c in range(C):
            u = pkt.packet_for(c)
            if not u.count:
                rows.append(None)
                continue
            b = u.batch
            n = u.count
            rows.append((u.seq, u.epoch, u.checksum,
                         b.oid[:n].cpu().numpy(),
                         b.version[:n].cpu().numpy(),
                         b.n_points[:n].cpu().numpy(),
                         b.points[:n].cpu().numpy(),
                         b.centroid[:n].cpu().numpy()))
        out.append((z, pkt.nbytes.tolist(), pkt.seqs.tolist(), rows))
    return out


def same_digest(a, b) -> bool:
    """Two runs' digests (per tick, per zone packet): ids, versions,
    counts, seqs, crc32 and bytes exactly; points to one f16 ulp;
    centroids within rtol = atol = SUMM_TOL."""
    if [len(t) for t in a] != [len(t) for t in b]:
        return False
    for (za, na, sa, ra), (zb, nb, sb, rb) in zip(
            [e for t in a for e in t], [e for t in b for e in t]):
        if (za, na, sa) != (zb, nb, sb) or len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if (x is None) != (y is None):
                return False
            if x is None:
                continue
            if x[:3] != y[:3] or not all(np.array_equal(p, q) for p, q in
                                         zip(x[3:6], y[3:6])):
                return False
            ulp = np.abs(x[6].view(np.int16).astype(np.int32)
                         - y[6].view(np.int16).astype(np.int32))
            if ulp.max(initial=0) > 1 or not np.allclose(
                    x[7], y[7], rtol=SUMM_TOL, atol=SUMM_TOL):
                return False
    return True


def fleet_twins(torch, dev, *, n_objects, embed_dim, pairs, ticks, settle,
                transient, churn, radius, faults, seed=0):
    """FleetServer end to end: ``pairs`` pose twins, one on a clean link and
    one on a FaultModel link, through ``ticks`` ticks of churn (removals,
    version-bumped moves inside a zone, transients promoted past min_obs,
    tombstones released once no subscriber owes an ack) and ``settle``
    clean ticks;
    clean twins acked through ``ack_tick``, faulty ones through ``ack``
    (with uplink loss) and ``request_resync``.  Returns the per-tick packet
    digests, each twin's map ({oid: version}), the faulty clients' counters
    and the server."""
    from repro_torch.core import (ClientSession, DeviceClient, FaultModel,
                                  Knobs, NetworkModel)
    from repro_torch.core.store import (release_tombstones, remove_objects,
                                        synthetic_store, tombstone_slots)
    from repro_torch.server import FleetServer, ZoneGrid

    kn = Knobs()
    C = 2 * pairs
    rng = np.random.default_rng(seed)
    st = synthetic_store(n_objects, kn.server_capacity, embed_dim,
                         kn.max_object_points_server, seed=seed, device=dev)
    transients = np.nonzero(rng.random(n_objects) < transient)[0]
    st.obs_count[torch.from_numpy(transients).to(dev)] = 1
    grid = ZoneGrid.for_room(8.0, 2, 2)
    fs = FleetServer(knobs=kn, embed_dim=embed_dim, n_clients=C, grid=grid,
                     proto=True, device=dev)
    fm = FaultModel(seed=seed, **faults)
    centers = np.array([[-2, 1.5, -2], [-2, 1.5, 2], [2, 1.5, -2],
                        [2, 1.5, 2]], np.float32)
    poses = np.stack([centers[c % 4] + [0.1 * (c // 4), 0.0, 0.0]
                      for c in range(pairs)] * 2).astype(np.float32)
    sess = [ClientSession(dev=DeviceClient(knobs=kn, embed_dim=embed_dim,
                                           device=dev),
                          net=NetworkModel(), knobs=kn, cid=c,
                          user_pos=torch.from_numpy(poses[c]).to(dev),
                          faults=None if c < pairs else fm)
            for c in range(C)]
    clean = np.arange(C) < pairs
    up = np.ones((C,), bool)
    fs.refresh(st)
    for c in range(C):
        fs.join(c, poses[c], radius, tick=0)
    digests = []
    promoted = list(rng.permutation(transients))
    for t in range(ticks + settle):
        if t < ticks:
            live = np.nonzero(st.active.cpu().numpy())[0]
            remove_objects(st, st.ids.cpu().numpy()[
                rng.choice(live, churn, replace=False)])
            # moves stay inside their zone: a move across a zone boundary
            # frees the old shard's slot without a tombstone, so a client
            # that had received the object keeps it (ROADMAP.md section 4)
            act = np.nonzero(st.active.cpu().numpy())[0]
            cand = rng.choice(act, 4 * churn, replace=False)
            old = st.centroid.cpu().numpy()[cand]
            new = old + rng.normal(scale=0.3, size=old.shape).astype(
                np.float32)
            keep = np.nonzero(grid.zone_of(new) == grid.zone_of(old))[0]
            keep = keep[:churn]
            mv = torch.from_numpy(cand[keep]).to(dev)
            st.centroid[mv] = torch.from_numpy(new[keep]).to(dev)
            st.version[mv] += 1
            pr = torch.from_numpy(np.asarray(
                [promoted.pop() for _ in range(min(churn, len(promoted)))],
                np.int64)).to(dev)
            st.obs_count[pr] = 2
            st.version[pr] += 1
        elif t == ticks:
            for s in sess[pairs:]:
                s.faults = None                    # the settle: clean links
        fs.refresh(st)
        pk = fs.tick(up, tick=t)
        digests.append(fleet_digest(pk, C))
        for c, s in enumerate(sess):
            for _, p in pk or [(None, None)]:
                s.step(float(t), None if p is None else p.packet_for(c))
        fs.ack_tick([(z, dataclasses.replace(p, seqs=np.where(
            clean, p.seqs, -1))) for z, p in pk], tick=t)
        for c in range(pairs, C):
            for z, ep, sq in sess[c].drain_acks():
                if sess[c].faults is None or not fm.uplink_lost(0, c, t, z,
                                                                sq):
                    fs.ack(c, z, ep, sq, tick=t)
            for _, z in sess[c].drain_ctrl():
                fs.request_resync(c)
        for s in sess[:pairs]:
            s.drain_acks()
        fs.maintain(tick=t, deliverable=up, retx_ticks=fm.retx_ticks)
        blocked = fs.blocked_tombstone_oids(tick=t)
        ids = st.ids.cpu().numpy()
        rel = [sl for sl in tombstone_slots(st)
               if int(ids[sl]) not in blocked]
        if rel:
            release_tombstones(st, np.asarray(rel))
    maps = []
    for s in sess:
        m = s.dev.local
        a = m.active.cpu().numpy()
        maps.append(dict(zip(m.ids.cpu().numpy()[a].tolist(),
                             m.version.cpu().numpy()[a].tolist())))
    counters = [{k: getattr(s, k) for k in ("lost", "dup_drops",
                                            "corrupt_drops", "stale_drops",
                                            "resyncs", "delivered")}
                for s in sess[pairs:]]
    return digests, maps, counters, fs


def zoned_mirror(torch, dev, st, n, cfg):
    """Step 9's store mirrored into a 2x2 ZoneShardedStore on the query
    engine benchmark's grid (room 80 m, zone capacity 2n / 4) with one
    ClusterIndex per zone.  Returns (zoned, mirror s, per-zone build s)."""
    from repro_torch.core import Knobs
    from repro_torch.index import cluster
    from repro_torch.server import ZoneGrid, ZoneShardedStore

    zoned = ZoneShardedStore(knobs=Knobs(server_capacity=n),
                             embed_dim=cfg["embed_dim"],
                             grid=ZoneGrid.for_room(cfg["room"], 2, 2),
                             max_points=cfg["max_points"], device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    zoned.refresh_from(st)
    sync()
    mirror_s = time.perf_counter() - t0
    build_s, real = [], cluster.ClusterIndex.refresh

    def timed_refresh(self, target):
        t0 = time.perf_counter()
        out = real(self, target)
        sync()
        build_s.append(time.perf_counter() - t0)
        return out
    cluster.ClusterIndex.refresh = timed_refresh
    try:
        zoned.enable_index()
    finally:
        cluster.ClusterIndex.refresh = real
    return zoned, mirror_s, build_s


def fleet_phase(torch, dev, st, *, sweep_full, sweep_default, twins, index):
    """Step 12: the fleet tier on the card.  (a) the fleet_scale sweep,
    (b) FleetServer end to end with faulty / clean twins against the CPU
    port, (c) the zone-sharded full_mix at step 9's 1,000,000 objects."""
    from repro_torch.core.query import Query, compile_query, execute_query
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import MetricsRegistry, set_registry

    out = {}
    # (a) session-tier sweep
    t0 = time.perf_counter()
    full = fleet_sweep(torch, dev, **sweep_full)
    default = fleet_sweep(torch, dev, **sweep_default)
    for C in (1, 8, 64, 256):
        b = default[C]["per_client_bytes"]
        check(b == FLEET_BYTES, f"per_client_bytes {b} at C={C} on the "
              f"default configuration (want {FLEET_BYTES})")
    out["sweep_full"] = full
    out["sweep_default"] = default
    out["sweep_s"] = time.perf_counter() - t0
    # a fenced span around one collect waits on the card's queued work
    from repro_torch.core import Knobs
    from repro_torch.core.store import synthetic_store
    from repro_torch.obs import Tracer, set_tracer
    from repro_torch.server import SessionManager
    sm = SessionManager(knobs=Knobs(), n_clients=64, capacity=512,
                        budget=32, device=dev)
    tr = Tracer(fenced=True)
    prev = set_tracer(tr)
    try:
        sm.collect(synthetic_store(256, 512, 256, 64, device=dev))
    finally:
        set_tracer(prev)
    check(len(tr.durations_ms("session.collect_fleet")) == 1,
          "a fenced collect span")
    out["fenced_collect_ms"] = tr.durations_ms("session.collect_fleet")[0]

    # (b) FleetServer end to end, card and CPU port
    t0 = time.perf_counter()
    dg, maps, counters, fs = fleet_twins(torch, dev, **twins)
    card_s = time.perf_counter() - t0
    pairs = twins["pairs"]
    for c in range(pairs):
        check(maps[c] == maps[c + pairs] and len(maps[c]) > 0,
              f"faulty twin {c + pairs} converged to clean twin {c}")
    t0 = time.perf_counter()
    dg_cpu, maps_cpu, counters_cpu, fs_cpu = fleet_twins(
        torch, torch.device("cpu"), **twins)
    cpu_s = time.perf_counter() - t0
    check(same_digest(dg, dg_cpu), "card = CPU port packets, tick by tick")
    check(maps == maps_cpu and counters == counters_cpu,
          "card = CPU port maps and fault counters")
    launches = {}
    for name, kw in (
            ("zones=(3,)", dict(zones=(3,), grid=Query.grid_of(fs.grid))),
            ("near two zones", dict(near=(torch.tensor([-2.0, 1.5, 0.0]),
                                          torch.tensor(1.0)))),
            ("all zones", {})):
        spec = Query(embed=fs.zoned.zones[0].embed[0], k=5, **kw)
        shards = compile_query(spec, fs.zoned).shards
        ops.reset_launch_counts()
        got = fs.query(spec)
        torch.cuda.synchronize()
        n = ops.launch_counts()["query_topk_bias"]
        check(n == len(shards), f"FleetServer.query {name}: {n} launches "
              f"for {len(shards)} flat shards")
        want = fs_cpu.query(Query(embed=fs_cpu.zoned.zones[0].embed[0], k=5,
                                  **kw))
        same_topk(torch, got, want)
        launches[name] = {"shards": list(shards), "launches": n}
    out["fleet_server"] = {
        "clients": 2 * pairs, "ticks": twins["ticks"],
        "settle": twins["settle"], "objects": twins["n_objects"],
        "twins_converged": True, "card_eq_cpu_port": True,
        "map_sizes": [len(m) for m in maps],
        "packets": sum(len(d) for d in dg),
        "faulty_counters": counters, "card_s": card_s, "cpu_port_s": cpu_s,
        "query_launches": launches}

    # (c) the zone-sharded full_mix at 1M objects
    qi = query_object(st)
    spec = full_mix(torch, st, qi)
    zoned, mirror_s, build_s = zoned_mirror(torch, dev, st, index["n"],
                                            index)
    capz = zoned.zone_capacity
    plan = compile_query(spec, zoned)
    reg = MetricsRegistry()
    prev = set_registry(reg)
    ops.reset_launch_counts()
    got = plan(zoned)
    torch.cuda.synchronize()
    set_registry(prev)
    n_launch = ops.launch_counts()["query_topk_bias"]
    rounds = len(plan.shards) \
        + reg.counter("query_index_escalations_total").total()
    engaged = all(zoned.indexes[z].engaged() for z in plan.shards)
    check(engaged, "every zone index engages at 1M")
    check(n_launch == 2 * rounds, f"sharded full_mix: {n_launch} "
          f"query_topk_bias launches for {rounds} two-stage rounds")
    flat = execute_query(st, spec)
    check(torch.equal(got.oids.cpu(), flat.oids.cpu()),
          "zoned full_mix oids = step 9's flat sweep")
    fin = torch.isfinite(flat.scores)
    err = float((got.scores[fin] - flat.scores[fin]).abs().max())
    check(err <= SCORE_TOL and torch.equal(torch.isfinite(got.scores), fin),
          f"zoned full_mix scores err {err}")
    for r in range(got.slots.shape[0]):
        g = int(got.slots[r])
        if g >= 0:
            z, loc = divmod(g, capz)
            check(int(zoned.zones[z].ids[loc]) == int(got.oids[r]),
                  "global slot = zone * zone_capacity + slot")
    ms = host_ms(torch, lambda: plan(zoned), index["reps"])
    zone_objects = [int(z.active.sum()) for z in zoned.zones]
    del zoned, plan
    geom = {k: index[k] for k in ("embed_dim", "max_points", "room")}
    (gst, gz), (cst, cz) = [
        (x, zoned_mirror(torch, d, x, index["cross_n"], index)[0])
        for d in (dev, torch.device("cpu"))
        for x in (clustered(index["cross_n"], d, **geom),)]
    qc = query_object(cst)
    cg = compile_query(full_mix(torch, gst, qc), gz)(gz)
    cc = compile_query(full_mix(torch, cst, qc), cz)(cz)
    cross = {"objects": index["cross_n"],
             "score_max_abs_err": same_topk(torch, cg, cc)}
    check(cross["score_max_abs_err"] <= SCORE_TOL, "zoned card = CPU port")
    out["sharded_query"] = {
        "objects": index["n"], "zones": 4, "zone_capacity": capz,
        "zone_objects": zone_objects,
        "mirror_s": mirror_s, "build_s_per_zone": build_s,
        "ms_p50": float(np.percentile(ms, 50)),
        "ms_p95": float(np.percentile(ms, 95)),
        "launches": n_launch, "rounds": rounds,
        "max_abs_err_vs_flat": err, "cross_device": cross}
    emit("fleet_phase", out)
    return out


# ---------------------------------------------------------------- build
# ----------------------------------------------------------------- step 13
def tick_ms(wall_ms) -> dict:
    return {"ticks": len(wall_ms),
            "tick_ms_p50": float(np.percentile(wall_ms, 50)),
            "tick_ms_p95": float(np.percentile(wall_ms, 95))}


def span_split(tracer, n_ticks: int) -> dict:
    """Host ms a tick in each traced span name (spans nest: an inner span's
    time is inside its parent's)."""
    acc = {}
    for name, _, t0, t1, _, _ in tracer.events:
        acc[name] = acc.get(name, 0.0) + (t1 - t0) * 1e3
    return {k: v / n_ticks for k, v in sorted(acc.items())}


def converged(eng) -> bool:
    """Every client's map holds exactly the world's live set."""
    live = eng.world.live_ids()
    return all(set(m.ids.cpu().numpy()[m.active.cpu().numpy()].tolist())
               == live for m in (s.dev.local for s in eng.sessions.values()))


def network_drop_run(torch, dev, cfg, noise=None):
    """examples/network_drop_session.py's scenario on ``dev``: the mapper
    over the 240x320 keyframes, the stream cut after tick 8."""
    from repro_torch.core import Knobs, MappingServer
    from repro_torch.data.scenes import make_scene, scene_stream
    from repro_torch.perception.embedder import OracleEmbedder
    from repro_torch.sim import (ClientSpec, GridSpec, NetTrace, ObjectEvent,
                                 PoseTrack, QueryPlan, Scenario,
                                 ScenarioEngine)

    scene = make_scene(n_objects=cfg["n_objects"], seed=cfg["scene_seed"])
    classes = {o.oid: o.class_id for o in scene.objects}
    E = cfg["embed_dim"]
    emb = OracleEmbedder(embed_dim=E)
    kn = Knobs(**cfg["knobs"])
    srv = MappingServer(knobs=kn, embedder=emb, device=dev)
    frames = list(scene_stream(scene, n_frames=cfg["n_frames"],
                               keyframe_interval=cfg["keyframe_interval"],
                               h=cfg["h"], w=cfg["w"]))
    sc = Scenario(
        seed=0, n_ticks=len(frames), tick_s=1.0, embed_dim=E, knobs=kn,
        grid=GridSpec(room=scene.room_size, nx=1, nz=1), budget=64,
        clients=(ClientSpec(
            cid=0, net=NetTrace(rtt_ms=20.0, outages=((4.0, 8.0),)),
            track=PoseTrack(anchor=(0.0, 1.5, 0.0), orbit_radius=0.0),
            subscribe_radius=scene.room_size),),
        events=(ObjectEvent(tick=9, kind="remove", oid=1),
                ObjectEvent(tick=9, kind="remove", oid=2)),
        query=QueryPlan(prob=0.6, radius=scene.room_size, k=3))
    eng = ScenarioEngine(sc, mapper=srv,
                         frames=frames[:cfg["stream_ticks"]],
                         classes=classes, embedder=emb, noise=noise,
                         device=dev)
    return eng.run(), eng


def sim_phase(torch, dev, *, deployment):
    """Step 13: the scenario engine on the card.  (a) The golden churn
    scenario: the committed snapshot, card = card, card = CPU port,
    ``async_loop`` = sequential.  (b) scenario_suite's arms: the
    reference's sent bytes on small and mid, large = CPU port; engine tick
    ms.  (c) fault_tolerance's loss sweep and crash arm: the reference's
    down bytes, every arm converged.  (d) The network-drop session, card =
    CPU port with the same host-drawn noise, every SQ / LQ answer = the CPU
    port's and held to the plain version; one lift_compact launch per
    mapped keyframe and one query_topk_bias launch per SQ and LQ.  (e)
    FleetSimulator at the paper's deployment over step 3's keyframes:
    stats, tick ms, both kernels launched, every query_topk_bias call
    held to the plain version, the card's MetricsLog and SQ answers
    = the CPU port's over the first ticks."""
    from repro_torch.core import Knobs, MappingServer
    from repro_torch.data.scenes import make_scene, scene_stream
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import MetricsRegistry, set_registry
    from repro_torch.obs.trace import Tracer, set_tracer
    from repro_torch.perception.embedder import OracleEmbedder
    from repro_torch.server import FleetSimulator, ZoneGrid
    from repro_torch.serving.batching import resolve_results
    from repro_torch.sim import (CrashEvent, FaultModel, MetricsLog,
                                 ScenarioEngine, churn_scenario,
                                 run_scenario)

    cpu = torch.device("cpu")
    out = {}

    # (a) the golden churn scenario
    sc = churn_scenario(**GOLDEN)
    t0 = time.perf_counter()
    card = run_scenario(sc, device=dev)
    card_s = time.perf_counter() - t0
    again = run_scenario(sc, device=dev)
    overlapped = run_scenario(sc, device=dev, async_loop=True)
    t0 = time.perf_counter()
    host = run_scenario(sc, device=cpu)
    cpu_s = time.perf_counter() - t0
    try:
        card.assert_matches_snapshot(json.loads(GOLDEN_SNAPSHOT.read_text()))
    except AssertionError as e:
        check(False, f"golden: {e}")
    check(card.equals(again), f"golden: card != card in {card.diff(again)}")
    check(card.equals(host), f"golden: card != CPU port in {card.diff(host)}")
    check(card.equals(overlapped),
          f"golden: async_loop != sequential in {card.diff(overlapped)}")
    out["golden"] = {"summary": card.summary(), "card_s": card_s,
                     "cpu_s": cpu_s}

    # (b) scenario_suite's arms
    out["suite"] = {}
    for name, kw, want in SUITE:
        kn = Knobs(**SUITE_KNOBS) if name == "large" else None
        sc = churn_scenario(knobs=kn, **kw)
        eng = ScenarioEngine(sc, device=dev)
        t0 = time.perf_counter()
        log = eng.run()
        row = {"card_s": time.perf_counter() - t0, **tick_ms(eng.wall_ms),
               "sent_bytes_total": log.summary()["exact"]["sent_bytes_total"],
               "converged": converged(eng)}
        check(row["converged"], f"scenario_suite {name}: converged")
        if want is not None:
            check(row["sent_bytes_total"] == want,
                  f"scenario_suite {name}: sent_bytes_total "
                  f"{row['sent_bytes_total']} != {want}")
        else:
            t0 = time.perf_counter()
            host = run_scenario(sc, device=cpu)
            row["cpu_s"] = time.perf_counter() - t0
            check(log.equals(host), f"scenario_suite {name}: card != CPU "
                  f"port in {log.diff(host)}")
        out["suite"][name] = row

    # (c) fault_tolerance's arms
    out["fault_tolerance"] = {}
    for loss, crash, want in FAULT_ARMS:
        crashes = (CrashEvent(tick=FAULT_SHAPE["n_ticks"] // 2, cid=1,
                              down_ticks=2),) if crash else ()
        eng = ScenarioEngine(churn_scenario(
            faults=FaultModel(seed=30, loss_prob=loss),
            crash_events=crashes, **FAULT_SHAPE), device=dev)
        log = eng.run()
        s = log.summary()["exact"]
        name = f"crash+loss={loss:g}" if crash else f"loss={loss:g}"
        row = {"down_bytes": s["sent_bytes_total"],
               "up_bytes": s["up_bytes_total"],
               "packets_lost": s["packets_lost"],
               "resync_requests": s["resync_requests"],
               "converged": converged(eng), **tick_ms(eng.wall_ms)}
        check(row["converged"], f"fault_tolerance {name}: converged")
        check(row["down_bytes"] == want, f"fault_tolerance {name}: "
              f"down_bytes {row['down_bytes']} != {want}")
        out["fault_tolerance"][name] = row

    # (d) the network-drop session; every SQ / LQ answer is recorded on
    # both devices (the mapper path scores no hit against a world)
    reg = MetricsRegistry()
    prev = set_registry(reg)
    ops.reset_launch_counts()
    run = {}
    calls = topk_spy(ops, lambda: run.update(
        card=network_drop_run(torch, dev, NETWORK_DROP)))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    set_registry(prev)
    log, eng = run["card"]
    mapped = reg.histogram("mapping_stage_ms").count(stage="ingest",
                                                     mode="semanticxr")
    s = log.summary()["exact"]
    t0 = time.perf_counter()
    host_calls = topk_spy(ops, lambda: run.update(
        cpu=network_drop_run(torch, cpu, NETWORK_DROP)), keep=lambda i: False)
    cpu_s = time.perf_counter() - t0
    host = run["cpu"][0]
    check(log.equals(host),
          f"network drop: card != CPU port in {log.diff(host)}")
    answers_err = same_topk_answers(torch, calls, host_calls)
    check(0.0 <= answers_err <= SCORE_TOL,
          f"network drop: card's SQ / LQ answers != the CPU port's "
          f"(err {answers_err})")
    held = hold_topk_calls(torch, calls, "network drop")
    check(mapped > 0 and counts["lift_compact"] == mapped,
          f"network drop: {counts['lift_compact']} lift_compact launches "
          f"for {mapped} mapped keyframes")
    queries = s["sq_queries"] + s["lq_queries"]
    check(s["sq_queries"] > 0 and s["lq_queries"] > 0
          and counts["query_topk_bias"] == queries,
          f"network drop: {counts['query_topk_bias']} query_topk_bias "
          f"launches for {s['sq_queries']} SQ + {s['lq_queries']} LQ")
    check(int(log.sent_tomb_bytes[9:].sum()) == 18,
          "network drop: two 9-byte tombstones on the wire")
    out["network_drop"] = {"summary": s, "mapped_keyframes": mapped,
                           "launches": counts, "cpu_s": cpu_s,
                           "answers_max_err_vs_cpu": answers_err,
                           "held_to_plain": held,
                           **tick_ms(eng.wall_ms)}

    # (e) FleetSimulator at the paper's deployment
    kn, E = Knobs(), deployment["embed_dim"]
    scene = make_scene(n_objects=deployment["n_objects"], seed=0)
    classes = {o.oid: o.class_id for o in scene.objects}
    frames = list(scene_stream(
        scene, n_frames=deployment["n_frames"],
        keyframe_interval=deployment["keyframe_interval"],
        h=deployment["h"], w=deployment["w"]))
    emb = OracleEmbedder(embed_dim=E)
    grid = ZoneGrid.for_room(scene.room_size, 2, 2)
    mk = lambda d: FleetSimulator(                         # noqa: E731
        knobs=kn, embed_dim=E, n_clients=FLEET_SIM["n_clients"],
        seed=FLEET_SIM["seed"], grid=grid, device=d)
    sim = mk(dev)
    tracer = Tracer()                    # unfenced: host wall per span
    prev = set_tracer(tracer)
    ops.reset_launch_counts()
    run = {}
    t0 = time.perf_counter()
    calls = topk_spy(ops, lambda: run.update(stats=sim.run(
        n_ticks=len(frames), mapper=MappingServer(
            knobs=kn, embedder=emb, device=dev), frames=frames,
        embedder=emb, classes=classes)))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    set_tracer(prev)
    counts = ops.launch_counts()
    stats = run["stats"]
    held = hold_topk_calls(torch, calls, "FleetSimulator")
    check(counts["lift_compact"] > 0 and counts["query_topk_bias"] > 0,
          f"FleetSimulator launched both kernels: {counts}")
    check(stats["unserved"] == 0 and stats["served"] == stats["sq_queries"],
          "FleetSimulator: every SQ served")
    # the CPU port over the first ticks: the same clients (drawn for the
    # whole run), keyframes and per-tick noise, SQ through a scheduler as
    # the simulator routes it
    n = FLEET_SIM["cross_ticks"]
    host_sim = mk(cpu)
    host_sim._build_clients(len(frames))
    host_map = MappingServer(knobs=kn, embedder=emb, device=cpu)
    sched = host_sim._build_scheduler(lambda: host_map.store)
    t0 = time.perf_counter()
    host = ScenarioEngine(
        dataclasses.replace(host_sim._scenario(len(frames)), n_ticks=n),
        mapper=host_map, frames=frames[:n], classes=classes, embedder=emb,
        server=host_sim.server, device=cpu,
        query_hook=lambda cid, t, spec: sched.submit(spec),
        tick_hook=lambda t: sched.step()).run()
    cpu_s = time.perf_counter() - t0
    head = MetricsLog(**{f: getattr(sim.log, f)[:n]
                         for f in MetricsLog._FIELDS})
    check(head.equals(host), f"FleetSimulator: card != CPU port over the "
          f"first {n} ticks in {head.diff(host)}")
    # every SQ of those ticks: the card's answer = the CPU port's
    want = resolve_results(sched.drain())
    got = resolve_results(sim.scheduler.done)
    sq_err = same_results({r: got[r] for r in want if r in got}, want,
                          exact=False)
    check(len(want) > 0 and 0.0 <= sq_err <= SCORE_TOL,
          f"FleetSimulator: the card's SQ answers over the first {n} ticks "
          f"!= the CPU port's ({len(want)} requests, err {sq_err})")
    out["fleet_simulator"] = {"stats": stats, "launches": counts,
                              "held_to_plain": held,
                              f"sq_answers_first_{n}_ticks": len(want),
                              "sq_answers_max_err_vs_cpu": sq_err,
                              "card_s": card_s,
                              f"cpu_s_first_{n}_ticks": cpu_s,
                              **tick_ms(sim.log.wall_ms),
                              "span_ms_per_tick": span_split(
                                  tracer, len(frames))}
    emit("sim_phase", out)
    return out


# ----------------------------------------------------------------- step 14
def serving_loop_build(torch, dev, cfg, *, overlap: bool, ticks: int):
    """benchmarks/serving_loop.py's ``_build`` on the port."""
    from repro_torch.core import Knobs
    from repro_torch.core.store import SnapshotStore, synthetic_store
    from repro_torch.server import FleetServer, ZoneGrid, ZoneShardedStore
    from repro_torch.serving.loadgen import LoadGenerator, LoadSpec
    from repro_torch.serving.loop import IngestStream, ServingLoop

    kn = Knobs(server_capacity=cfg["cap"],
               client_capacity=max(cfg["budget"] * 2, 64),
               max_object_points_server=cfg["P"],
               max_object_points_client=max(cfg["P"] // 8, 8),
               min_obs_before_sync=1)
    store = synthetic_store(cfg["n_live"], cfg["cap"], cfg["E"], cfg["P"],
                            seed=7, centroid_low=(-7.0, 0.0, -7.0),
                            centroid_high=(7.0, 2.0, 7.0), device=dev)
    grid = ZoneGrid.for_room(16.0, cfg["nz"], cfg["nz"])
    zoned = ZoneShardedStore(knobs=kn, embed_dim=cfg["E"], grid=grid,
                             zone_capacity=cfg["zcap"], device=dev)
    srv = FleetServer(knobs=kn, embed_dim=cfg["E"], n_clients=cfg["C"],
                      grid=grid, budget=cfg["budget"], index=False,
                      zoned=zoned, device=dev)
    lg = LoadGenerator(LoadSpec(n_clients=cfg["C"], n_ticks=ticks,
                                base_hz=cfg["base_hz"],
                                burst_hz=cfg["burst_hz"]),
                       embed_dim=cfg["E"], device=dev)
    ing = IngestStream(n_ticks=ticks, n_live=cfg["n_live"],
                       embed_dim=cfg["E"], max_points=cfg["P"],
                       churn=cfg["churn"], seed=11, device=dev)
    snap = SnapshotStore.of(store) if overlap \
        else SnapshotStore(front=store)
    for c in range(cfg["C"]):
        srv.join(c, lg.pose_at(c, 0), 6.0)
    return ServingLoop(server=srv, store=snap, ingest=ing, loadgen=lg,
                       overlap=overlap, batch_size=cfg["batch"],
                       max_batches_per_tick=cfg["max_batches"])


def same_results(a: dict, b: dict, exact: bool) -> float:
    """Max |score| difference of two loops' per-request results; -1 when
    the request sets, oids or slots differ (or, ``exact``, any score)."""
    if set(a) != set(b):
        return -1.0
    err = 0.0
    for rid, r in a.items():
        o = b[rid]
        if not (np.array_equal(r.oids, o.oids)
                and np.array_equal(r.slots, o.slots)):
            return -1.0
        fin = np.isfinite(r.scores)
        if not np.array_equal(fin, np.isfinite(o.scores)):
            return -1.0
        d = float(np.abs(r.scores[fin] - o.scores[fin]).max()) \
            if fin.any() else 0.0
        if exact and not np.array_equal(r.scores, o.scores):
            return -1.0
        err = max(err, d)
    return err


def serving_loop_phase(torch, dev, cfg):
    """Step 14: the serving loop at benchmarks/serving_loop.py's non-smoke
    configuration.  The sync arm, then the overlapped arm (each after a
    short warm-up run): every per-request result byte-identical, equal
    sent bytes and final stores; ticks/s, tick ms, wait / e2e ms and the
    query_topk_bias launches; in each arm every ``hold_every``-th
    scheduler batch (the snapshot it read, its stacked queries and bias)
    held to the plain version.  Then the overlapped arm once more with
    ``enable_index`` (min_flat_size lowered so the 4096 live objects go
    two-stage): results equal to the flat run's.  Last, one mapped
    keyframe and one two-stage query under an installed registry: the
    mapping stage and index metrics land in it."""
    from repro_torch.core import Knobs, MappingServer, Query
    from repro_torch.core.query import execute_query
    from repro_torch.data.scenes import make_scene, scene_stream
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import MetricsRegistry, set_registry
    from repro_torch.obs.trace import Tracer, set_tracer
    from repro_torch.perception.embedder import OracleEmbedder

    def arm(overlap, index=False):
        warm = serving_loop_build(torch, dev, cfg, overlap=overlap,
                                  ticks=cfg["warm_ticks"])
        warm.run(cfg["warm_ticks"])
        loop = serving_loop_build(torch, dev, cfg, overlap=overlap,
                                  ticks=cfg["ticks"])
        if index:
            loop.enable_index(min_flat_size=cfg["index_min_flat"])
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        stats = {}
        calls = topk_spy(ops, lambda: stats.update(loop.run(cfg["ticks"])),
                         keep=lambda i: i % cfg["hold_every"] == 0)
        torch.cuda.synchronize()
        stats["launches"] = ops.launch_counts()
        stats["held_to_plain"] = hold_topk_calls(
            torch, calls, f"serving loop ({stats['mode']}"
            f"{', indexed' if index else ''})")
        return loop, stats

    sync, s_stats = arm(False)
    ovl, o_stats = arm(True)
    # where a tick goes: a traced sync run (each of its dispatches ends in
    # a synchronize, so a span holds its own device work)
    traced = serving_loop_build(torch, dev, cfg, overlap=False,
                                ticks=cfg["trace_ticks"])
    tracer = Tracer()
    prev = set_tracer(tracer)
    traced.run(cfg["trace_ticks"])
    set_tracer(prev)
    split = span_split(tracer, cfg["trace_ticks"])
    check(same_results(sync.results, ovl.results, exact=True) == 0.0,
          "serving loop: sync and overlapped results byte-identical")
    check(s_stats["n_queries_served"] == o_stats["n_queries_served"] > 0,
          "serving loop: every request served in both arms")
    check(s_stats["sent_bytes_total"] == o_stats["sent_bytes_total"] > 0,
          "serving loop: equal sent_bytes_total")
    check(all(torch.equal(a, b) for a, b in zip(sync.store.front,
                                                ovl.store.front)
              if a is not None), "serving loop: equal final stores")
    for st in (s_stats, o_stats):
        check(st["launches"]["query_topk_bias"] > 0,
              f"serving loop ({st['mode']}): query_topk_bias launched")

    reg = MetricsRegistry()
    prev = set_registry(reg)
    idx_loop, i_stats = arm(True, index=True)
    set_registry(prev)
    err = same_results(ovl.results, idx_loop.results, exact=False)
    check(0.0 <= err <= SCORE_TOL,
          f"serving loop: indexed results = flat results (err {err})")
    two_stage = reg.counter("query_index_two_stage_total").total()
    check(two_stage > 0, "serving loop: the index served two-stage")
    check(i_stats["sent_bytes_total"] == o_stats["sent_bytes_total"],
          "serving loop: indexed run's sent bytes")

    # the registry after one mapped keyframe and one two-stage query
    kn = Knobs(max_detections_per_frame=16)
    scene = make_scene(n_objects=25, seed=2)
    classes = {o.oid: o.class_id for o in scene.objects}
    frame = next(iter(scene_stream(scene, n_frames=5, keyframe_interval=5,
                                   h=240, w=320)))
    srv = MappingServer(knobs=kn, embedder=OracleEmbedder(embed_dim=256),
                        device=dev)
    st = idx_loop.store.front
    spec = Query(embed=st.embed[0], k=5)
    reg = MetricsRegistry()
    prev = set_registry(reg)
    srv.process_frame(frame, classes, torch.Generator().manual_seed(0))
    execute_query(st, spec, index=idx_loop.index)
    set_registry(prev)
    stages = reg.histogram("mapping_stage_ms")
    registry = {"mapping_stage_ms": {
        k: stages.count(stage=k, mode="semanticxr")
        for k in ("detect", "ingest")},
        "query_index_two_stage_total":
            reg.counter("query_index_two_stage_total").total(),
        "query_index_candidate_fraction":
            reg.histogram("query_index_candidate_fraction").summary()}
    check(registry["mapping_stage_ms"] == {"detect": 1, "ingest": 1},
          f"StageTimes.record in the registry: {registry}")
    check(registry["query_index_two_stage_total"] == 1
          and registry["query_index_candidate_fraction"]["n"] == 1,
          f"index metrics in the registry: {registry}")

    keep = ("ticks_per_s", "tick_ms", "wait_ms", "e2e_ms",
            "n_queries_served", "n_arrivals", "sent_bytes_total",
            "launches", "held_to_plain")
    out = {"config": {k: v for k, v in cfg.items()},
           "arms": {st["mode"]: {k: st[k] for k in keep}
                    for st in (s_stats, o_stats)},
           "indexed": {**{k: i_stats[k] for k in keep},
                       "two_stage_queries": two_stage,
                       "max_score_err_vs_flat": err},
           "overlap_speedup_x": o_stats["ticks_per_s"]
           / max(s_stats["ticks_per_s"], 1e-9),
           "sync_span_ms_per_tick": split,
           "registry": registry}
    emit("serving_loop_phase", out)
    return out


def kernel_resources(build) -> dict:
    """{source: {kernel: registers, static shared memory, spills}} from
    ptxas's ``-v`` report in each build log (dynamic shared memory is set
    at launch and not in it)."""
    import re

    out = {}
    for src in build.SOURCES:
        rows, name = {}, None
        for ln in build.build_log(src).splitlines():
            m = re.search(r"entry function '(\w+)'", ln)
            if m:
                name = demangle(m.group(1))
                rows[name] = {}
                continue
            if name is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
            if m:
                rows[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                rows[name]["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", ln)
                rows[name]["static_smem_bytes"] = int(m.group(1)) if m else 0
        out[src] = rows
    return out


def demangle(sym: str) -> str:
    """``..._18flash_wgmma_kernelILi64ELi3EEEv...`` -> ``flash_wgmma_kernel
    <64,3>``: the kernel's name and its integer or type template args."""
    import re

    for m in re.finditer(r"_kernel", sym):
        end = m.end()
        starts = [a for a in range(end - 1, 0, -1)
                  if sym[:a].endswith(str(end - a))]
        if not starts:
            continue
        name, at = sym[starts[0]:end], end
        if sym[at:at + 1] != "I":
            return name
        args, at = [], at + 1
        while at < len(sym) and sym[at] != "E":
            lit = re.match(r"L[a-z](\d+)E", sym[at:])    # Li64E, Lb1E
            ident = re.match(r"(\d+)", sym[at:])
            if lit:
                args.append(lit.group(1))
                at += lit.end()
            elif ident:
                k = int(ident.group(1))
                args.append(sym[at + ident.end():at + ident.end() + k])
                at += ident.end() + k
            else:
                args.append({"f": "float", "i": "int"}.get(sym[at], sym[at]))
                at += 1
        return f"{name}<{','.join(args)}>"
    return sym


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
    from repro_torch.configs.base import get_config
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
    emit("build", {"seconds": time.perf_counter() - t0})
    emit("kernel_resources", kernel_resources(build))

    clock = Clock(torch)
    # the floor of a kernel time on this clock: a one-element fill
    one = torch.empty(1, device=dev)
    emit("clock", {"empty_kernel_ms": clock.ms(lambda: one.fill_(0.0))})
    phase_s = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        phase_s[name] = time.perf_counter() - t0
        return out
    lift_row, topk_row = timed("kernel_checks", kernel_checks, torch, clock,
                               dev)
    any_k = timed("topk_any_k_checks", topk_any_k_checks, torch, clock, dev)
    flash_row = timed("attention_checks", attention_checks, torch, clock, dev)
    nd_row = timed("nearest_checks", nearest_checks, torch, clock, dev)
    nd_path = timed("nearest_phase", nearest_phase, torch, dev)
    knobs = Knobs()
    path, kept, snap, loop = timed("main_path", main_path, torch, dev, knobs,
                                   **DEPLOYMENT)
    timed("profile_phase", profile_phase, torch, dev, loop, **DEPLOYMENT)
    timed("query_phase", query_phase, torch, dev, **QUERY_STORE)
    timed("cross_device", cross_device, torch, knobs,
          DEPLOYMENT["embed_dim"], kept, snap, loop.classes)
    captioner = get_config("semanticxr-captioner-110m")
    serve = timed("serve_phase", serve_phase, torch, dev, captioner, **SERVE)
    timed("replay_phase", replay_phase, torch, dev, captioner, **REPLAY)
    index, st, idx, index_topk = timed("index_phase", index_phase, torch, dev,
                                       clock, **INDEX)
    timed("serving_phase", serving_phase, torch, dev, st, idx, **SERVING)
    del idx
    arms = timed("mapping_arms_phase", mapping_arms_phase, torch, dev, **ARMS)
    fleet = timed("fleet_phase", fleet_phase, torch, dev, st,
                  sweep_full=FLEET_FULL, sweep_default=FLEET_DEFAULT,
                  twins=TWINS, index=INDEX)
    del st
    sim = timed("sim_phase", sim_phase, torch, dev, deployment=DEPLOYMENT)
    loop_out = timed("serving_loop_phase", serving_loop_phase, torch, dev,
                     SERVING_LOOP)
    emit("phase_seconds", phase_s)
    print(smi, flush=True)          # again, inside the tail of a long log

    launches = path["launches"]
    kernels = [
        {"name": "lift_compact", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lift_compact.cu",
         "replaces": "src/repro/kernels/lift_compact.py:229",
         "launches": launches["lift_compact"],
         "launched_on": "step 3 main path", **lift_row,
         "mapping_arms_launches": {a: arms[a]["launches"]["lift_compact"]
                                   for a, _, _ in ARM_MODES},
         "sim_launches": {
             "network_drop": sim["network_drop"]["launches"]["lift_compact"],
             "fleet_simulator":
                 sim["fleet_simulator"]["launches"]["lift_compact"]}},
        {"name": "query_topk_bias", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/query_topk.cu",
         "replaces": "src/repro/kernels/query_topk.py:121",
         "launches": launches["query_topk_bias"],
         "launched_on": "step 3 main path", **topk_row,
         "index_launches": index["launches"]["query_topk_bias"],
         "index_shapes": index_topk, "any_k_shapes": any_k,
         "fleet_launches": {
             "fleet_server_query": fleet["fleet_server"]["query_launches"],
             "sharded_full_mix_1M": fleet["sharded_query"]["launches"]},
         "sim_launches": {
             "network_drop":
                 sim["network_drop"]["launches"]["query_topk_bias"],
             "fleet_simulator":
                 sim["fleet_simulator"]["launches"]["query_topk_bias"]},
         "serving_loop_launches": {
             mode: a["launches"]["query_topk_bias"]
             for mode, a in loop_out["arms"].items()}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:93",
         "launches": serve["launches"]["flash_attention"],
         "launched_on": "step 7 captioner serving path", **flash_row},
        {"name": "nearest_dist", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pairwise.cu",
         "replaces": "src/repro/kernels/pairwise.py:59",
         "launches": nd_path["launches"]["nearest_dist"],
         "launched_on": "its own phase: ops.nearest_dist is its whole path "
                        "(no system path calls it)", **nd_row},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
