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
   the card and on the CPU port: the same tokens, logits within 1e-4.

``nearest_dist`` has no caller on any system path: its phase drives its
entry point, ``ops.nearest_dist``, at a chamfer and a centroid shape.

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
ND_TOL = 1e-4            # nearest_dist: |a|^2 + |b|^2 - 2ab in another order
LOGIT_TOL = 1e-4         # step 8: f32 logits, 12 layers in another order
PROFILE_KEYFRAMES = 4    # keyframes timed by stage, then as many profiled
PROFILE_DECODE = 8       # decode steps under the profiler (step 7)
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


# ---------------------------------------------------------------- build
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
    lift_row, topk_row = kernel_checks(torch, clock, dev)
    flash_row = attention_checks(torch, clock, dev)
    nd_row = nearest_checks(torch, clock, dev)
    nd_path = nearest_phase(torch, dev)
    knobs = Knobs()
    path, kept, snap, loop = main_path(torch, dev, knobs, **DEPLOYMENT)
    profile_phase(torch, dev, loop, **DEPLOYMENT)
    query_phase(torch, dev, **QUERY_STORE)
    cross_device(torch, knobs, DEPLOYMENT["embed_dim"], kept, snap,
                 loop.classes)
    captioner = get_config("semanticxr-captioner-110m")
    serve = serve_phase(torch, dev, captioner, **SERVE)
    replay_phase(torch, dev, captioner, **REPLAY)

    launches = path["launches"]
    kernels = [
        {"name": "lift_compact", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lift_compact.cu",
         "replaces": "src/repro/kernels/lift_compact.py:229",
         "launches": launches["lift_compact"],
         "launched_on": "step 3 main path", **lift_row},
        {"name": "query_topk_bias", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/query_topk.cu",
         "replaces": "src/repro/kernels/query_topk.py:121",
         "launches": launches["query_topk_bias"],
         "launched_on": "step 3 main path", **topk_row},
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
