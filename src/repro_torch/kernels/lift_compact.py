"""Fused frame-ingest geometry: lift -> compact -> downsample -> stats.

Port of ``repro.kernels.lift_compact``.  One pass over the depth frame
serves all D detections: per-object compaction by prefix-count destination
indexing (the r-th valid pixel of object d has rank r, no sort), the stride
downsample to the point budget folded into the same indexing (rank r is
kept iff ``ceil(r * budget / n)`` maps back to r under
``floor(i * n / budget)``), and centroid / bbox over the kept points.  A
detection with zero valid pixels gets n = 0.

Two implementations of the same function:

  * ``lift_compact_cuda`` — the hand-written Hopper kernel
    (``csrc/lift_compact.cu``; it replaces the TPU kernel
    ``repro/kernels/lift_compact.py::lift_compact_pallas``): one launch,
    one thread-block cluster per object, cut by ``work_split``.
  * ``lift_compact_plain`` — plain PyTorch, a port of the reference's
    ``lift_compact_xla`` (cumsum, then a searchsorted from rank to pixel,
    then a gather), which is what ``repro.kernels.ops.lift_compact`` runs
    off the TPU; end-to-end store parity needs its arithmetic.

``kernels.ops.lift_compact`` picks by the tensors' device.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

BIG = 1e9
Z_EPS = 1e-4          # matches the reference's valid-depth floor

PIX = 16              # pixels a thread holds per chunk: one 16-byte load
MAX_THREADS = 512     # threads per block (csrc/lift_compact.cu kMaxThreads)
MAX_CLUSTER = 8       # blocks per object: the portable cluster size
H100_SMS = 132

launches = 0          # kernel launches made by lift_compact_cuda

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "lift_compact_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _P, _P, _P, _P, _P, _P], _I),
}


class Split(NamedTuple):
    cluster: int      # blocks per object (one thread-block cluster)
    share: int        # pixels per block, a multiple of PIX
    threads: int      # threads per block
    ranges: tuple     # each block's [begin, end) pixel range, in rank order


def work_split(h: int, w: int, d: int, sms: int = H100_SMS) -> Split:
    """How the kernel cuts one object's H*W pixels among the blocks of its
    cluster.  Enough blocks that one chunk of MAX_THREADS * PIX pixels
    holds a block's share where it can (then the masks are read once),
    and at least two blocks an SM in all where MAX_CLUSTER allows; no more
    than one block per 512 pixels.  A share past one chunk is walked in
    chunks by the kernel."""
    hw = h * w
    c = max(-(-hw // (MAX_THREADS * PIX)), -(-2 * sms // max(d, 1)))
    c = max(1, min(c, MAX_CLUSTER, -(-hw // (32 * PIX))))
    share = -(-(-(-hw // c)) // PIX) * PIX
    threads = min(MAX_THREADS, -(-share // (32 * PIX)) * 32)
    ranges = tuple((min(r * share, hw), min((r + 1) * share, hw))
                   for r in range(c))
    return Split(c, share, threads, ranges)


def lift_compact_plain(depth: torch.Tensor, masks: torch.Tensor,
                       intrinsics: torch.Tensor, pose: torch.Tensor, *,
                       stride: int = 1, budget: int, lift_cap: int = 4096):
    """depth [H, W]; masks [D, H, W] bool; intrinsics [fx, fy, cx, cy] at
    FULL resolution; pose [4, 4] cam->world.

    Returns (points [D, budget, 3], n [D] int32, centroid [D, 3],
    bbox_min [D, 3], bbox_max [D, 3]).  Only the <= D * budget selected
    pixels are back-projected: no [D, H*W, 3] intermediate.
    """
    D = masks.shape[0]
    H, W = depth.shape
    HW = H * W
    dev = depth.device
    fx, fy, cx, cy = intrinsics.to(torch.float32)
    z_flat = depth.reshape(HW)
    v = masks.reshape(D, HW).to(torch.bool) & (z_flat > Z_EPS)[None, :]
    c = torch.cumsum(v.to(torch.int32), dim=1, dtype=torch.int32)  # inclusive
    n = torch.clamp(c[:, -1], max=lift_cap)                        # [D]
    n_out = torch.clamp(n, max=budget).to(torch.int32)

    i = torch.arange(budget, dtype=torch.int32, device=dev)[None, :]
    nn = n[:, None]
    r = torch.where(nn > budget, (i * nn) // budget, i.expand(D, budget))
    # pixel of rank r = first j with c[j] == r + 1 (c is nondecreasing)
    pix = torch.searchsorted(c, (r + 1).to(torch.int32), side="left")
    pix = torch.clamp(pix, max=HW - 1)                             # padding

    zb = z_flat[pix]                                               # [D, B]
    xs_full = ((pix % W).to(torch.float32) + 0.5) * stride
    ys_full = ((pix // W).to(torch.float32) + 0.5) * stride
    x = (xs_full - cx) / fx * zb
    y = (ys_full - cy) / fy * zb
    pts_cam = torch.stack([x, y, zb], dim=-1)                      # [D, B, 3]
    pose = pose.to(torch.float32)
    pts_w = pts_cam @ pose[:3, :3].T + pose[:3, 3]

    valid = (i < n_out[:, None])[..., None]
    pts = torch.where(valid, pts_w, 0.0)
    denom = torch.clamp(n_out, min=1).to(torch.float32)[:, None]
    cent = pts.sum(dim=1) / denom
    mn = torch.where(valid, pts_w, BIG).amin(dim=1)
    mx = torch.where(valid, pts_w, -BIG).amax(dim=1)
    nz = (n_out > 0)[:, None]
    return (pts, n_out, cent,
            torch.where(nz, mn, 0.0), torch.where(nz, mx, 0.0))


def lift_compact_cuda(depth: torch.Tensor, masks: torch.Tensor,
                      intrinsics: torch.Tensor, pose: torch.Tensor, *,
                      stride: int = 1, budget: int, lift_cap: int = 4096):
    """The hand-written kernel (same contract as ``lift_compact_plain``);
    all inputs on one CUDA device, f32 and contiguous, masks bool/uint8."""
    global launches
    dev = depth.device
    if dev.type != "cuda":
        raise ValueError(f"lift_compact_cuda needs CUDA tensors, got {dev}")
    D, H, W = masks.shape
    for name, t, shape in (("depth", depth, (H, W)),
                           ("intrinsics", intrinsics, (4,)),
                           ("pose", pose, (4, 4))):
        build.check_arg("lift_compact", name, t, (torch.float32,), shape,
                        dev)
    build.check_arg("lift_compact", "masks", masks,
                    (torch.bool, torch.uint8), (D, H, W), dev)
    if not (0 < budget and 0 < lift_cap and lift_cap * budget < 2 ** 31
            and H * W < 2 ** 31 and 0 < H * W and D < 65536):
        raise ValueError(f"lift_compact: unsupported sizes D={D} HW={H * W} "
                         f"budget={budget} lift_cap={lift_cap}")
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    points = torch.empty((D, budget, 3), **f32)
    n_out = torch.empty((D,), **i32)
    cent = torch.empty((D, 3), **f32)
    bmin = torch.empty((D, 3), **f32)
    bmax = torch.empty((D, 3), **f32)
    if D == 0:
        return points, n_out, cent, bmin, bmax
    lib = build.load("lift_compact", _SIGNATURES)
    split = work_split(H, W, D, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lift_compact_launch(
        depth.data_ptr(), masks.data_ptr(), intrinsics.data_ptr(),
        pose.data_ptr(), D, H, W, int(stride), int(budget), int(lift_cap),
        split.cluster, split.share, split.threads, points.data_ptr(),
        n_out.data_ptr(), cent.data_ptr(), bmin.data_ptr(), bmax.data_ptr(),
        stream)
    if err != 0:
        raise RuntimeError(f"lift_compact kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return points, n_out, cent, bmin, bmax
