"""Object-level geometry: depth lifting, downsampling, centroids/bboxes,
cloud merges.

Port of ``repro.core.geometry`` with the object batch written out: every
function takes a leading ``[B]`` dimension where the reference vmapped a
per-object function (``lift_depth`` and ``bbox_pixel_area`` also take one
unbatched mask).  Per-object point clouds live in fixed-capacity masked
buffers (capacity == the max_object_points knob), so downsampling is a
deterministic stride gather.  The production ingest path lifts in the fused
``kernels/lift_compact``; ``lift_depth`` serves the B / B+P ablation arms,
and ``merge_clouds_argsort`` is the seed merge the sequential association
oracle uses.
"""
from __future__ import annotations

import torch

BIG = 1e9


def _gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, P, 3], idx [B, K] -> points[b, idx[b]] as [B, K, 3]."""
    return torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, 3))


def lift_depth(depth: torch.Tensor, mask: torch.Tensor,
               intrinsics: torch.Tensor, pose: torch.Tensor, *,
               stride: int = 1, max_points: int = 2048):
    """Back-project masked depth pixels to world points.

    depth [H, W] metres; mask [H, W] or [B, H, W] bool instance masks;
    intrinsics [fx, fy, cx, cy] at full resolution; pose [4, 4] cam->world;
    ``stride``: the depth's downsampling factor per dim.  The first
    ``max_points`` valid pixels in raster order are taken (the reference's
    stable ``argsort(~valid)``).  Returns (points [(B,) max_points, 3],
    n [(B,)] int32, valid [(B,) max_points] bool); with H*W < max_points the
    point dim is H*W, as in the reference.
    """
    single = mask.dim() == 2
    masks = mask[None] if single else mask
    H, W = depth.shape
    dev = depth.device
    fx, fy, cx, cy = intrinsics
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    xs_full = (xs.to(torch.float32) + 0.5) * stride
    ys_full = (ys.to(torch.float32) + 0.5) * stride
    z = depth
    x = (xs_full - cx) / fx * z
    y = (ys_full - cy) / fy * z
    pts_cam = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    pts_w = pts_cam @ pose[:3, :3].T + pose[:3, 3]              # [HW, 3]
    valid = (masks & (z > 1e-4)).reshape(masks.shape[0], -1)    # [B, HW]
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    take = order[:, :max_points]
    ok = torch.gather(valid, 1, take)
    pts = torch.where(ok[..., None], pts_w[take], 0.0)
    n = torch.clamp(valid.sum(dim=1), max=max_points).to(torch.int32)
    if single:
        return pts[0], n[0], ok[0]
    return pts, n, ok


def downsample(points: torch.Tensor, n: torch.Tensor, budget: int):
    """Cap masked clouds at ``budget`` points (Sec. 3.1).

    points [B, P, 3], n [B].  Output slot i reads floor(i * n / budget)
    when n > budget, else i.  Returns (points [B, budget, 3], n_out [B]).
    """
    return downsample_dyn(points, n, torch.full_like(n, budget), budget)


def downsample_dyn(points: torch.Tensor, n: torch.Tensor,
                   budget: torch.Tensor, out_cap: int):
    """``downsample`` with a per-row budget [B] (<= out_cap): the budget
    shapes only the valid prefix of the [B, out_cap, 3] output, so a
    mixed-class update packet is one gather.
    Returns (points [B, out_cap, 3], n_out [B] int32)."""
    P = points.shape[1]
    n = torch.clamp(n.long(), min=1)[:, None]
    b = torch.clamp(torch.clamp(budget.long(), max=out_cap), min=1)[:, None]
    ar = torch.arange(out_cap, device=points.device)[None, :]
    idx = torch.where(n > b, (ar * n) // b, ar)
    idx = torch.clamp(idx, max=P - 1)
    out = _gather_rows(points, idx)
    n_out = torch.minimum(n, b)
    valid = ar < n_out
    out = torch.where(valid[..., None], out, 0.0)
    return out, n_out[:, 0].to(torch.int32)


def centroid_bbox(points: torch.Tensor, n: torch.Tensor):
    """(centroid [B, 3], bbox_min [B, 3], bbox_max [B, 3]) of masked clouds."""
    P = points.shape[1]
    valid = (torch.arange(P, device=points.device)[None, :]
             < n[:, None])[..., None]
    denom = torch.clamp(n, min=1).to(torch.float32)[:, None]
    c = torch.where(valid, points, 0.0).sum(dim=1) / denom
    mn = torch.where(valid, points, BIG).amin(dim=1)
    mx = torch.where(valid, points, -BIG).amax(dim=1)
    nz = (n > 0)[:, None]
    return c, torch.where(nz, mn, 0.0), torch.where(nz, mx, 0.0)


def merge_clouds(pts_a, n_a, pts_b, n_b, budget: int):
    """Merge two masked clouds per row and re-cap at budget (association
    merge).  Validity is positional, so the merged cloud's row i is
    ``a[i]`` for i < n_a else ``b[i - n_a]``; composing that with the
    downsample stride gather gives the merge as two gathers and a select.
    pts_a [B, Pa, 3], pts_b [B, Pb, 3]; returns (points [B, budget, 3],
    n_out [B] int32)."""
    Pa = min(budget, pts_a.shape[1])
    Pb = pts_b.shape[1]
    n_a = torch.clamp(n_a.long(), max=Pa)[:, None]
    n = torch.clamp(n_a + torch.clamp(n_b.long(), max=Pb)[:, None],
                    max=Pa + Pb)
    nn = torch.clamp(n, min=1)              # downsample's empty-cloud quirk
    ar = torch.arange(budget, device=pts_a.device)[None, :]
    idx = torch.where(nn > budget, (ar * nn) // budget, ar)
    from_a = idx < n_a
    out = torch.where(from_a[..., None],
                      _gather_rows(pts_a, torch.clamp(idx, max=Pa - 1)),
                      _gather_rows(pts_b, torch.clamp(idx - n_a, 0, Pb - 1)))
    n_out = torch.clamp(nn, max=budget)
    valid = ar < n_out
    out = torch.where(valid[..., None], out, 0.0)
    return out, n_out[:, 0].to(torch.int32)


def merge_clouds_argsort(pts_a, n_a, pts_b, n_b, budget: int):
    """Seed form of ``merge_clouds``: concatenate, compact the valid rows to
    the front by a stable sort, then downsample.  Rows of [B]."""
    a = pts_a[:, :budget]
    both = torch.cat([a, pts_b], dim=1)
    dev = both.device
    va = torch.arange(a.shape[1], device=dev)[None, :] < n_a[:, None]
    vb = torch.arange(pts_b.shape[1], device=dev)[None, :] < n_b[:, None]
    valid = torch.cat([va, vb], dim=1)
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    both = _gather_rows(both, order)
    n = (n_a + n_b).to(torch.int32)
    return downsample(both, torch.clamp(n, max=both.shape[1]), budget)


def bbox_pixel_area(mask: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Projected bbox area of instance masks [(B,) H, W] in full-res pixel
    units (the min_mapping_bbox_area gate): int32 [(B,)]."""
    def extent(v):
        L = v.shape[-1]
        idx = torch.arange(L, device=v.device)
        mn = torch.where(v, idx, L).amin(dim=-1)
        mx = torch.where(v, idx, -1).amax(dim=-1)
        return torch.clamp(mx - mn + 1, min=0)
    area = extent(mask.any(dim=-1)) * extent(mask.any(dim=-2))
    return (area * (stride * stride)).to(torch.int32)
