"""Object-level geometry: downsampling, centroids/bboxes, cloud merges.

Port of ``repro.core.geometry`` with the object batch written out: every
function takes a leading ``[B]`` dimension where the reference vmapped a
per-object function.  Per-object point clouds live in fixed-capacity masked
buffers (capacity == the max_object_points knob), so downsampling is a
deterministic stride gather.  Depth lifting lives in the fused
``kernels/lift_compact`` path.
"""
from __future__ import annotations

import torch

BIG = 1e9


def _gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, P, 3], idx [B, K] -> points[b, idx[b]] as [B, K, 3]."""
    return torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, 3))


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
