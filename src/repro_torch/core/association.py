"""Incremental object association + merge (paper Sec. 2.3.1 / 3.1).

Port of ``repro.core.association``: the batched ``associate`` and the
seed's sequential-scan ``associate_reference`` (the oracle the batched
path equals on conflict-free frames).  Per-frame
detections are matched to map objects by combined spatial proximity
(centroid distance) and semantic similarity (embedding cosine) over a
[D, cap] score matrix; the resolve is fully batched: first-index argmax per
detection, within-frame conflicts to the highest-scoring claimant, one
batched merge, free-slot assignment for inserts in detection order, and one
masked write per store field.

Tie rules follow the reference: argmax / argmin return the FIRST extreme
index (``first_argmax``), and free slots are taken in ascending order via a
stable sort.  JAX drops the non-writing rows it sends to index ``cap``;
here those rows are masked out before the write.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import geometry as geo
from repro_torch.core import store as store_mod
from repro_torch.core.store import ObjectStore


class Detections(NamedTuple):
    """Fixed-capacity batch of per-frame object observations."""
    embed: torch.Tensor      # [D, E] f32 unit-norm
    label: torch.Tensor      # [D] int32
    points: torch.Tensor     # [D, P, 3]
    n_points: torch.Tensor   # [D] int32
    valid: torch.Tensor      # [D] bool


def first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first maximum along ``dim`` (``jnp.argmax``'s rule,
    stated here rather than left to a backend's tie order)."""
    mx = x.amax(dim=dim, keepdim=True)
    ar = torch.arange(x.shape[dim], device=x.device)
    ar = ar.view([-1 if i == (dim % x.dim()) else 1 for i in range(x.dim())])
    return torch.where(x == mx, ar, x.shape[dim]).amin(dim=dim)


def association_scores(store: ObjectStore, det: Detections, *,
                       spatial_sigma: float = 0.75, det_centroid=None):
    """[D, cap] combined match score in [0, 1]; inactive slots = -inf.
    ``det_centroid`` ([D, 3]) skips the centroid pass when the fused lift
    kernel already produced it."""
    if det_centroid is not None:
        cent_d = det_centroid
    else:
        cent_d = geo.centroid_bbox(det.points, det.n_points)[0]
    dist2 = torch.square(cent_d[:, None, :]
                         - store.centroid[None, :, :]).sum(dim=-1)
    spatial = torch.exp(-dist2 / (2 * spatial_sigma ** 2))    # [D, cap]
    semantic = det.embed @ store.embed.T                      # cosine
    score = 0.5 * spatial + 0.5 * semantic
    score = torch.where(store.active[None, :], score, -torch.inf)
    score = torch.where(det.valid[:, None], score, -torch.inf)
    return score, cent_d


def associate(store: ObjectStore, det: Detections, *, frame: int,
              match_threshold: float = 0.6, point_budget: int = 2000,
              ema: float = 0.25, det_centroid=None) -> ObjectStore:
    """Associate one frame's detections into the store.

    Writes the store's tensors in place (the reference returned an updated
    copy); every value written is computed from the pre-frame store first.
    Returns the store.
    """
    score, _ = association_scores(store, det, det_centroid=det_centroid)
    D, cap = score.shape
    dev = score.device
    point_budget = min(point_budget, store.points.shape[1])
    ar_d = torch.arange(D, device=dev)

    # --- 1. resolve matches + within-frame conflicts
    j_star = first_argmax(score, dim=1)                            # [D]
    best = score[ar_d, j_star]
    wants = (best >= match_threshold) & det.valid
    claim = wants[:, None] & (j_star[:, None]
                              == torch.arange(cap, device=dev)[None, :])
    claim_score = torch.where(claim, best[:, None], -torch.inf)    # [D, cap]
    winner = first_argmax(claim_score, dim=0)                      # [cap]
    is_match = wants & (winner[j_star] == ar_d)

    # --- 2. merged geometry for the whole batch: an empty (n_a = 0) store
    # cloud for inserts degenerates the merge to downsample(det.points)
    tgt_emb = store.embed[j_star]                                  # [D, E]
    memb = (1 - ema) * tgt_emb + ema * det.embed
    memb = memb / torch.clamp(torch.linalg.vector_norm(memb, dim=-1,
                                                       keepdim=True),
                              min=1e-9)
    n_a = torch.where(is_match, store.n_points[j_star], 0)
    npts, nn = geo.merge_clouds(store.points[j_star], n_a, det.points,
                                det.n_points, point_budget)
    nc, nmn, nmx = geo.centroid_bbox(npts, nn)

    # --- 3. free-slot assignment for inserts in detection order; a
    # tombstone still owns its slot until release_tombstones retires it
    occupied = store.active | store_mod.deleted_mask(store)
    do_insert = det.valid & ~is_match
    csum = torch.cumsum(do_insert.to(torch.int32), dim=0)
    rank = torch.clamp(csum - 1, min=0)                            # [D]
    free_order = torch.argsort(occupied.to(torch.int8), stable=True)
    n_free = (~occupied).sum()
    ins_ok = do_insert & (csum - 1 < n_free)
    ins_slot = free_order[torch.clamp(rank, max=cap - 1)]

    # --- 4. one masked write per field (rows that neither merge nor
    # insert are dropped, as JAX drops their out-of-range index)
    tgt = torch.where(is_match, j_star, torch.where(ins_ok, ins_slot, cap))
    new_emb = torch.where(is_match[:, None], memb, det.embed)
    new_obs = torch.where(is_match, store.obs_count[j_star] + 1, 1)
    new_ver = torch.where(is_match, store.version[j_star] + 1, 1)
    new_ids = torch.where(is_match, store.ids[j_star],
                          store.next_id + rank.to(torch.int32))
    new_lab = torch.where(is_match, store.label[j_star], det.label)
    n_inserted = torch.clamp(do_insert.sum(), max=n_free).to(torch.int32)

    w = tgt < cap
    rows = tgt[w]
    store.ids[rows] = new_ids[w].to(torch.int32)
    store.active[rows] = True
    store.embed[rows] = new_emb[w]
    store.label[rows] = new_lab[w].to(torch.int32)
    store.points[rows] = npts[w]
    store.n_points[rows] = nn[w]
    store.centroid[rows] = nc[w]
    store.bbox_min[rows] = nmn[w]
    store.bbox_max[rows] = nmx[w]
    store.obs_count[rows] = new_obs[w].to(torch.int32)
    store.version[rows] = new_ver[w].to(torch.int32)
    store.last_seen[rows] = int(frame)
    store.next_id.add_(n_inserted)
    return store


def associate_reference(store: ObjectStore, det: Detections, *, frame: int,
                        match_threshold: float = 0.6,
                        point_budget: int = 2000,
                        ema: float = 0.25) -> ObjectStore:
    """Seed sequential-scan associate, one detection after another: merge
    into the best-scoring slot, else insert into the first inactive slot.
    Scores are computed once from the pre-frame store, as in the seed.
    Writes the store in place; returns it."""
    score, _ = association_scores(store, det)
    D = score.shape[0]
    point_budget = min(point_budget, store.points.shape[1])
    for i in range(D):
        j = int(first_argmax(score[i], dim=0))
        best = float(score[i, j])
        valid = bool(det.valid[i])
        pts_b, n_b = det.points[i:i + 1], det.n_points[i:i + 1]
        if best >= match_threshold and valid:
            new_emb = (1 - ema) * store.embed[j] + ema * det.embed[i]
            new_emb = new_emb / torch.clamp(
                torch.linalg.vector_norm(new_emb), min=1e-9)
            mpts, mn_ = geo.merge_clouds_argsort(
                store.points[j:j + 1], store.n_points[j:j + 1], pts_b, n_b,
                point_budget)
            c, mn, mx = geo.centroid_bbox(mpts, mn_)
            store.embed[j] = new_emb
            store.points[j] = mpts[0]
            store.n_points[j] = mn_[0]
            store.centroid[j] = c[0]
            store.bbox_min[j] = mn[0]
            store.bbox_max[j] = mx[0]
            store.obs_count[j] += 1
            store.version[j] += 1
            store.last_seen[j] = int(frame)
            continue
        # insert into the first inactive slot (``jnp.argmin`` of active)
        free = int(first_argmax((~store.active).to(torch.int8), dim=0))
        if bool(store.active[free]) or not valid:
            continue
        pts, n = geo.downsample(pts_b, n_b, point_budget)
        c, mn, mx = geo.centroid_bbox(pts, n)
        store.ids[free] = store.next_id
        store.active[free] = True
        store.embed[free] = det.embed[i]
        store.label[free] = det.label[i]
        store.points[free] = pts[0]
        store.n_points[free] = n[0]
        store.centroid[free] = c[0]
        store.bbox_min[free] = mn[0]
        store.bbox_max[free] = mx[0]
        store.obs_count[free] = 1
        store.version[free] = 1
        store.last_seen[free] = int(frame)
        store.next_id.add_(1)
    return store


def prune_transients(store: ObjectStore, *, frame: int, min_obs: int = 2,
                     max_age: int = 30) -> ObjectStore:
    """Deactivate objects never confirmed by repeat observation: seen fewer
    than ``min_obs`` times and not re-observed within ``max_age`` frames.
    Writes ``store.active`` in place; returns the store."""
    stale = (int(frame) - store.last_seen > max_age) \
        & (store.obs_count < min_obs)
    store.active.logical_and_(~stale)
    return store
