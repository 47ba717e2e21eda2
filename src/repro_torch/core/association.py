"""Incremental object association + merge (paper Sec. 2.3.1 / 3.1).

Port of ``repro.core.association`` (the batched ``associate``; the
sequential ``associate_reference`` oracle is not ported yet).  Per-frame
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


def prune_transients(store: ObjectStore, *, frame: int, min_obs: int = 2,
                     max_age: int = 30) -> ObjectStore:
    """Deactivate objects never confirmed by repeat observation: seen fewer
    than ``min_obs`` times and not re-observed within ``max_age`` frames.
    Writes ``store.active`` in place; returns the store."""
    stale = (int(frame) - store.last_seen > max_age) \
        & (store.obs_count < min_obs)
    store.active.logical_and_(~stale)
    return store
