"""Two-stage (coarse-to-fine) execution of ``Query`` specs over a
ClusterIndex, plus the cluster-level query mode.

Port of ``repro.index.search``.  Object-level plan (``two_stage_query``),
equal to the flat sweep:

1. **Stage 1** scores every cluster summary with a conservative upper bound
   on the best score any member could reach, under predicate masks that can
   only over-include.  With an embedding the ranking is one call of
   ``kernels.ops.query_topk_bias`` at k = m (queries x
   ``summaries.embed_mean`` with the slack / mask as bias): the
   hand-written kernel on the GPU, its plain version on the CPU.  Without
   one, a stable top-k of the bound.
2. **Stage 2** gathers the surviving cells' member slots (ascending, so
   ties break as in the flat sweep) into a candidate slab and runs
   ``core.query._execute`` over it: the same kernel again.
3. **Certificate**: the k-th score must beat the largest bound of every
   unselected cluster (plus ``_CERT_EPS``); else the selection width
   doubles until it passes or every cluster is selected.  The bound's
   ``[Q, M]`` product is a plain ``torch.matmul`` and the kernel's
   selection may differ from it in the last ulp: the epsilon covers that.

Cluster-level mode (``Query(level="cluster")``): the summaries are the
results — semantic (query x mean embedding) + proximity (to the cluster
centroid) + ``density_weight * log1p(count)``, top-k cells as a
``ClusterResult``.

Each two-stage query records ``query_index_two_stage_total``,
``query_index_escalations_total`` and the
``query_index_candidate_fraction`` histogram into the port's metrics
registry (``repro_torch.obs``; a no-op when none is installed), as the
reference does; ``core.query`` records ``query_index_flat_total``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.query import (NEG, QueryResult, _Cols, _columns,
                                    _execute, _n_queries, _promote)
from repro_torch.core.updates import bucket
from repro_torch.kernels import ops
from repro_torch.kernels.query_topk import topk_stable
from repro_torch.obs import metrics as obs_metrics

_C0 = 64              # initial stage-1 selection width (cells per query)
_CERT_EPS = 1e-5      # f32 slack on the exactness certificate


def candidate_fraction_buckets() -> tuple:
    """Fixed log-spaced fraction buckets (1e-4 .. 1.0) for the
    candidate-fraction histogram — stable across runs like
    ``default_latency_buckets``."""
    return tuple(round(10.0 ** (e / 4.0), 8) for e in range(-16, 1))


# ---------------------------------------------------------------------------
# conservative cluster gating (shared by stage 1 and the cluster-level mode)
# ---------------------------------------------------------------------------
def _zone_rects(zones: tuple, grid: tuple, device):
    """Allowed-zone rectangles lo / hi per axis, border zones extended to
    infinity (the clamped zone grid)."""
    x0, z0, zs, nx, nz = grid
    inf = float("inf")
    xlo, xhi, zlo, zhi = [], [], [], []
    for z in zones:
        ix, iz = divmod(int(z), int(nz))
        xlo.append(-inf if ix == 0 else x0 + ix * zs)
        xhi.append(inf if ix == nx - 1 else x0 + (ix + 1) * zs)
        zlo.append(-inf if iz == 0 else z0 + iz * zs)
        zhi.append(inf if iz == nz - 1 else z0 + (iz + 1) * zs)
    mk = lambda v: torch.from_numpy(                      # noqa: E731
        np.asarray(v, np.float32)).to(device)
    return mk(xlo), mk(xhi), mk(zlo), mk(zhi)


def _scaled_queries(spec) -> torch.Tensor:
    qs = spec.embed
    if spec.sem_weight is not None:
        qs = qs * spec.sem_weight[:, None]
    return qs


def _cluster_gate(spec, summ, *, has_obs: bool, has_seen: bool):
    """Conservative per-cell predicate mask [Q, M] and the finite
    upper-bound slack [Q, M] for a promoted ``spec``.  A cell is excluded
    only when no member can pass."""
    M = summ.count.shape[0]
    dev = summ.count.device
    ok = (summ.count > 0)[None, :]
    if spec.labels is not None:
        lab = torch.tensor(spec.labels, dtype=torch.long, device=dev)
        ok = ok & summ.label_any[:, lab].any(dim=1)[None, :]
    if spec.min_points is not None:
        ok = ok & (summ.n_points_max[None, :] >= spec.min_points[:, None])
    if spec.min_obs is not None and has_obs:
        ok = ok & (summ.obs_max[None, :] >= spec.min_obs[:, None])
    if spec.since is not None and has_seen:
        ok = ok & (summ.last_seen_max[None, :] >= spec.since[:, None])
    if spec.aabb is not None:
        lo, hi = spec.aabb
        inter = ((summ.aabb_min[None] <= hi[:, None, :])
                 & (summ.aabb_max[None] >= lo[:, None, :])).all(-1)
        ok = ok & inter
    if spec.zones is not None:
        xlo, xhi, zlo, zhi = _zone_rects(spec.zones, spec.grid, dev)
        hit = ((summ.aabb_min[:, None, 0] <= xhi[None])
               & (summ.aabb_max[:, None, 0] >= xlo[None])
               & (summ.aabb_min[:, None, 2] <= zhi[None])
               & (summ.aabb_max[:, None, 2] >= zlo[None])).any(dim=1)
        ok = ok & hit[None, :]

    Q = _n_queries(spec)
    slack = torch.zeros((Q, M), dtype=torch.float32, device=dev)
    if spec.embed is not None:
        qn = torch.linalg.vector_norm(_scaled_queries(spec), dim=-1)   # [Q]
        slack = slack + qn[:, None] * summ.res_max[None, :]
    if spec.near is not None:
        center, radius = spec.near
        c = center[:, None, :]                             # [Q, 1, 3]
        # min / max distance from the query center to the member AABB
        dmin = torch.linalg.vector_norm(
            torch.clamp(torch.maximum(summ.aabb_min[None] - c,
                                      c - summ.aabb_max[None]), min=0.0),
            dim=-1)
        ok = ok & (dmin <= radius[:, None])
        if spec.prox_weight is not None:
            dmax = torch.linalg.vector_norm(
                torch.maximum(torch.abs(c - summ.aabb_min[None]),
                              torch.abs(c - summ.aabb_max[None])), dim=-1)
            pw = spec.prox_weight[:, None]
            slack = slack + torch.where(pw >= 0, pw / (1.0 + dmin),
                                        pw / (1.0 + dmax))
    ok = ok.expand(Q, M)
    # empty cells carry inf / -inf AABBs: scrub the NaN their arithmetic
    # made (count > 0 masks them anyway)
    slack = torch.nan_to_num(slack, nan=0.0, posinf=0.0, neginf=0.0)
    return ok, slack


# ---------------------------------------------------------------------------
# stage 1: rank clusters by upper bound, select a width-m union
# ---------------------------------------------------------------------------
def _stage1(spec, summ, *, m: int, has_obs: bool, has_seen: bool):
    """Returns (cells [Q*m] int32 — the deduped union of each query's top-m
    cells by upper bound, ascending, -1 padded — and excl_max [Q]: each
    query's largest bound over every unselected cluster)."""
    spec = _promote(spec, summ.count.device)
    M = summ.count.shape[0]
    ok, slack = _cluster_gate(spec, summ, has_obs=has_obs, has_seen=has_seen)
    bias = torch.where(ok, slack, NEG)
    if spec.embed is not None:
        qs = _scaled_queries(spec)
        sim = qs @ summ.embed_mean.T                       # [Q, M]
        ub = torch.where(bias > NEG * 0.5, sim + bias, NEG)
        vals, picks = ops.query_topk_bias(qs.contiguous(), summ.embed_mean,
                                          bias.contiguous(), m)
    else:
        ub = torch.where(bias > NEG * 0.5, bias, NEG)
        vals, picks = topk_stable(ub, m)

    # union the per-query selections: sort, mark duplicates / invalid -1
    flat = torch.where(vals > NEG * 0.5, picks, M).reshape(-1)   # [Q*m]
    srt = torch.sort(flat).values
    dup = torch.cat([torch.zeros((1,), dtype=torch.bool, device=srt.device),
                     srt[1:] == srt[:-1]])
    cells = torch.where(dup | (srt >= M), -1, srt).to(torch.int32)

    sel = torch.zeros((M + 1,), dtype=torch.bool, device=srt.device)
    sel[torch.where(cells >= 0, cells, M).long()] = True
    ub_f = torch.where(ub > NEG * 0.5, ub, -torch.inf)
    excl_max = torch.where(sel[None, :M], -torch.inf, ub_f).amax(dim=1)
    return cells, excl_max


# ---------------------------------------------------------------------------
# stage 2: the fused sweep over the surviving members only
# ---------------------------------------------------------------------------
def _stage2(spec, cols: _Cols, slot_map: torch.Tensor) -> QueryResult:
    """Sweep an ascending, ``cap``-padded candidate slot slab through the
    flat path's ``_execute``, then map result slots back to target rows."""
    cap = cols.active.shape[0]
    valid = slot_map < cap
    idx = torch.where(valid, slot_map, 0)
    opt = lambda c: None if c is None else c[idx]         # noqa: E731
    cand = _Cols(
        ids=torch.where(valid, cols.ids[idx], 0),
        active=valid & cols.active[idx],
        embed=cols.embed[idx],
        label=cols.label[idx],
        n_points=cols.n_points[idx],
        centroid=cols.centroid[idx],
        obs_count=opt(cols.obs_count),
        last_seen=opt(cols.last_seen))
    res = _execute(spec, cand)
    slots = torch.where(res.slots >= 0,
                        slot_map[torch.clamp(res.slots, min=0).long()]
                        .to(torch.int32), -1)
    return QueryResult(oids=res.oids, scores=res.scores, slots=slots)


# ---------------------------------------------------------------------------
def two_stage_query(spec, target, index, *,
                    use_pallas: bool = False) -> QueryResult:
    """Execute an object-level ``Query`` through the cluster index with the
    exactness certificate and escalation loop (module docstring).
    ``use_pallas`` is accepted for the reference's signature and ignored."""
    del use_pallas
    cols = _columns(target)
    dev = cols.active.device
    has_obs = cols.obs_count is not None
    has_seen = cols.last_seen is not None
    M = index.grid.n_cells
    k = max(int(spec.k), 1)
    m = min(_C0, M)
    cap_t = int(cols.active.shape[0])
    escalations = 0
    while True:
        cells, excl = _stage1(spec, index.summaries, m=m, has_obs=has_obs,
                              has_seen=has_seen)
        # the candidate slab, host-side from the surviving cells' exact
        # member lists: its length is the bucketed true candidate count,
        # ascending so the flat sweep's slot-order tie-break holds
        cells_np = cells.cpu().numpy()
        live = cells_np[cells_np >= 0]
        n_cand = int(index._size[live].sum()) if live.size else 0
        P = min(bucket(max(n_cand, 1)), bucket(cap_t))
        slab = np.full((P,), cap_t, np.int64)
        if n_cand:
            slab[:n_cand] = np.sort(np.concatenate(
                [index._members[c][:int(index._size[c])] for c in live]))
        res = _stage2(spec, cols, torch.from_numpy(slab).to(dev))
        sk = np.atleast_1d(
            res.scores[..., min(k, res.scores.shape[-1]) - 1].cpu().numpy())
        ex = excl.cpu().numpy()
        exf = np.where(np.isneginf(ex), 0.0, ex)
        certified = np.isneginf(ex) \
            | (sk >= exf + _CERT_EPS * np.maximum(1.0, np.abs(exf)))
        if certified.all() or m >= M:
            break
        m = min(2 * m, M)
        escalations += 1

    reg = obs_metrics.get_registry()
    if reg is not None:
        reg.counter("query_index_two_stage_total",
                    "queries served by the cluster index").inc()
        if escalations:
            reg.counter("query_index_escalations_total",
                        "certificate-failure selection doublings").inc(
                            escalations)
        reg.histogram("query_index_candidate_fraction",
                      "stage-2 candidates / table size",
                      bounds=candidate_fraction_buckets()).observe(
                          n_cand / max(cap_t, 1))
    return res


# ---------------------------------------------------------------------------
# cluster-level queries: the summaries are the results
# ---------------------------------------------------------------------------
class ClusterResult(NamedTuple):
    """Top-k clusters (``Query(level="cluster")``).  Padded ranks: score
    -inf, cell / zone -1, count 0."""
    zones: torch.Tensor      # [k] / [Q, k] int32 zone id (-1 on flat targets)
    cells: torch.Tensor      # [k] / [Q, k] int32 grid cell id (-1 = no match)
    scores: torch.Tensor     # [k] / [Q, k] f32
    counts: torch.Tensor     # [k] / [Q, k] int32 member count
    centroids: torch.Tensor  # [k, 3] / [Q, k, 3] f32 cluster centroid


def _cluster_execute(spec, summ, *, has_obs: bool,
                     has_seen: bool) -> ClusterResult:
    """Score cells directly under the conservative gate: one stable top-k
    over [Q, M]."""
    squeeze = not spec.batched
    dev = summ.count.device
    spec = _promote(spec, dev)
    M = summ.count.shape[0]
    k = min(spec.k, M)
    ok, _ = _cluster_gate(spec, summ, has_obs=has_obs, has_seen=has_seen)
    Q = _n_queries(spec)
    score = torch.zeros((Q, M), dtype=torch.float32, device=dev)
    if spec.embed is not None:
        score = score + _scaled_queries(spec) @ summ.embed_mean.T
    if spec.near is not None and spec.prox_weight is not None:
        center, _ = spec.near
        d = torch.linalg.vector_norm(summ.centroid[None] - center[:, None, :],
                                     dim=-1)
        score = score + spec.prox_weight[:, None] / (1.0 + d)
    if spec.density_weight is not None:
        score = score + spec.density_weight[:, None] \
            * torch.log1p(summ.count.to(torch.float32))[None, :]
    score = torch.where(ok, score, -torch.inf)
    vals, cells = topk_stable(score, k)
    bad = cells < 0                       # topk_stable's NEG / -1 padding
    vals = torch.where(bad, -torch.inf, vals)
    take = torch.clamp(cells, min=0).long()
    counts = torch.where(bad, 0, summ.count[take]).to(torch.int32)
    cents = torch.where(bad[..., None], 0.0, summ.centroid[take])
    if k < spec.k:
        pad = spec.k - k
        F = torch.nn.functional
        vals = F.pad(vals, (0, pad), value=-torch.inf)
        cells = F.pad(cells, (0, pad), value=-1)
        counts = F.pad(counts, (0, pad))
        cents = F.pad(cents, (0, 0, 0, pad))
    out = ClusterResult(zones=torch.full_like(cells, -1), cells=cells,
                        scores=vals, counts=counts, centroids=cents)
    if squeeze:
        out = ClusterResult(*(x[0] for x in out))
    return out


def cluster_query(spec, items) -> ClusterResult:
    """Run a cluster-level query over ``items = [(zone_or_None, index,
    target)]`` and merge to one top-k: a stable sort over the item-major
    concatenation, so ties go to the earlier item, then the lower rank
    (``lax.top_k``'s order in the reference)."""
    parts = []
    for zone, index, target in items:
        cols = _columns(target)
        r = _cluster_execute(spec, index.summaries,
                             has_obs=cols.obs_count is not None,
                             has_seen=cols.last_seen is not None)
        z = -1 if zone is None else int(zone)
        parts.append(r._replace(zones=torch.where(r.cells >= 0, z, -1)
                                .to(torch.int32)))
    if len(parts) == 1:
        return parts[0]
    dev = parts[0].scores.device
    cat = ClusterResult(*(torch.cat([getattr(p, f).to(dev) for p in parts],
                                    dim=-1 if f != "centroids" else -2)
                          for f in ClusterResult._fields))
    k = min(spec.k, cat.scores.shape[-1])
    vals, sel = torch.sort(cat.scores, dim=-1, descending=True, stable=True)
    vals, sel = vals[..., :k], sel[..., :k]
    take = lambda x: torch.gather(x, -1, sel)             # noqa: E731
    return ClusterResult(
        zones=take(cat.zones), cells=take(cat.cells), scores=vals,
        counts=take(cat.counts),
        centroids=torch.gather(cat.centroids, -2,
                               sel[..., None].expand(*sel.shape, 3)))
