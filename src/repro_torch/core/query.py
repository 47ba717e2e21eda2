"""Declarative query engine over the SemanticXR object maps (Sec. 2.3.2).

Port of ``repro.core.query``: flat targets (``LocalMap``, ``ObjectStore``)
and the fleet's ``ZoneShardedStore``.  One ``Query`` spec expresses the
whole request —
semantic similarity (``embed``, ``sem_weight``), spatial predicates
(``near``, ``aabb``, ``zones`` + ``grid``), attribute filters (``labels``,
``min_points``, ``min_obs``, ``since``), score combination
(``prox_weight``) and ``k`` — and ``_execute`` runs predicates + score +
top-k as one sweep.

Every query with an ``embed`` goes through ``kernels.ops.query_topk_bias``:
predicates become NEG bias, the proximity bonus finite bias.  On the GPU
that is the hand-written kernel, on the CPU its plain version.  The
reference's ``use_pallas`` flag is accepted and ignored.  An embed-less
query (spatial predicates only) has no matmul: its top-k of the bias is a
stable sort on (-score, slot), never ``torch.topk``, whose tie order on
CUDA is unspecified.

``compile_query(..., index=...)`` (or a ``cluster_index`` found on the
target) plans coarse-to-fine through ``repro_torch.index`` once the index
is engaged, and ``level="cluster"`` queries return the index's cluster
summaries.  The seed's embedding-only entry points (``query_server``,
``query_local``, ``batched_query_server`` / ``_local``) are thin deprecated
wrappers.

On a zone-sharded target the zone / near predicates prune shards before
any work (``_select_shards``); each selected shard runs the same plan
(flat, or two-stage through its zone index once engaged) and
``_merge_shards`` folds the per-shard top-k into one, globalising slots as
``zone * zone_capacity + slot``.  The merge is a stable sort over the
shard-major concatenation: ties go to the earlier selected shard, then the
lower rank, as ``lax.top_k`` orders them in the reference.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.query_topk import NEG, topk_stable

_DYN_FIELDS = ("embed", "sem_weight", "near", "aabb", "prox_weight",
               "min_points", "min_obs", "since", "density_weight")
_STATIC_FIELDS = ("labels", "zones", "grid", "k", "batched", "level")


@dataclass(frozen=True)
class Query:
    """One declarative map query.  Unset (None) fields are compiled away.

    Dynamic values (tensors, arrays or scalars; ``[Q, ...]`` when
    ``batched``): embed [E], sem_weight, near (center [3], radius), aabb
    (lo [3], hi [3]), prox_weight (requires ``near``), min_points, min_obs
    and since (vacuous on targets without obs_count / last_seen),
    density_weight (cluster-level queries, not ported).
    Static plan structure: labels, zones (requires grid), grid
    (x0, z0, zone_size, nx, nz), k, batched, level.
    """
    embed: Any = None
    sem_weight: Any = None
    near: Any = None
    aabb: Any = None
    prox_weight: Any = None
    min_points: Any = None
    min_obs: Any = None
    since: Any = None
    density_weight: Any = None
    labels: tuple | None = None
    zones: tuple | None = None
    grid: tuple | None = None
    k: int = 5
    batched: bool = False
    level: str = "object"

    @staticmethod
    def grid_of(grid) -> tuple:
        """ZoneGrid (duck-typed: .origin/.zone_size/.nx/.nz) -> grid tuple."""
        return (float(grid.origin[0]), float(grid.origin[1]),
                float(grid.zone_size), int(grid.nx), int(grid.nz))

    def static(self) -> tuple:
        return tuple(getattr(self, f) for f in _STATIC_FIELDS)

    def dynamic(self) -> dict:
        """{field: value} of the set dynamic fields."""
        return {f: getattr(self, f) for f in _DYN_FIELDS
                if getattr(self, f) is not None}


class QueryResult(NamedTuple):
    """Top-k hits.  Padded ranks (k exceeds the matching object count) are
    masked: score -inf, oid 0, slot -1."""
    oids: torch.Tensor       # [k] / [Q, k] int32 (0 = no match)
    scores: torch.Tensor     # [k] / [Q, k] f32 (-inf = no match)
    slots: torch.Tensor      # [k] / [Q, k] int32 target row (-1 = no match)


def _map_leaves(v, fn):
    """Apply ``fn`` to a dynamic value (a leaf or a tuple of leaves)."""
    return tuple(fn(x) for x in v) if isinstance(v, tuple) else fn(v)


def _as_tensor(x, device) -> torch.Tensor:
    """A leaf on ``device`` in the reference's 32-bit dtypes."""
    t = torch.as_tensor(x, device=device)
    if t.is_floating_point():
        return t.to(torch.float32)
    if t.dtype in (torch.int64, torch.int16, torch.int8, torch.uint8):
        return t.to(torch.int32)
    return t


def stack_queries(specs: list, pad_to: int | None = None) -> Query:
    """Stack Q same-structure specs into one batched spec (leading dim Q).
    ``pad_to`` repeats the first spec to a fixed Q."""
    if not specs:
        raise ValueError("stack_queries needs at least one spec")
    first = specs[0]
    if first.batched:
        raise ValueError("stack_queries takes unbatched specs")
    if not first.dynamic():
        raise ValueError("stack_queries needs at least one dynamic field "
                         "(all-static specs have no per-query dimension)")
    for s in specs[1:]:
        if s.static() != first.static() \
                or s.dynamic().keys() != first.dynamic().keys():
            raise ValueError("stack_queries: mismatched static plan "
                             "(labels/zones/grid/k must agree)")
    if pad_to is not None and pad_to > len(specs):
        specs = specs + [first] * (pad_to - len(specs))
    out = {}
    for f, v in first.dynamic().items():
        vals = [s.dynamic()[f] for s in specs]
        if isinstance(v, tuple):
            out[f] = tuple(torch.stack([torch.as_tensor(x[i]) for x in vals])
                           for i in range(len(v)))
        else:
            out[f] = torch.stack([torch.as_tensor(x) for x in vals])
    return replace(first, batched=True, **out)


# ---------------------------------------------------------------------------
# the fused execution path
# ---------------------------------------------------------------------------
class _Cols(NamedTuple):
    """Uniform columnar view of any query target (geometry stays behind)."""
    ids: torch.Tensor
    active: torch.Tensor
    embed: torch.Tensor
    label: torch.Tensor
    n_points: torch.Tensor
    centroid: torch.Tensor
    obs_count: Any        # None on targets without it (LocalMap)
    last_seen: Any        # None on targets without it (LocalMap)


def _columns(target) -> _Cols:
    return _Cols(ids=target.ids, active=target.active, embed=target.embed,
                 label=target.label, n_points=target.n_points,
                 centroid=target.centroid,
                 obs_count=getattr(target, "obs_count", None),
                 last_seen=getattr(target, "last_seen", None))


def _promote(spec: Query, device) -> Query:
    """Every dynamic leaf as a tensor on ``device`` with a leading Q dim."""
    lead = (lambda t: t) if spec.batched else (lambda t: t[None])
    dyn = {f: _map_leaves(v, lambda x: lead(_as_tensor(x, device)))
           for f, v in spec.dynamic().items()}
    return replace(spec, batched=True, **dyn)


def _n_queries(spec: Query) -> int:
    """Q of a promoted spec (1 when it has no dynamic field)."""
    leaves = [x for v in spec.dynamic().values()
              for x in (v if isinstance(v, tuple) else (v,))]
    return int(leaves[0].shape[0]) if leaves else 1


def _zone_ids(centroid: torch.Tensor, grid: tuple) -> torch.Tensor:
    """Mirror of the reference's clamped XZ zone grid."""
    x0, z0, zs, nx, nz = grid
    ix = torch.clamp(torch.floor((centroid[:, 0] - x0) / zs), 0, nx - 1)
    iz = torch.clamp(torch.floor((centroid[:, 2] - z0) / zs), 0, nz - 1)
    return (ix * nz + iz).to(torch.int32)


def _mask_and_bonus(spec: Query, cols: _Cols):
    """All predicates as one [Q, cap] (or [1, cap]) bool mask + the
    proximity bonus term; ``spec`` is promoted (leading Q dim)."""
    dev = cols.active.device
    ok = cols.active[None, :]
    if spec.labels is not None:
        ok = ok & torch.isin(cols.label, torch.tensor(
            spec.labels, dtype=torch.int32, device=dev))[None, :]
    if spec.zones is not None:
        if spec.grid is None:
            raise ValueError("Query.zones requires Query.grid")
        zid = _zone_ids(cols.centroid, spec.grid)
        ok = ok & torch.isin(zid, torch.tensor(
            spec.zones, dtype=torch.int32, device=dev))[None, :]
    if spec.min_points is not None:
        ok = ok & (cols.n_points[None, :] >= spec.min_points[:, None])
    if spec.min_obs is not None and cols.obs_count is not None:
        ok = ok & (cols.obs_count[None, :] >= spec.min_obs[:, None])
    if spec.since is not None and cols.last_seen is not None:
        ok = ok & (cols.last_seen[None, :] >= spec.since[:, None])
    if spec.aabb is not None:
        lo, hi = spec.aabb
        inside = ((cols.centroid[None] >= lo[:, None, :])
                  & (cols.centroid[None] <= hi[:, None, :])).all(-1)
        ok = ok & inside
    bonus = None
    if spec.near is not None:
        center, radius = spec.near
        d = torch.linalg.vector_norm(cols.centroid[None]
                                     - center[:, None, :], dim=-1)  # [Q, cap]
        ok = ok & (d <= radius[:, None])
        if spec.prox_weight is not None:
            bonus = spec.prox_weight[:, None] / (1.0 + d)
    elif spec.prox_weight is not None:
        raise ValueError("Query.prox_weight requires Query.near")
    return ok, bonus


def _finalize(ids: torch.Tensor, scores: torch.Tensor,
              slots: torch.Tensor) -> QueryResult:
    """Mask padded ranks: -inf score, sentinel slot -1, oid 0."""
    invalid = (scores <= NEG) | (slots < 0)
    slots = torch.where(invalid, -1, slots).to(torch.int32)
    oids = torch.where(invalid, 0, ids[torch.clamp(slots, min=0).long()])
    scores = torch.where(invalid, -torch.inf, scores)
    return QueryResult(oids=oids.to(torch.int32), scores=scores, slots=slots)


def _execute(spec: Query, cols: _Cols, *, use_pallas: bool = False):
    """The one execution path: predicates + score + top-k.  ``use_pallas``
    is accepted for API parity and ignored."""
    del use_pallas
    squeeze = not spec.batched
    spec = _promote(spec, cols.active.device)
    cap = cols.active.shape[0]
    k = min(spec.k, cap)
    Q = _n_queries(spec)
    ok, bonus = _mask_and_bonus(spec, cols)
    ok = ok.expand(Q, cap)
    bias = torch.zeros((Q, cap), dtype=torch.float32,
                       device=cols.active.device) if bonus is None \
        else bonus.expand(Q, cap)

    if spec.embed is not None:
        qs = spec.embed
        if spec.sem_weight is not None:
            qs = qs * spec.sem_weight[:, None]
        bias = torch.where(ok, bias, NEG).contiguous()
        scores, slots = ops.query_topk_bias(qs.contiguous(), cols.embed,
                                            bias, k)
    else:
        scores, slots = topk_stable(torch.where(ok, bias, -torch.inf), k)

    res = _finalize(cols.ids, scores, slots)
    if k < spec.k:                 # honor k > capacity with padded ranks
        pad = spec.k - k
        res = QueryResult(
            oids=torch.nn.functional.pad(res.oids, (0, pad)),
            scores=torch.nn.functional.pad(res.scores, (0, pad),
                                           value=-torch.inf),
            slots=torch.nn.functional.pad(res.slots, (0, pad), value=-1))
    if squeeze:
        res = QueryResult(*(x[0] for x in res))
    return res


def _merge_shards(oids, scores, slots, zone_ids, capz: int) -> QueryResult:
    """Fold S per-shard top-k results ([S, Q, k] each) into one [Q, k].
    Shard-local slots globalize to ``zone * zone_capacity + slot``; ties
    go to the earlier shard, then the lower rank (a stable sort over the
    shard-major concatenation)."""
    gslot = torch.where(slots >= 0,
                        zone_ids[:, None, None] * capz + slots, -1)
    cat = lambda x: x.movedim(0, 1).reshape(x.shape[1], -1)  # noqa: E731
    sc, oid, sl = cat(scores), cat(oids), cat(gslot)         # [Q, S*k]
    k = scores.shape[-1]
    top, sel = torch.sort(sc, dim=1, descending=True, stable=True)
    top, sel = top[:, :k], sel[:, :k]
    take = lambda x: torch.gather(x, 1, sel)                  # noqa: E731
    return QueryResult(oids=take(oid), scores=top,
                       slots=take(sl).to(torch.int32))


# ---------------------------------------------------------------------------
# compile + execute API
# ---------------------------------------------------------------------------
def _is_sharded(target) -> bool:
    return hasattr(target, "zones") and hasattr(target, "grid")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _select_shards(spec: Query, target) -> list:
    """Zone predicates prune shards BEFORE any work (host-side, from the
    spec's concrete values at compile time)."""
    Z = target.grid.n_zones
    if spec.zones is not None:
        return [z for z in sorted(set(spec.zones)) if 0 <= z < Z]
    if spec.near is not None:
        center, radius = spec.near
        c = np.atleast_2d(_host(center))
        r = np.atleast_1d(_host(radius))
        sel = np.zeros((Z,), bool)
        for i in range(c.shape[0]):
            sel |= target.grid.overlaps(c[i], float(r[min(i, len(r) - 1)]))
        return [z for z in range(Z) if sel[z]]
    return list(range(Z))


def _count_flat_fallback() -> None:
    """An index-carrying target served by the flat sweep (below the
    engagement threshold)."""
    from repro_torch.index import search
    search._METRICS["query_index_flat_total"] += 1


@dataclass
class CompiledQuery:
    """A (spec, target)-shaped plan; call it with a new same-structure
    ``spec`` and/or an updated target to re-run.  For sharded targets the
    shard selection is fixed at compile time from the spec's concrete
    zone / near values.

    ``index`` (a ``repro_torch.index.ClusterIndex``, or a ``{zone:
    ClusterIndex}`` dict for sharded targets) switches the plan to the
    two-stage path once ``index.engaged()``; below that the flat sweep
    runs.  Without ``index`` the plan uses ``target.cluster_index`` /
    ``target.indexes`` when the target has them.  ``level="cluster"`` specs
    need an index and return a ``repro_torch.index.ClusterResult``."""
    spec: Query
    use_pallas: bool = False
    shards: tuple | None = None        # zone ids (sharded targets only)
    index: Any = None

    def __call__(self, target, spec: Query | None = None):
        spec = self.spec if spec is None else spec
        if _is_sharded(target):
            return self._run_sharded(target, spec)
        idx = self.index if self.index is not None \
            else getattr(target, "cluster_index", None)
        if spec.level == "cluster":
            if idx is None:
                raise ValueError(
                    "Query(level='cluster') needs a ClusterIndex: pass "
                    "index= to compile_query or attach one as "
                    "target.cluster_index")
            from repro_torch.index.search import cluster_query
            return cluster_query(spec, [(None, idx, target)])
        if idx is not None:
            if idx.engaged():
                from repro_torch.index.search import two_stage_query
                return two_stage_query(spec, target, idx)
            _count_flat_fallback()
        return _execute(spec, _columns(target))

    def _run_sharded(self, target, spec: Query):
        shards = self.shards if self.shards is not None \
            else tuple(_select_shards(spec, target))
        idxs = self.index if self.index is not None \
            else getattr(target, "indexes", None)
        if not idxs:                   # {} (index never enabled) == None
            idxs = None
        k = spec.k
        dev = target.zones[0].ids.device
        shape = (k,) if not spec.batched else (_n_queries(spec), k)
        if spec.level == "cluster":
            from repro_torch.index.search import ClusterResult, cluster_query
            items = [] if idxs is None else \
                [(z, idxs[z], target.zones[z]) for z in shards
                 if idxs.get(z) is not None]
            if not items:
                if idxs is None:
                    raise ValueError(
                        "Query(level='cluster') on a sharded target needs "
                        "zone indexes: pass index= to compile_query or call "
                        "enable_index() on the store")
                i32 = dict(dtype=torch.int32, device=dev)
                return ClusterResult(
                    zones=torch.full(shape, -1, **i32),
                    cells=torch.full(shape, -1, **i32),
                    scores=torch.full(shape, -torch.inf, device=dev),
                    counts=torch.zeros(shape, **i32),
                    centroids=torch.zeros(shape + (3,), device=dev))
            return cluster_query(spec, items)
        if not shards:
            return QueryResult(
                oids=torch.zeros(shape, dtype=torch.int32, device=dev),
                scores=torch.full(shape, -torch.inf, device=dev),
                slots=torch.full(shape, -1, dtype=torch.int32, device=dev))
        # the same plan per selected shard, then a [k]-sized merge; shards
        # with an engaged index take the two-stage path, the rest stay flat
        bspec = spec if spec.batched else _promote(spec, dev)
        parts = []
        for z in shards:
            zt = target.zones[z]
            zidx = None if idxs is None else idxs.get(z)
            if zidx is not None and zidx.engaged():
                from repro_torch.index.search import two_stage_query
                parts.append(two_stage_query(bspec, zt, zidx))
            else:
                if zidx is not None:
                    _count_flat_fallback()
                parts.append(_execute(bspec, _columns(zt)))
        stack = lambda f: torch.stack(                         # noqa: E731
            [getattr(p, f).to(dev) for p in parts])
        res = _merge_shards(stack("oids"), stack("scores"), stack("slots"),
                            torch.tensor(shards, dtype=torch.int32,
                                         device=dev),
                            capz=int(target.zones[0].ids.shape[0]))
        if not spec.batched:
            res = QueryResult(*(x[0] for x in res))
        return res


def compile_query(spec: Query, target, *, use_pallas: bool = False,
                  index: Any = None) -> CompiledQuery:
    """Lower ``spec`` against a LocalMap, ObjectStore or ZoneShardedStore
    target (duck-typed); the plan is reusable with updated targets and
    same-structure specs."""
    shards = tuple(_select_shards(spec, target)) if _is_sharded(target) \
        else None
    return CompiledQuery(spec=spec, use_pallas=use_pallas, shards=shards,
                         index=index)


def execute_query(target, spec: Query, *, use_pallas: bool = False,
                  index: Any = None):
    """One-shot convenience: compile + run."""
    return CompiledQuery(spec=spec, use_pallas=use_pallas,
                         index=index)(target)


# ---------------------------------------------------------------------------
# deprecated embedding-only wrappers (the seed API)
# ---------------------------------------------------------------------------
def _warn_deprecated(name: str) -> None:
    warnings.warn(
        f"repro_torch.core.query.{name} is deprecated: build a Query spec "
        "and run it through compile_query / execute_query (which adds "
        "spatial / attribute predicates and score combination on the same "
        "sweep).", DeprecationWarning, stacklevel=3)


def query_server(store, query_embed, *, k: int = 5,
                 use_pallas: bool = False) -> QueryResult:
    """Deprecated: ``execute_query(store, Query(embed=..., k=k))``."""
    _warn_deprecated("query_server")
    return execute_query(store, Query(embed=query_embed, k=k),
                         use_pallas=use_pallas)


def query_local(m, query_embed, *, k: int = 5,
                use_pallas: bool = False) -> QueryResult:
    """Deprecated: ``execute_query(m, Query(embed=..., k=k))``."""
    _warn_deprecated("query_local")
    return execute_query(m, Query(embed=query_embed, k=k),
                         use_pallas=use_pallas)


def batched_query_local(m, query_embeds, *, k: int = 5,
                        use_pallas: bool = False) -> QueryResult:
    """Deprecated: ``execute_query`` with a batched Query spec."""
    _warn_deprecated("batched_query_local")
    return execute_query(m, Query(embed=query_embeds, k=k, batched=True),
                         use_pallas=use_pallas)


def batched_query_server(store, query_embeds, *, k: int = 5,
                         use_pallas: bool = False) -> QueryResult:
    """Deprecated: ``execute_query`` with a batched Query spec."""
    _warn_deprecated("batched_query_server")
    return execute_query(store, Query(embed=query_embeds, k=k, batched=True),
                         use_pallas=use_pallas)
