"""Incrementally-maintained cluster-summary level above the object maps.

Port of ``repro.index.cluster``.  One summary row per spatial grid cell —
member count, centroid mean, member AABB, mean embedding plus the max
embedding residual, per-class presence, and max n_points / obs / last_seen
— so a query can rank thousands of cells first and then sweep only the
members of the surviving cells (index/search.py), with a certificate that
makes the result the flat sweep's.

Maintenance contract:

* **Incremental.**  ``refresh(target)`` diffs the target's (presence,
  version, id, cell) columns against the last view and recomputes only the
  dirty cells; ``update_slots`` is the O(changes) path for callers that
  know which slots they touched.
* **Bit-identical to a from-scratch rebuild.**  Each cell's reduction runs
  over its member slots in ascending slot order at the fixed ``cell_cap``
  width, and every recompute pass has the same shape, ``[_CHUNK,
  cell_cap]`` (short chunks are padded): PyTorch picks a reduction's split
  by the number of outputs as well as the reduced length, on the GPU and
  on the CPU, so a cell's value depends only on its members and their
  columns, never on how many other cells ride the same pass.
* **Tombstones evict.**  Presence is ``active & ~deleted``.

Host bookkeeping (member lists, per-slot cell, version, id) is numpy, as
in the reference; the summaries and the sorted member table are tensors on
the target's device, written in place.  Cell overflow doubles ``cell_cap``
and rebuilds.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.updates import bucket
from repro_torch.device import resolve_device

N_LABELS = 256                 # matches updates.class_budget_table
_SENTINEL = np.iinfo(np.int32).max      # sorts after every real slot id
_CHUNK = 256                   # dirty cells per recompute pass (fixed shape)

# below this many live objects the flat sweep wins: the two-stage plan
# engages only past it (core/query.py)
DEFAULT_MIN_FLAT = 16_384


@dataclass(frozen=True)
class CellGrid:
    """Fixed XZ partition of the indexed space into nx * nz summary cells;
    out-of-bounds centroids clamp to the border cells."""
    origin: tuple            # (x0, z0)
    size: tuple              # (sx, sz) cell edge lengths
    nx: int
    nz: int

    @property
    def n_cells(self) -> int:
        return self.nx * self.nz

    @classmethod
    def fit(cls, centroids: np.ndarray, n_cells_target: int) -> "CellGrid":
        """Grid wrapping the given centroids with ~n_cells_target cells."""
        n_side = max(1, int(math.isqrt(max(n_cells_target, 1))))
        c = np.asarray(centroids, np.float64)
        if c.size == 0:
            lo, hi = np.array([-8.0, -8.0]), np.array([8.0, 8.0])
        else:
            lo = np.array([c[:, 0].min(), c[:, 2].min()])
            hi = np.array([c[:, 0].max(), c[:, 2].max()])
        span = np.maximum(hi - lo, 1e-3) * 1.001     # border objects inside
        return cls(origin=(float(lo[0]), float(lo[1])),
                   size=(float(span[0] / n_side), float(span[1] / n_side)),
                   nx=n_side, nz=n_side)

    @classmethod
    def for_rect(cls, x0: float, z0: float, sx: float, sz: float,
                 n_cells_target: int) -> "CellGrid":
        """Grid subdividing a known rectangle (a zone shard's footprint)."""
        n_side = max(1, int(math.isqrt(max(n_cells_target, 1))))
        return cls(origin=(float(x0), float(z0)),
                   size=(float(sx) / n_side, float(sz) / n_side),
                   nx=n_side, nz=n_side)

    def cell_of(self, centroids: np.ndarray) -> np.ndarray:
        """[M, 3] centroids -> [M] cell ids (host side, clamped)."""
        c = np.atleast_2d(np.asarray(centroids))
        ix = np.clip(((c[:, 0] - self.origin[0]) // self.size[0])
                     .astype(np.int64), 0, self.nx - 1)
        iz = np.clip(((c[:, 2] - self.origin[1]) // self.size[1])
                     .astype(np.int64), 0, self.nz - 1)
        return (ix * self.nz + iz).astype(np.int32)


class ClusterSummaries(NamedTuple):
    """One row per grid cell: everything the two-stage planner reads.
    ``aabb_*`` bound the member centroids; ``res_max`` is
    ``max_j ||embed_j - embed_mean||``.  Empty cells: count 0, aabb
    +inf / -inf, everything else zeros."""
    count: torch.Tensor          # [M] int32
    centroid: torch.Tensor       # [M, 3] f32 — mean of member centroids
    aabb_min: torch.Tensor       # [M, 3] f32
    aabb_max: torch.Tensor       # [M, 3] f32
    embed_mean: torch.Tensor     # [M, E] f32
    res_max: torch.Tensor        # [M] f32
    label_any: torch.Tensor      # [M, N_LABELS] bool — classes present
    n_points_max: torch.Tensor   # [M] int32
    obs_max: torch.Tensor        # [M] int32 (0 when target has no obs_count)
    last_seen_max: torch.Tensor  # [M] int32 (0 when target lacks last_seen)


def _init_summaries(n_cells: int, embed_dim: int,
                    device) -> ClusterSummaries:
    M = n_cells
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return ClusterSummaries(
        count=torch.zeros((M,), **i32),
        centroid=torch.zeros((M, 3), **f32),
        aabb_min=torch.full((M, 3), torch.inf, **f32),
        aabb_max=torch.full((M, 3), -torch.inf, **f32),
        embed_mean=torch.zeros((M, embed_dim), **f32),
        res_max=torch.zeros((M,), **f32),
        label_any=torch.zeros((M, N_LABELS), dtype=torch.bool, device=device),
        n_points_max=torch.zeros((M,), **i32),
        obs_max=torch.zeros((M,), **i32),
        last_seen_max=torch.zeros((M,), **i32))


def _target_cols(target):
    """(embed, label, n_points, centroid, obs_count|None, last_seen|None)."""
    return (target.embed, target.label, target.n_points, target.centroid,
            getattr(target, "obs_count", None),
            getattr(target, "last_seen", None))


def _apply_cells(summ: ClusterSummaries, cols, cells: torch.Tensor,
                 rows: torch.Tensor) -> None:
    """Recompute the summaries of cells ``cells`` [D] (-1 = padding) from
    their ascending member rows ``rows`` [D, cell_cap] (-1 padded) and
    write them into ``summ`` in place.  The reference scatters padding
    cells to index M, which JAX drops; here they are masked out before the
    write."""
    embed, label, n_points, centroid, obs, last_seen = cols
    valid = rows >= 0                                   # [D, cap_c]
    idx = torch.clamp(rows, min=0).long()
    cnt = valid.sum(dim=1).to(torch.int32)              # [D]
    den = torch.clamp(cnt, min=1).to(torch.float32)

    cent = centroid[idx]                                # [D, cap_c, 3]
    vm = valid[:, :, None]
    c_mean = torch.where(vm, cent, 0.0).sum(dim=1) / den[:, None]
    a_min = torch.where(vm, cent, torch.inf).amin(dim=1)
    a_max = torch.where(vm, cent, -torch.inf).amax(dim=1)

    emb = embed[idx]                                    # [D, cap_c, E]
    e_mean = torch.where(vm, emb, 0.0).sum(dim=1) / den[:, None]
    res = torch.linalg.vector_norm(emb - e_mean[:, None, :], dim=-1)
    r_max = torch.where(valid, res, 0.0).amax(dim=1)

    lab = torch.clamp(label[idx], 0, N_LABELS - 1).long()   # [D, cap_c]
    D = rows.shape[0]
    dd = torch.arange(D, device=rows.device)[:, None].expand_as(lab)
    l_any = torch.zeros((D, N_LABELS), dtype=torch.bool, device=rows.device)
    l_any[dd[valid], lab[valid]] = True

    zero = torch.zeros((), dtype=torch.int32, device=rows.device)
    npts = torch.where(valid, n_points[idx], zero).amax(dim=1)
    obs_m = torch.zeros((D,), dtype=torch.int32, device=rows.device) \
        if obs is None else torch.where(valid, obs[idx], zero).amax(dim=1)
    seen_m = torch.zeros((D,), dtype=torch.int32, device=rows.device) \
        if last_seen is None \
        else torch.where(valid, last_seen[idx], zero).amax(dim=1)

    w = cells >= 0
    tgt = cells[w].long()
    has = cnt[:, None] > 0
    new = ClusterSummaries(
        count=cnt, centroid=c_mean,
        aabb_min=torch.where(has, a_min, torch.inf),
        aabb_max=torch.where(has, a_max, -torch.inf),
        embed_mean=e_mean, res_max=r_max, label_any=l_any,
        n_points_max=npts, obs_max=obs_m, last_seen_max=seen_m)
    for dst, v in zip(summ, new):
        dst[tgt] = v[w].to(dst.dtype)


# ---------------------------------------------------------------------------
@dataclass
class ClusterIndex:
    """The cluster-summary index over ONE flat target (the server store or
    a device LocalMap).

    Host bookkeeping mirrors the target (per-slot cell, per-cell member
    lists); device state is the [n_cells, cell_cap] sorted member table
    plus the ClusterSummaries, on ``device`` (the card by default;
    ``for_target`` takes the target's).  ``refresh`` diffs; callers that know their deltas
    call ``update_slots``."""
    grid: CellGrid
    embed_dim: int
    capacity: int                       # target slot count
    cell_cap: int
    min_flat_size: int = DEFAULT_MIN_FLAT
    device: str | torch.device = "cuda"
    summaries: ClusterSummaries = None
    members: torch.Tensor = None        # [n_cells, cell_cap] int32, -1 pad,
    #                                     each row ascending (stage-2 order)
    # host mirrors
    _members: np.ndarray = None         # unsorted insertion-order lists
    _size: np.ndarray = None            # [n_cells] int32
    _cell: np.ndarray = None            # [cap] int32 cell id, -1 = absent
    _pos: np.ndarray = None             # [cap] int32 position in _members
    _present: np.ndarray = None         # [cap] bool
    _ver: np.ndarray = None             # [cap] int64 indexed version
    _oid: np.ndarray = None             # [cap] int64 indexed object id
    updates: int = 0                    # recompute passes issued
    rebuilds: int = 0                   # cell_cap auto-grow events

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.summaries is None:
            self.summaries = _init_summaries(self.grid.n_cells,
                                             self.embed_dim, self.device)
        if self._members is None:
            self._reset_tables()

    def _reset_tables(self) -> None:
        M = self.grid.n_cells
        self._members = np.full((M, self.cell_cap), -1, np.int32)
        self.members = torch.from_numpy(self._members.copy()).to(self.device)
        self._size = np.zeros((M,), np.int32)
        self._cell = np.full((self.capacity,), -1, np.int32)
        self._pos = np.zeros((self.capacity,), np.int32)
        self._present = np.zeros((self.capacity,), bool)
        self._ver = np.full((self.capacity,), -1, np.int64)
        self._oid = np.zeros((self.capacity,), np.int64)

    # -- construction ------------------------------------------------------
    @classmethod
    def for_target(cls, target, *, n_cells_target: int | None = None,
                   cell_cap: int | None = None,
                   min_flat_size: int = DEFAULT_MIN_FLAT) -> "ClusterIndex":
        """Build (and fill) an index over a LocalMap / ObjectStore-shaped
        target, on its device.  Cell count targets ~256 members a cell;
        ``cell_cap`` is sized from the measured peak occupancy plus slack
        (auto-grown on later overflow)."""
        present = _present(target)
        n = max(int(present.sum()), 1)
        cap = int(present.shape[0])
        if n_cells_target is None:
            n_cells_target = min(max(n // 256, 16), 16_384)
        cents = target.centroid.cpu().numpy()[present]
        grid = CellGrid.fit(cents, n_cells_target)
        if cell_cap is None:
            counts = np.bincount(grid.cell_of(cents),
                                 minlength=grid.n_cells)
            peak = int(counts.max()) if counts.size else 0
            cell_cap = bucket(max(peak + (peak >> 2) + 8, 16))
        idx = cls(grid=grid, embed_dim=int(target.embed.shape[1]),
                  capacity=cap, cell_cap=int(cell_cap),
                  min_flat_size=min_flat_size, device=target.embed.device)
        idx.refresh(target)
        return idx

    # -- introspection -----------------------------------------------------
    @property
    def n_objects(self) -> int:
        return int(self._size.sum())

    def engaged(self) -> bool:
        """Would the two-stage plan use this index right now?"""
        return self.n_objects >= self.min_flat_size

    def member_slots(self, cell: int) -> np.ndarray:
        return np.sort(self._members[cell][:int(self._size[cell])])

    # -- maintenance -------------------------------------------------------
    def refresh(self, target) -> int:
        """Diff the target against the last indexed view and update the
        dirty cells.  Returns the number of changed slots."""
        present = _present(target)
        ver = target.version.cpu().numpy().astype(np.int64)
        ids = target.ids.cpu().numpy().astype(np.int64)
        changed = (present != self._present) \
            | (present & ((ver != self._ver) | (ids != self._oid)))
        if changed.any():
            self.update_slots(target, np.nonzero(changed)[0])
        return int(changed.sum())

    def update_slots(self, target, slots) -> None:
        """O(changes) delta path: re-index exactly ``slots`` (values are
        re-read from the target, so add / move / remove / tombstone all
        route through here)."""
        slots = np.unique(np.asarray(slots, np.int64))
        if not len(slots):
            return
        present = _present(target)
        ver = target.version.cpu().numpy().astype(np.int64)
        ids = target.ids.cpu().numpy().astype(np.int64)
        cent = target.centroid.cpu().numpy()
        new_cell = self.grid.cell_of(cent[slots])
        dirty: set = set()
        grown = False
        for s, c_new in zip(slots, new_cell):
            s = int(s)
            p = bool(present[s])
            c_old = int(self._cell[s])
            c_tgt = int(c_new) if p else -1
            if c_old >= 0 and c_old != c_tgt:
                self._drop_member(s, c_old)
                dirty.add(c_old)
            if c_tgt >= 0 and int(self._cell[s]) < 0:
                if self._size[c_tgt] >= self.cell_cap:
                    grown = True
                    break
                self._add_member(s, c_tgt)
                dirty.add(c_tgt)
            elif c_tgt >= 0:
                dirty.add(c_tgt)          # in-place value change
            self._present[s] = p
            self._ver[s] = ver[s] if p else -1
            self._oid[s] = ids[s] if p else 0
        if grown:
            self._grow_and_rebuild(target)
            return
        self._recompute(target, sorted(dirty))

    def _add_member(self, s: int, c: int) -> None:
        self._members[c, self._size[c]] = s
        self._pos[s] = self._size[c]
        self._size[c] += 1
        self._cell[s] = c

    def _drop_member(self, s: int, c: int) -> None:
        last = self._size[c] - 1
        p = int(self._pos[s])
        moved = int(self._members[c, last])
        self._members[c, p] = moved
        self._pos[moved] = p
        self._members[c, last] = -1
        self._size[c] = last
        self._cell[s] = -1

    def _sorted_rows(self, cells) -> np.ndarray:
        rows = self._members[cells].copy()
        rows[rows < 0] = _SENTINEL
        rows.sort(axis=1)
        rows[rows == _SENTINEL] = -1
        return rows

    def _recompute(self, target, dirty: list) -> None:
        """One recompute pass of ``_CHUNK`` padded cells per chunk of dirty
        cells; mirrors their sorted member rows into the device table."""
        if not dirty:
            return
        cols = _target_cols(target)
        dirty = np.asarray(dirty, np.int64)
        for lo in range(0, len(dirty), _CHUNK):
            chunk = dirty[lo:lo + _CHUNK]
            cells = np.full((_CHUNK,), -1, np.int32)
            cells[:len(chunk)] = chunk
            rows = np.full((_CHUNK, self.cell_cap), -1, np.int32)
            rows[:len(chunk)] = self._sorted_rows(chunk)
            rows_t = torch.from_numpy(rows).to(self.device)
            _apply_cells(self.summaries, cols,
                         torch.from_numpy(cells).to(self.device), rows_t)
            self.members[torch.from_numpy(chunk).to(self.device)] = \
                rows_t[:len(chunk)]
            self.updates += 1

    def _grow_and_rebuild(self, target) -> None:
        """Cell overflow: double cell_cap and re-index from the target."""
        self.cell_cap *= 2
        self.rebuilds += 1
        self.summaries = _init_summaries(self.grid.n_cells, self.embed_dim,
                                         self.device)
        self._reset_tables()
        self.refresh(target)


def _present(target) -> np.ndarray:
    """[cap] host bool: live and not tombstoned."""
    act = target.active.cpu().numpy()
    dele = getattr(target, "deleted", None)
    return act & ~dele.cpu().numpy() if dele is not None else act


def rebuilt(index: ClusterIndex, target) -> ClusterIndex:
    """A fresh index over ``target`` with ``index``'s exact geometry — the
    from-scratch oracle for incremental maintenance."""
    out = ClusterIndex(grid=index.grid, embed_dim=index.embed_dim,
                       capacity=index.capacity, cell_cap=index.cell_cap,
                       min_flat_size=index.min_flat_size,
                       device=index.device)
    out.refresh(target)
    return out


def summaries_equal(a: ClusterSummaries, b: ClusterSummaries) -> bool:
    """Exact comparison, field by field (inf equals inf)."""
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))
