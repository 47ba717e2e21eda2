"""Zone-sharded object store: spatial partition of the server map.

Port of ``repro.server.zones``.  Objects are routed to zones by centroid
over a fixed XZ grid; each zone is an independent, fixed-capacity
``ObjectStore`` shard, so per-zone work (per-client sync, queries) touches
only that zone's slots.  Clients subscribe to the zones their pose-radius
overlaps — a client whose pose stays inside one zone receives zero
downstream bytes for objects mutated only in other zones.

The mapping frontend stays monolithic (association needs the global view);
``refresh_from`` mirrors its store into the shards incrementally: only rows
whose version advanced since the last copy are re-copied, one index copy
per field and dirty zone, written into the shard's tensors in place.  Slot
bookkeeping is host-side and assigns slots in the reference's order, so
the shards (and every packet built from them) are the reference's slot
for slot; freed shard slots are reported so the per-zone SessionManager
can forget stale sync versions before the slot is reused.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.knobs import Knobs
from repro_torch.core.store import ObjectStore, deleted_mask, init_store
from repro_torch.core.updates import bucket
from repro_torch.device import resolve_device

# the fields a mirrored row copies (next_id stays the shard's own)
_COPIED = ("ids", "embed", "label", "points", "n_points", "centroid",
           "bbox_min", "bbox_max", "obs_count", "version", "last_seen")


@dataclass(frozen=True)
class ZoneGrid:
    """Fixed XZ-plane partition of the mapped space into nx*nz zones."""
    origin: tuple            # (x0, z0) — min corner of the grid
    zone_size: float         # zone edge length (metres)
    nx: int
    nz: int

    @property
    def n_zones(self) -> int:
        return self.nx * self.nz

    @classmethod
    def for_room(cls, room_size: float, nx: int = 2, nz: int = 2):
        half = room_size / 2
        return cls(origin=(-half, -half), zone_size=room_size / max(nx, nz),
                   nx=nx, nz=nz)

    def zone_of(self, centroids: np.ndarray) -> np.ndarray:
        """[M, 3] centroids -> [M] zone ids (out-of-grid clamps to edge)."""
        c = np.atleast_2d(np.asarray(centroids))
        ix = np.clip(((c[:, 0] - self.origin[0]) // self.zone_size)
                     .astype(np.int64), 0, self.nx - 1)
        iz = np.clip(((c[:, 2] - self.origin[1]) // self.zone_size)
                     .astype(np.int64), 0, self.nz - 1)
        return ix * self.nz + iz

    def overlaps(self, pos, radius: float) -> np.ndarray:
        """[Z] bool — zones whose XZ rectangle intersects the pose circle.
        Border zones extend to infinity on their grid-exterior sides,
        mirroring the clamp in ``zone_of``."""
        return self.overlaps_batch(np.asarray(pos, np.float64)[None],
                                   radius)[0]

    def _zone_rects(self):
        """[Z] rectangle bounds (x0, x1, z0, z1) in zone-id order, border
        zones extended to infinity — cached: the grid is frozen."""
        r = getattr(self, "_rects", None)
        if r is None:
            inf = float("inf")
            ix, iz = np.divmod(np.arange(self.n_zones), self.nz)
            x0 = self.origin[0] + ix * self.zone_size
            z0 = self.origin[1] + iz * self.zone_size
            x1, z1 = x0 + self.zone_size, z0 + self.zone_size
            x0 = np.where(ix == 0, -inf, x0)
            x1 = np.where(ix == self.nx - 1, inf, x1)
            z0 = np.where(iz == 0, -inf, z0)
            z1 = np.where(iz == self.nz - 1, inf, z1)
            r = (x0, x1, z0, z1)
            object.__setattr__(self, "_rects", r)
        return r

    def overlaps_batch(self, poses: np.ndarray, radius) -> np.ndarray:
        """[C, 3] poses -> [C, Z] bool: one broadcast circle-rectangle
        test (``radius`` a scalar or [C])."""
        p = np.atleast_2d(np.asarray(poses, np.float64))
        x0, x1, z0, z1 = self._zone_rects()
        cx = np.clip(p[:, 0:1], x0[None], x1[None])        # [C, Z]
        cz = np.clip(p[:, 2:3], z0[None], z1[None])
        d2 = (cx - p[:, 0:1]) ** 2 + (cz - p[:, 2:3]) ** 2
        r = np.asarray(radius, np.float64).reshape(-1, 1)
        return d2 <= r ** 2


def _zone_scatter(zone: ObjectStore, src: ObjectStore, g_idx: list,
                  z_idx: list, freed: list) -> None:
    """Copy src rows ``g_idx`` into zone rows ``z_idx`` and deactivate the
    ``freed`` zone rows, in place: an index copy per field over exactly the
    listed rows (the reference's padded rows, dropped through an
    out-of-range index, never exist here).  Copied rows take the source
    row's live / tombstone state; freed slots clear both."""
    dev = zone.ids.device
    if freed:
        f = torch.as_tensor(freed, dtype=torch.long, device=dev)
        zone.active[f] = False
        zone.deleted[f] = False
    if g_idx:
        g = torch.as_tensor(g_idx, dtype=torch.long, device=src.ids.device)
        t = torch.as_tensor(z_idx, dtype=torch.long, device=dev)
        for name in _COPIED:
            getattr(zone, name)[t] = getattr(src, name)[g].to(dev)
        zone.active[t] = src.active[g].to(dev)
        zone.deleted[t] = deleted_mask(src)[g].to(dev)


@dataclass
class ZoneShardedStore:
    """The server map as Z independent ObjectStore shards + host routing.
    ``device`` places new shards (the card by default; a store built from
    given ``zones`` takes theirs)."""
    knobs: Knobs
    embed_dim: int
    grid: ZoneGrid
    zone_capacity: int = 0
    max_points: int = 0
    zones: list = field(default_factory=list)
    indexes: dict = field(default_factory=dict)  # zone -> ClusterIndex
    #                                  (enable_index; core.query discovers
    #                                   this attr for the two-stage plan)
    device: str | torch.device = "cuda"
    _dropped_oids: set = field(default_factory=set)  # refused by full shard
    _slot: list = field(default_factory=list)   # per zone: {oid -> slot}
    _ver: list = field(default_factory=list)    # per zone: copied version
    _free: list = field(default_factory=list)   # per zone: free slot stack

    def __post_init__(self):
        Z = self.grid.n_zones
        if not self.zone_capacity:
            # headroom over an even split so skewed scenes don't overflow
            self.zone_capacity = max(16, 2 * self.knobs.server_capacity // Z)
        if not self.max_points:
            self.max_points = self.knobs.max_object_points_server
        if not self.zones:
            self.device = resolve_device(self.device)
            self.zones = [init_store(self.zone_capacity, self.embed_dim,
                                     self.max_points, device=self.device)
                          for _ in range(Z)]
        else:
            self.device = self.zones[0].ids.device
            self.zone_capacity = int(self.zones[0].ids.shape[0])
            self.zones = [z if z.deleted is not None else
                          z._replace(deleted=torch.zeros_like(z.active))
                          for z in self.zones]
        # bookkeeping is rebuilt from the shards' own arrays, so passing
        # pre-populated zones keeps their occupied slots occupied
        self._slot, self._ver, self._free = [], [], []
        for zone in self.zones:
            act = (zone.active | deleted_mask(zone)).cpu().numpy()
            ids = zone.ids.cpu().numpy()
            ver = zone.version.cpu().numpy()
            occ = np.nonzero(act)[0]
            self._slot.append({int(ids[s]): int(s) for s in occ})
            vv = np.full((self.zone_capacity,), -1, np.int64)
            vv[occ] = ver[occ]
            self._ver.append(vv)
            self._free.append([s for s in
                               range(self.zone_capacity - 1, -1, -1)
                               if not act[s]])

    # ------------------------------------------------------------------
    def refresh_from(self, store: ObjectStore):
        """Mirror the global store into the shards (only version-advanced
        rows are copied).  Returns (freed_per_zone, changed_per_zone):
        per-zone lists of freed shard slots — feed these to
        SessionManager.reset_slots before the slot is reused — and per-zone
        dirtiness flags so clean zones can skip their next collect."""
        active = store.active.cpu().numpy()
        dele = deleted_mask(store).cpu().numpy()
        version = store.version.cpu().numpy()
        ids = store.ids.cpu().numpy()
        cent = store.centroid.cpu().numpy()
        # tombstones mirror like live rows (routed by their retained
        # centroid) until the global store retires the slot
        gidx = np.nonzero(active | dele)[0]
        Z = self.grid.n_zones
        now = [dict() for _ in range(Z)]
        if len(gidx):
            zids = self.grid.zone_of(cent[gidx])
            for g, z, oid in zip(gidx.tolist(), zids.tolist(),
                                 ids[gidx].tolist()):
                now[z][oid] = g

        freed_per_zone, changed_per_zone = [], []
        for z in range(Z):
            slot, ver, free = self._slot[z], self._ver[z], self._free[z]
            freed, g_list, s_list = [], [], []
            for oid in [o for o in slot if o not in now[z]]:
                s = slot.pop(oid)
                ver[s] = -1
                free.append(s)
                freed.append(s)
            for oid, g in now[z].items():
                s = slot.get(oid)
                if s is None:
                    if not free:
                        self._dropped_oids.add(oid)
                        continue
                    s = free.pop()
                    slot[oid] = s
                if ver[s] != version[g]:
                    ver[s] = version[g]
                    g_list.append(g)
                    s_list.append(s)
            freed_per_zone.append(freed)
            changed_per_zone.append(bool(freed or g_list))
            if freed or g_list:
                _zone_scatter(self.zones[z], store, g_list, s_list, freed)
                # cluster-index maintenance rides the same delta: exactly
                # the copied + freed shard slots are re-indexed
                zidx = self.indexes.get(z)
                if zidx is not None:
                    zidx.update_slots(self.zones[z], s_list + freed)
        return freed_per_zone, changed_per_zone

    # ------------------------------------------------------------------
    def enable_index(self, *, n_cells_target: int | None = None,
                     cell_cap: int | None = None,
                     min_flat_size: int | None = None) -> dict:
        """Attach one incrementally-maintained ClusterIndex per zone shard
        (``repro_torch.index``) over the zone's own rectangle, on the
        shard's device; from then on ``refresh_from`` keeps them current
        and ``core.query`` plans the two-stage sweep on any shard past
        ``min_flat_size`` live objects.  Place the shards (``place_on``)
        before enabling."""
        from repro_torch.index import ClusterIndex, DEFAULT_MIN_FLAT
        from repro_torch.index.cluster import CellGrid
        if min_flat_size is None:
            min_flat_size = DEFAULT_MIN_FLAT
        capz = self.zone_capacity
        if n_cells_target is None:
            n_cells_target = min(max(capz // 256, 16), 16_384)
        for z in range(self.grid.n_zones):
            ix, iz = divmod(z, self.grid.nz)
            x0 = self.grid.origin[0] + ix * self.grid.zone_size
            z0 = self.grid.origin[1] + iz * self.grid.zone_size
            cgrid = CellGrid.for_rect(x0, z0, self.grid.zone_size,
                                      self.grid.zone_size, n_cells_target)
            cc = cell_cap if cell_cap is not None else \
                bucket(max(4 * capz // cgrid.n_cells, 16))
            idx = ClusterIndex(grid=cgrid, embed_dim=self.embed_dim,
                               capacity=capz, cell_cap=int(cc),
                               min_flat_size=min_flat_size,
                               device=self.zones[z].ids.device)
            idx.refresh(self.zones[z])
            self.indexes[z] = idx
        return self.indexes

    # ------------------------------------------------------------------
    @property
    def dropped(self) -> int:
        """Distinct objects ever refused by a full shard (not retries)."""
        return len(self._dropped_oids)

    def subscriptions(self, pos, radius: float) -> np.ndarray:
        return self.grid.overlaps(pos, radius)

    def n_active(self) -> int:
        return int(sum(int(z.active.sum()) for z in self.zones))

    def place_on(self, mesh) -> None:
        """Place shard z on mesh device z % ndev (``mesh`` a
        ``launch.mesh.Mesh`` or a sequence of devices; a no-op where they
        already live there)."""
        from repro_torch.distributed.sharding import zone_shard_devices
        devs = zone_shard_devices(mesh, len(self.zones))
        self.zones = [ObjectStore(*(None if x is None else x.to(d)
                                    for x in zone))
                      for zone, d in zip(self.zones, devs)]
