"""Event-driven server map: applies ObjectEvents straight onto an
ObjectStore, bypassing the rendering/mapping frontend.

Port of ``repro.sim.world``.  The scenario engine's focus is the
update/query/network loop, so the world is authoritative and exact: spawns
write fully-observed objects (class-basis embedding, primitive point cloud,
obs_count past the transient filter), moves translate geometry with a
version bump, removes tombstone through ``store.remove_objects`` — the same
protocol path a mapping frontend's prune would take.  All randomness is a
per-object ``default_rng(seed, oid)`` stream, so a world replayed from the
same Scenario is bit-identical, and equal to the reference's.

Where the reference returned functionally updated stores, the port writes
the store's slots in place.  Host reads (``_slot_of``, ``gc``, the live
sets) are one ``.cpu()`` per field.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.knobs import Knobs
from repro_torch.core.store import (ObjectStore, deleted_mask,
                                    release_tombstones, remove_objects,
                                    store_from_knobs)
from repro_torch.data.scenes import _object_cloud
from repro_torch.device import resolve_device
from repro_torch.perception.embedder import OracleEmbedder
from repro_torch.sim.scenario import ObjectEvent


@dataclass
class WorldState:
    knobs: Knobs
    embed_dim: int
    seed: int = 0
    device: str | torch.device = "cuda"
    store: ObjectStore = None
    embedder: OracleEmbedder = None
    labels: dict = field(default_factory=dict)       # oid -> class_id
    removed_at: dict = field(default_factory=dict)   # oid -> removal tick
    spawned: int = 0
    moved: int = 0
    removed: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.store is None:
            self.store = store_from_knobs(self.knobs, self.embed_dim,
                                          device=self.device)
        if self.embedder is None:
            # noiseless oracle: the world's embeddings ARE the class basis,
            # so query ground truth is exact and replay is deterministic
            self.embedder = OracleEmbedder(embed_dim=self.embed_dim,
                                           noise=0.0)

    # ------------------------------------------------------------------
    def _slot_of(self, oid: int) -> int | None:
        ids = self.store.ids.cpu().numpy()
        act = self.store.active.cpu().numpy()
        hits = np.nonzero((ids == oid) & act)[0]
        return int(hits[0]) if len(hits) else None

    def apply(self, ev: ObjectEvent, *, tick: int) -> None:
        if ev.kind == "spawn":
            self._spawn(ev)
        elif ev.kind == "move":
            self._move(ev)
        elif ev.kind == "remove":
            if self._slot_of(ev.oid) is not None:
                self.store = remove_objects(self.store, [ev.oid])
                self.removed_at[ev.oid] = tick
                self.removed += 1
        else:
            raise ValueError(f"unknown event kind {ev.kind!r}")

    def _spawn(self, ev: ObjectEvent) -> None:
        st = self.store
        occupied = st.active.cpu().numpy() | deleted_mask(st).cpu().numpy()
        free = np.nonzero(~occupied)[0]
        if not len(free) or self._slot_of(ev.oid) is not None:
            return
        s = int(free[0])
        rng = np.random.default_rng((self.seed, ev.oid))
        P = st.points.shape[1]
        n = int(min(ev.n_points, P))
        cloud = _object_cloud(rng, ev.class_id % 3, 0.5, n) \
            + np.asarray(ev.pos, np.float32)              # f64, as the ref
        pts = np.zeros((P, 3), np.float32)
        pts[:n] = cloud
        put = lambda a: torch.from_numpy(                  # noqa: E731
            np.asarray(a, np.float32)).to(self.device)
        self.labels[ev.oid] = ev.class_id
        self.spawned += 1
        st.ids[s] = ev.oid
        st.active[s] = True
        st.embed[s] = put(self.embedder.basis_np[ev.class_id])
        st.label[s] = ev.class_id
        st.points[s] = put(pts)
        st.n_points[s] = n
        st.centroid[s] = put(cloud.mean(axis=0))
        st.bbox_min[s] = put(cloud.min(axis=0))
        st.bbox_max[s] = put(cloud.max(axis=0))
        st.obs_count[s] = max(self.knobs.min_obs_before_sync, 1) + 1
        st.version[s] = 1
        st.next_id.clamp_(min=ev.oid + 1)

    def _move(self, ev: ObjectEvent) -> None:
        s = self._slot_of(ev.oid)
        if s is None:
            return
        st = self.store
        d = torch.tensor(ev.delta, dtype=torch.float32, device=self.device)
        P = st.points.shape[1]
        mask = (torch.arange(P, device=self.device) < st.n_points[s])[:, None]
        self.moved += 1
        st.points[s] = torch.where(mask, st.points[s] + d,
                                   torch.zeros((), device=self.device))
        st.centroid[s] += d
        st.bbox_min[s] += d
        st.bbox_max[s] += d
        st.version[s] += 1

    # ------------------------------------------------------------------
    def gc(self, *, tick: int, ttl: int, protected=frozenset()) -> int:
        """Release tombstones older than ``ttl`` ticks AND not in
        ``protected`` — the oids the FleetServer reports blocked because
        some subscriber's ACKED sync version does not yet cover the
        deletion (`FleetServer.blocked_tombstone_oids`, lease-capped).
        Age alone is NOT sufficient: a client offline longer than the TTL
        would otherwise keep the ghost object forever.  Returns how many
        slots were retired; the zone mirror / sync layers observe the
        retirement on the next refresh."""
        ids = self.store.ids.cpu().numpy()
        dele = deleted_mask(self.store).cpu().numpy()
        slots = [s for s in np.nonzero(dele)[0]
                 if tick - self.removed_at.get(int(ids[s]), tick) >= ttl
                 and int(ids[s]) not in protected]
        if slots:
            for s in slots:             # before the release zeroes the ids
                self.removed_at.pop(int(ids[s]), None)
            self.store = release_tombstones(self.store, slots)
        return len(slots)

    # ------------------------------------------------------------------
    def live_ids(self) -> set:
        st = self.store
        return set(int(i) for i in
                   st.ids.cpu().numpy()[st.active.cpu().numpy()])

    def live_classes(self) -> np.ndarray:
        st = self.store
        return np.unique(st.label.cpu().numpy()[st.active.cpu().numpy()])
