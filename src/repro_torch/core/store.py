"""Server-side semantic map: objects as first-class, fixed-capacity SoA state.

Port of ``repro.core.store``.  A map object = (stable id, semantic
embedding, class label, 3D point cloud); the store is a NamedTuple of
tensors on one device, slot count is the capacity knob and ``active`` masks
live slots.  ``version`` increments on any semantically meaningful change,
and the update protocol (updates.py) ships exactly the objects whose version
advanced past the client's synced vector.

Map shrinkage: ``remove_objects`` turns a live slot into a version-bumped
tombstone (``active=False, deleted=True``) that keeps its slot until
``release_tombstones`` retires it.

Where the reference returned a functionally updated copy, the port writes
the store's tensors in place (``remove_objects``, ``release_tombstones``,
and the associate path in association.py); each such place says so.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.knobs import Knobs
from repro_torch.device import resolve_device


class ObjectStore(NamedTuple):
    ids: torch.Tensor          # [cap] int32, 0 = never assigned
    active: torch.Tensor       # [cap] bool
    embed: torch.Tensor        # [cap, E] f32, unit norm
    label: torch.Tensor        # [cap] int32
    points: torch.Tensor       # [cap, P, 3] f32 (masked by n_points)
    n_points: torch.Tensor     # [cap] int32
    centroid: torch.Tensor     # [cap, 3] f32
    bbox_min: torch.Tensor     # [cap, 3] f32
    bbox_max: torch.Tensor     # [cap, 3] f32
    obs_count: torch.Tensor    # [cap] int32
    version: torch.Tensor      # [cap] int32
    last_seen: torch.Tensor    # [cap] int32 frame index of last observation
    next_id: torch.Tensor      # [] int32
    deleted: torch.Tensor = None   # [cap] bool — tombstoned slots


def init_store(capacity: int, embed_dim: int, max_points: int, *,
               device="cuda") -> ObjectStore:
    dev = resolve_device(device)
    cap, P = capacity, max_points
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return ObjectStore(
        ids=torch.zeros((cap,), **i32),
        active=torch.zeros((cap,), dtype=torch.bool, device=dev),
        embed=torch.zeros((cap, embed_dim), **f32),
        label=torch.zeros((cap,), **i32),
        points=torch.zeros((cap, P, 3), **f32),
        n_points=torch.zeros((cap,), **i32),
        centroid=torch.zeros((cap, 3), **f32),
        bbox_min=torch.zeros((cap, 3), **f32),
        bbox_max=torch.zeros((cap, 3), **f32),
        obs_count=torch.zeros((cap,), **i32),
        version=torch.zeros((cap,), **i32),
        last_seen=torch.zeros((cap,), **i32),
        next_id=torch.ones((), **i32),
        deleted=torch.zeros((cap,), dtype=torch.bool, device=dev),
    )


def deleted_mask(store: ObjectStore) -> torch.Tensor:
    """[cap] bool tombstone mask; a store without the field reads all-False."""
    if store.deleted is None:
        return torch.zeros_like(store.active)
    return store.deleted


def store_from_knobs(knobs: Knobs, embed_dim: int, *,
                     device="cuda") -> ObjectStore:
    return init_store(knobs.server_capacity, embed_dim,
                      knobs.max_object_points_server, device=device)


def synthetic_store(n: int, capacity: int, embed_dim: int, max_points: int,
                    *, seed: int = 0, centroid_low=(-4.0, 0.0, -4.0),
                    centroid_high=(4.0, 2.0, 4.0), n_labels: int = 20,
                    obs_count: int = 3, device="cuda") -> ObjectStore:
    """Directly-filled store with ``n`` active objects (unit-norm
    embeddings, random clouds/centroids, version 1, ids 1..n).  The draws
    are numpy's, in the reference's order, so the store is bit-identical to
    ``repro.core.store.synthetic_store``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, embed_dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    cents = rng.uniform(centroid_low, centroid_high,
                        size=(n, 3)).astype(np.float32)
    labels = rng.integers(0, n_labels, size=n).astype(np.int32)
    pts = rng.normal(size=(n, max_points, 3)).astype(np.float32)
    npts = rng.integers(4, max_points, size=n).astype(np.int32)
    st = init_store(capacity, embed_dim, max_points, device=dev)
    put = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
    st.ids[:n] = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    st.active[:n] = True
    st.embed[:n] = put(emb)
    st.label[:n] = put(labels)
    st.points[:n] = put(pts)
    st.n_points[:n] = put(npts)
    st.centroid[:n] = put(cents)
    st.obs_count[:n] = obs_count
    st.version[:n] = 1
    st.next_id.fill_(n + 1)
    return st


def clustered_synthetic_store(n: int, capacity: int, embed_dim: int,
                              max_points: int, *, seed: int = 0,
                              n_proto: int = 64, proto_spread: float = 0.5,
                              n_hotspots: int = 128, room: float = 80.0,
                              hotspot_sigma: float = 1.2,
                              n_labels: int = 20, obs_count: int = 3,
                              device="cuda") -> ObjectStore:
    """Like ``synthetic_store`` but with structured content: centroids
    clustered around ``n_hotspots`` hotspots on a ``room``-sized floor, each
    hotspot populated from one of ``n_proto`` embedding prototypes (members
    = prototype + ``proto_spread``-norm noise, renormalized) — the regime
    where a cluster index earns its keep.  Point clouds are not filled
    (P = 1); n_points is drawn, so predicates still bite.  The draws are
    numpy's, in the reference's order: the same seed gives the same bits as
    ``repro.core.store.clustered_synthetic_store``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_proto, embed_dim)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    hid = rng.integers(0, n_hotspots, size=n)
    pid = hid % n_proto                  # spatially-correlated object kinds
    emb = protos[pid] + proto_spread / np.sqrt(embed_dim) * rng.normal(
        size=(n, embed_dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)

    hot = rng.uniform(-room / 2, room / 2, size=(n_hotspots, 3)) \
        .astype(np.float32)
    hot[:, 1] = rng.uniform(0.0, 2.0, size=n_hotspots)
    cents = hot[hid] + hotspot_sigma * rng.normal(size=(n, 3)) \
        .astype(np.float32)
    npts = rng.integers(4, max(max_points, 5), size=n)

    st = init_store(capacity, embed_dim, 1, device=dev)
    put = lambda a, dt: torch.from_numpy(                  # noqa: E731
        np.ascontiguousarray(a, dt)).to(dev)
    st.ids[:n] = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    st.active[:n] = True
    st.embed[:n] = put(emb, np.float32)
    st.label[:n] = put(pid % n_labels, np.int32)
    st.n_points[:n] = put(npts, np.int32)
    st.centroid[:n] = put(cents, np.float32)
    st.obs_count[:n] = obs_count
    st.version[:n] = 1
    st.next_id.fill_(n + 1)
    return st


def n_active(store: ObjectStore) -> torch.Tensor:
    return store.active.sum()


def copy_store(store: ObjectStore) -> ObjectStore:
    """Deep copy on the same device: every field a tensor of its own."""
    return ObjectStore(*(None if x is None else x.clone() for x in store))


@dataclass
class SnapshotStore:
    """Two-generation ObjectStore with snapshot versioning.

    Protocol (one serving tick)::

        scratch = snap.take_back()          # the dead generation t-1
        ... write this tick's changes into scratch ...
        ... queries and syncs read snap.front ...
        snap.publish(scratch, pending=delta_t)   # swap; version += 1

    ``front`` is the published snapshot every reader sees; publishing is a
    host-side swap, so a reader sees the pre-tick or the post-tick store,
    never a torn mix.  The port writes stores in place, so a
    ``MappingServer`` (or any other writer) may only write into the
    generation that ``take_back()`` handed out, never into ``front``:
    readers of ``front`` would see the writes.  ``back`` starts as a
    ``copy_store`` of ``front`` with tensors of its own.  ``version`` is the
    publish counter; ``pending`` the delta that produced ``front`` from
    ``back``."""
    front: ObjectStore
    back: ObjectStore | None = None
    version: int = 0
    pending: object = None

    @classmethod
    def of(cls, store: ObjectStore) -> "SnapshotStore":
        return cls(front=store, back=copy_store(store))

    def snapshot(self) -> tuple:
        """(published store, publish version)."""
        return self.front, self.version

    def take_back(self) -> ObjectStore:
        """Hand out the dead generation for writing (once per tick)."""
        assert self.back is not None, \
            "take_back called twice without an intervening publish"
        b = self.back
        self.back = None
        return b

    def publish(self, new_front: ObjectStore, *, pending=None) -> None:
        """Swap: the current front becomes the next write target."""
        assert self.back is None, "publish without take_back"
        self.back = self.front
        self.front = new_front
        self.pending = pending
        self.version += 1


def store_nbytes(store: ObjectStore) -> int:
    return int(sum(x.numel() * x.element_size() for x in store
                   if x is not None))


# ---------------------------------------------------------------------------
# Map shrinkage: tombstone removal + slot retirement
# ---------------------------------------------------------------------------
def remove_objects(store: ObjectStore, oids) -> ObjectStore:
    """Remove live objects by id: each matching slot becomes a tombstone
    (id, centroid and version retained; n_points zeroed).  No-op for
    unknown or already-dead ids.  Writes the store's tensors in place (the
    reference returned an updated copy); returns the store."""
    oids = np.atleast_1d(np.asarray(oids, np.int64))
    ids = store.ids.cpu().numpy()
    act = store.active.cpu().numpy()
    slots = np.nonzero(np.isin(ids, oids) & act)[0]
    if not len(slots):
        return store
    if store.deleted is None:
        store = store._replace(deleted=torch.zeros_like(store.active))
    s = torch.from_numpy(slots).to(store.ids.device)
    store.active[s] = False
    store.deleted[s] = True
    store.version[s] += 1
    store.n_points[s] = 0
    return store


def tombstone_slots(store: ObjectStore) -> np.ndarray:
    """Host-side indices of tombstoned slots (propagation pending)."""
    return np.nonzero(deleted_mask(store).cpu().numpy())[0]


def release_tombstones(store: ObjectStore, slots=None) -> ObjectStore:
    """Retire tombstones: clear id/version/deleted/obs_count so the slot is
    reusable.  Call only once every client's sync vector covers the
    tombstone's version.  ``slots`` defaults to every tombstone.  Writes
    the store's tensors in place; returns the store."""
    if slots is None:
        slots = tombstone_slots(store)
    slots = np.atleast_1d(np.asarray(slots, np.int64))
    if not len(slots):
        return store
    if store.deleted is None:
        store = store._replace(deleted=torch.zeros_like(store.active))
    s = torch.from_numpy(slots).to(store.ids.device)
    store.ids[s] = 0
    store.deleted[s] = False
    store.version[s] = 0
    store.obs_count[s] = 0
    return store
