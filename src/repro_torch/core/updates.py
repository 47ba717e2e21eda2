"""Object-level incremental update protocol (paper Sec. 3.2, Fig. 6).

Port of ``repro.core.updates`` for the single-client path.  The server
tracks the per-client synced version of every object and, on each update
tick, ships exactly the objects that are new or modified since the last
sync, observed at least ``min_obs_before_sync`` times, and admitted by the
prioritizer.  The selection runs on the host over the store's small control
columns; the packet body is one gather + downsample on the store's device,
with points cast to f16 for the wire.  Byte accounting is exact over the
wire format below.
"""
from __future__ import annotations

import functools
import zlib
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import geometry as geo
from repro_torch.core.knobs import Knobs
from repro_torch.core.local_map import UpdateBatch
from repro_torch.core.store import ObjectStore, deleted_mask

# wire format per object: id(4) + label(2) + version(4) + n_points(2)
# + centroid(3*4) + embedding(E*2, fp16) + points(n*3*2, fp16).
# The deleted flag rides the sign bit of the n_points field, so live rows
# cost no extra bytes; a tombstone row ships id(4) + version(4) + flagged
# n_points(1) = 9 B.
_HEADER_B = 4 + 2 + 4 + 2 + 12
TOMBSTONE_NBYTES = 9

_MIN_BUCKET = 8


def update_nbytes(embed_dim: int, n_points: int, *,
                  deleted: bool = False) -> int:
    if deleted:
        return TOMBSTONE_NBYTES
    return _HEADER_B + 2 * embed_dim + 6 * int(n_points)


def bucket(n: int) -> int:
    """Round ``n`` up to the next power-of-two batch bucket (min 8) — the
    reference's padding policy, kept so packets match row for row."""
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


@functools.lru_cache(maxsize=None)
def class_budget_table(knobs: Knobs, n_labels: int = 256) -> np.ndarray:
    """[n_labels] per-class client point budgets: ``class_point_overrides``
    where declared (capped at the client buffer size), the default
    elsewhere.  Cached per (frozen) Knobs and frozen against writes."""
    table = np.full((n_labels,), knobs.max_object_points_client, np.int32)
    for cid, pts in knobs.class_point_overrides:
        if 0 <= cid < n_labels:
            table[cid] = min(int(pts), knobs.max_object_points_client)
    table.setflags(write=False)
    return table


def _gather_batch(store: ObjectStore, idx: torch.Tensor, valid: torch.Tensor,
                  budgets: torch.Tensor, out_cap: int) -> UpdateBatch:
    """The SoA packet body for slots ``idx``: per-row budgets shape the
    valid prefix of one [U, out_cap, 3] gather; tombstone rows ship no
    geometry and keep the store centroid."""
    del_rows = deleted_mask(store)[idx]
    pts, n = geo.downsample_dyn(store.points[idx], store.n_points[idx],
                                budgets, out_cap)
    n = torch.where(del_rows, 0, n)
    pts = torch.where(del_rows[:, None, None], 0.0, pts)
    cent = geo.centroid_bbox(pts, n)[0]
    cent = torch.where(del_rows[:, None], store.centroid[idx], cent)
    return UpdateBatch(
        oid=store.ids[idx], embed=store.embed[idx], label=store.label[idx],
        points=pts.to(torch.float16), n_points=n, centroid=cent,
        version=store.version[idx], valid=valid, deleted=del_rows)


@dataclass
class UpdatePacket:
    batch: UpdateBatch | None    # None for an empty tick
    count: int                   # live rows in batch (rest is padding)
    nbytes: int
    tick: int
    # hardened-protocol framing fields (unused on the single-client path:
    # seq None means "apply on arrival, no ordering")
    zone: int = 0
    seq: int | None = None
    epoch: int = 0
    fresh: bool = False
    checksum: int | None = None

    def compute_checksum(self) -> int:
        """crc32 over the packet header and the id/version columns, packed
        as explicit int64 bytes exactly as the reference packs them."""
        head = np.array([self.count, self.zone, self.epoch,
                         -1 if self.seq is None else self.seq],
                        np.int64).tobytes()
        if self.batch is None or self.count == 0:
            return zlib.crc32(head)
        o = self.batch.oid[:self.count].cpu().numpy().astype(np.int64)
        v = self.batch.version[:self.count].cpu().numpy().astype(np.int64)
        return zlib.crc32(head + o.tobytes() + v.tobytes())

    @property
    def deleted_oids(self) -> list:
        """Object ids tombstoned by this packet (empty for live-only)."""
        if self.batch is None or self.count == 0 \
                or self.batch.deleted is None:
            return []
        d = self.batch.deleted[:self.count].cpu().numpy()
        o = self.batch.oid[:self.count].cpu().numpy()
        return [int(x) for x in o[d]]


class SyncState(NamedTuple):
    """Server-side per-client sync vector: last shipped version per slot."""
    synced_version: np.ndarray   # [cap] int32 (host-side bookkeeping)


def init_sync(capacity: int) -> SyncState:
    return SyncState(synced_version=np.zeros((capacity,), np.int32))


def collect_updates(store: ObjectStore, sync: SyncState, knobs: Knobs, *,
                    tick: int, full_map: bool = False,
                    priorities: np.ndarray | None = None,
                    max_updates: int | None = None):
    """Build the update packet for one tick.

    Live rows ship when new-or-modified past the sync vector and past the
    min-obs transient filter; tombstones ship to a client whose sync vector
    ever covered the object, ahead of live rows.  Fully empty slots reset
    their sync entry.  ``full_map=True`` is the device-cloud baseline
    (whole scene each tick).  Returns (packet, new_sync).
    """
    active = store.active.cpu().numpy()
    version = store.version.cpu().numpy()
    obs = store.obs_count.cpu().numpy()
    dele = deleted_mask(store).cpu().numpy()
    live = active & (obs >= knobs.min_obs_before_sync)
    tomb = dele & (sync.synced_version > 0) \
        & (version > sync.synced_version)
    if not full_map:
        live &= version > sync.synced_version
    changed = live | tomb
    idx = np.nonzero(changed)[0]
    if priorities is not None and len(idx):
        pri = priorities[idx].astype(np.float64)
        pri[tomb[idx]] = np.inf        # deletions first: they free slots
        idx = idx[np.argsort(-pri, kind="stable")]
    elif tomb.any() and len(idx):
        idx = idx[np.argsort(~tomb[idx], kind="stable")]
    if max_updates is not None:
        idx = idx[:max_updates]

    new_synced = sync.synced_version.copy()
    new_synced[idx] = version[idx]
    # empty slots must not pin a stale synced version against their next
    # occupant
    new_synced[~active & ~dele] = 0
    new_sync = SyncState(synced_version=new_synced)
    U = len(idx)
    if U == 0:
        return UpdatePacket(batch=None, count=0, nbytes=0, tick=tick), \
            new_sync

    Ub = bucket(U)
    idx_pad = np.zeros((Ub,), np.int64)
    idx_pad[:U] = idx
    budgets = class_budget_table(knobs)[
        np.clip(store.label.cpu().numpy()[idx_pad], 0, 255)]
    dev = store.ids.device
    batch = _gather_batch(store, torch.from_numpy(idx_pad).to(dev),
                          torch.from_numpy(np.arange(Ub) < U).to(dev),
                          torch.from_numpy(budgets).to(dev),
                          knobs.max_object_points_client)
    # exact per-object byte accounting (padding rows excluded): live rows
    # at full wire size, tombstones at the 9-byte header
    n_host = batch.n_points[:U].cpu().numpy()
    n_tomb = int(tomb[idx].sum())
    E = store.embed.shape[1]
    nbytes = (U - n_tomb) * (_HEADER_B + 2 * E) + 6 * int(n_host.sum()) \
        + n_tomb * TOMBSTONE_NBYTES
    return UpdatePacket(batch=batch, count=U, nbytes=nbytes, tick=tick), \
        new_sync
