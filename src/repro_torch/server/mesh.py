"""Mesh-sharded session tier: the [C, N] fleet sync state partitioned
across S session shards, one per device.

Port of ``repro.server.mesh``.  ``MeshSessionTier`` shards the CLIENT axis:
S plain SessionManager parts, part s owning rows for the clients a
``ClientRoster`` homes there (subscribed-zone affinity via
``distributed.sharding.client_shard_affinity``, round-robin before poses
exist).  Each part can be placed on its own device (``place_on``; a "mesh"
is a sequence of ``torch.device``s, and on one card every part shares it).

Correctness rests on a property of ``session._collect_fleet``: every
per-client row of the collect is computed independently (elementwise
change detection and priority, a per-row sort and gather, sums in a fixed
pairwise order), so a [C_s, N] collect over a subset of clients produces
BIT-IDENTICAL rows to the same clients' rows in the unsharded [C, N]
collect.  The tier therefore never merges tensors: ``MeshFleetPacket``
assembles the per-client byte/seq/count accounting into [C] arrays and
delegates ``packet_for(c)`` to the owning part's row view, so wire packets
are byte-identical to the single-device path.

Control-plane routing: acks, resyncs, rollbacks, and per-client resets are
routed to the owning shard through the roster (``parts[assign[c]]``, row
``row[c]``); store-slot events (``reset_slots``) broadcast to every part,
exactly like the unsharded [C, N] column clear.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.knobs import Knobs
from repro_torch.core.store import ObjectStore
from repro_torch.core.updates import UpdatePacket
from repro_torch.server.session import FleetSync, SessionManager


# ---------------------------------------------------------------------------
@dataclass
class ClientRoster:
    """Static client -> session-shard partition.

    ``assign[c]`` is the shard homing client c; ``row[c]`` its row inside
    that shard's [C_s, N] state (ascending-cid order, so a shard's rows
    are a stable sorted view of its members).  The roster is fixed for the
    tier's lifetime — re-homing a client would have to move its sync/ack/
    in-flight state across hosts mid-protocol (ROADMAP: live migration).
    """
    assign: np.ndarray                 # [C] int32
    n_shards: int
    row: np.ndarray = None             # [C] int32, derived
    members: tuple = None              # per-shard int64[C_s] global cids

    def __post_init__(self):
        self.assign = np.asarray(self.assign, np.int32)
        assert self.assign.ndim == 1
        assert (0 <= self.assign).all() and (self.assign < self.n_shards).all()
        C = len(self.assign)
        self.row = np.zeros((C,), np.int32)
        members = []
        for s in range(self.n_shards):
            cids = np.nonzero(self.assign == s)[0].astype(np.int64)
            members.append(cids)
            self.row[cids] = np.arange(len(cids), dtype=np.int32)
        self.members = tuple(members)

    @property
    def n_clients(self) -> int:
        return len(self.assign)

    def counts(self) -> np.ndarray:
        return np.array([len(m) for m in self.members], np.int64)

    @classmethod
    def round_robin(cls, n_clients: int, n_shards: int) -> "ClientRoster":
        return cls(assign=np.arange(n_clients, dtype=np.int32) % n_shards,
                   n_shards=n_shards)

    @classmethod
    def from_affinity(cls, subscribed: np.ndarray, n_shards: int,
                      zone_shards=None) -> "ClientRoster":
        """Partition by subscribed-zone affinity (majority vote over the
        zones' shard placement; see distributed.sharding)."""
        from repro_torch.distributed.sharding import client_shard_affinity
        return cls(assign=client_shard_affinity(subscribed, n_shards,
                                                zone_shards),
                   n_shards=n_shards)


# ---------------------------------------------------------------------------
@dataclass
class MeshFleetPacket:
    """One tick's C packets from S shard collects, merged ONLY at the wire
    boundary: the per-client accounting ([C] nbytes/counts/seqs/epoch/
    fresh) is assembled from the part packets, while the payload tensors
    stay in their per-part [C_s, U] batches — ``packet_for(c)`` is the
    owning part's row view, so the framed bytes are exactly the
    single-device packet's."""
    parts: list                        # per-shard FleetPacket (None = empty
    #                                    shard: no clients homed there)
    roster: ClientRoster
    counts: np.ndarray                 # [C] assembled
    nbytes: np.ndarray                 # [C] assembled
    seqs: np.ndarray                   # [C] assembled (-1 = unframed)
    epoch: np.ndarray                  # [C] assembled
    fresh: np.ndarray                  # [C] assembled
    tick: int
    zone: int = 0
    proto: bool = False

    @property
    def total_nbytes(self) -> int:
        return int(self.nbytes.sum())

    def block_until_ready(self) -> None:
        """Fence every shard's device tensors (serving-loop sync path)."""
        for pkt in self.parts:
            if pkt is not None:
                pkt.block_until_ready()

    def tomb_counts(self) -> np.ndarray:
        out = np.zeros_like(self.counts)
        for s, pkt in enumerate(self.parts):
            if pkt is not None:
                out[self.roster.members[s]] = pkt.tomb_counts()
        return out

    def packet_for(self, c: int) -> UpdatePacket:
        pkt = self.parts[int(self.roster.assign[c])]
        if pkt is None:
            return UpdatePacket(batch=None, count=0, nbytes=0, tick=self.tick)
        return pkt.packet_for(int(self.roster.row[c]))


class _MeshPending:
    """Issued-but-unfinished collects of every part, in shard order."""
    __slots__ = ("pending",)

    def __init__(self, pending):
        self.pending = pending         # per-shard _PendingCollect | None


# ---------------------------------------------------------------------------
@dataclass
class MeshSessionTier:
    """S SessionManager parts behind the SessionManager facade FleetServer
    drives: same control-plane methods (global client ids, routed to the
    owning shard) and the same collect_start/collect_finish hot path (every
    part dispatched per tier collect, so part ticks stay in lockstep with
    the tier tick and quiescence semantics match the unsharded session:
    tier dirty == OR over part dirty == unsharded dirty)."""
    knobs: Knobs
    capacity: int                      # N = slot count of the served store
    roster: ClientRoster = None
    n_clients: int = 0                 # used only when roster is None
    n_shards: int = 2                  # used only when roster is None
    budget: int = 64
    proto: bool = False
    donate: bool | None = False        # accepted, no effect
    parts: list = field(default_factory=list)
    devices: list = None               # per-shard device (None entries =
    #                                    the parts' own device)
    device: str | torch.device = "cuda"   # where unplaced parts live
    tick: int = 0

    def __post_init__(self):
        if self.roster is None:
            self.roster = ClientRoster.round_robin(self.n_clients,
                                                   self.n_shards)
        self.n_clients = self.roster.n_clients
        self.n_shards = self.roster.n_shards
        if self.devices is None:
            self.devices = [None] * self.n_shards
        if not self.parts:
            self.parts = [
                SessionManager(knobs=self.knobs, n_clients=len(m),
                               capacity=self.capacity, budget=self.budget,
                               proto=self.proto, donate=self.donate,
                               subscribed=np.zeros((len(m),), bool),
                               device=self.device)
                if len(m) else None
                for m in self.roster.members]

    # -- partition helpers -------------------------------------------------
    def _route(self, c: int):
        part = self.parts[int(self.roster.assign[c])]
        assert part is not None
        return part, int(self.roster.row[c])

    def _live(self):
        return ((s, p) for s, p in enumerate(self.parts) if p is not None)

    def _assemble1(self, get, dtype, fill=0):
        out = np.full((self.n_clients,), fill, dtype)
        for s, p in self._live():
            out[self.roster.members[s]] = get(p)
        return out

    def place_on(self, mesh) -> None:
        """Move each part's device-resident sync state onto its mesh
        device (round-robin, same placement rule as zone_shard_devices).
        Host-side per-client state stays with the part object."""
        from repro_torch.distributed.sharding import zone_shard_devices
        self.devices = zone_shard_devices(mesh, self.n_shards)
        for s, p in self._live():
            d = self.devices[s]
            p.sync = FleetSync(*(x.to(d) for x in p.sync))
            p._class_budgets = p._class_budgets.to(d)
            p.device = d

    # -- SessionManager facade: state reads --------------------------------
    @property
    def dirty(self) -> bool:
        return any(p.dirty for _, p in self._live())

    @dirty.setter
    def dirty(self, v: bool) -> None:
        for _, p in self._live():
            p.dirty = v

    @property
    def subscribed(self) -> np.ndarray:
        return self._assemble1(lambda p: p.subscribed, bool, False)

    @property
    def user_pos(self) -> np.ndarray:
        out = np.zeros((self.n_clients, 3), np.float32)
        for s, p in self._live():
            out[self.roster.members[s]] = p.user_pos
        return out

    # -- control plane (routed to the owning shard) ------------------------
    def set_all(self, *, subscribed=None, user_pos=None):
        for s, p in self._live():
            m = self.roster.members[s]
            p.set_all(
                subscribed=None if subscribed is None
                else np.asarray(subscribed, bool)[m],
                user_pos=None if user_pos is None
                else np.asarray(user_pos, np.float32)[m])

    def set_client(self, c: int, **kw):
        part, r = self._route(c)
        part.set_client(r, **kw)

    def reset_client(self, c: int, *, keep_seq: bool = False):
        part, r = self._route(c)
        part.reset_client(r, keep_seq=keep_seq)

    def reset_slots(self, slots):
        # store-slot lifecycle is global: every shard's columns clear,
        # exactly like the unsharded [C, N] column clear
        for _, p in self._live():
            p.reset_slots(slots)

    def ack(self, c: int, seq: int):
        part, r = self._route(c)
        part.ack(r, seq)

    def rollback(self, c: int):
        part, r = self._route(c)
        part.rollback(r)

    def oldest_unacked_tick(self, c: int):
        part, r = self._route(c)
        return part.oldest_unacked_tick(r)

    def deletion_debt(self, store: ObjectStore) -> np.ndarray:
        out = np.zeros((self.n_clients, self.capacity), bool)
        for s, p in self._live():
            out[self.roster.members[s]] = p.deletion_debt(store)
        return out

    # -- hot path ----------------------------------------------------------
    def collect_start(self, store: ObjectStore, *,
                      deliverable: np.ndarray | None = None, zone: int = 0,
                      epoch: np.ndarray | None = None,
                      fresh: np.ndarray | None = None,
                      now: int | None = None) -> _MeshPending:
        """Issue every shard's collect (parts on different devices run
        concurrently; on one card they queue).  Every live part collects
        whenever the tier does, so part ticks / quiescence advance in
        lockstep with the unsharded session."""
        pend = [None] * self.n_shards
        for s, p in self._live():
            m = self.roster.members[s]
            st = store
            if self.devices[s] is not None \
                    and store.ids.device != self.devices[s]:
                # placed tier: the shard reads a device-local copy
                st = ObjectStore(*(None if x is None
                                   else x.to(self.devices[s])
                                   for x in store))
            pend[s] = p.collect_start(
                st,
                deliverable=None if deliverable is None
                else np.asarray(deliverable, bool)[m],
                zone=zone,
                epoch=None if epoch is None else np.asarray(epoch)[m],
                fresh=None if fresh is None else np.asarray(fresh)[m],
                now=now)
        return _MeshPending(pend)

    def collect_finish(self, pending: _MeshPending) -> MeshFleetPacket:
        parts = [None] * self.n_shards
        for s, p in self._live():
            if pending.pending[s] is not None:
                parts[s] = p.collect_finish(pending.pending[s])
        roster = self.roster
        pkt = MeshFleetPacket(
            parts=parts, roster=roster,
            counts=self._assemble_pkt(parts, "counts", np.int64, 0),
            nbytes=self._assemble_pkt(parts, "nbytes", np.int64, 0),
            seqs=self._assemble_pkt(parts, "seqs", np.int64, -1),
            epoch=self._assemble_pkt(parts, "epoch", np.int64, 0),
            fresh=self._assemble_pkt(parts, "fresh", bool, False),
            tick=self.tick,
            zone=parts[self._first_live()].zone
            if self._first_live() is not None else 0,
            proto=self.proto)
        self.tick += 1
        return pkt

    def _first_live(self):
        for s, p in enumerate(self.parts):
            if p is not None:
                return s
        return None

    def _assemble_pkt(self, parts, name, dtype, fill):
        out = np.full((self.n_clients,), fill, dtype)
        for s, pkt in enumerate(parts):
            if pkt is not None:
                out[self.roster.members[s]] = getattr(pkt, name)
        return out

    def collect(self, store: ObjectStore, *,
                deliverable: np.ndarray | None = None, zone: int = 0,
                epoch: np.ndarray | None = None,
                fresh: np.ndarray | None = None,
                now: int | None = None) -> MeshFleetPacket:
        return self.collect_finish(self.collect_start(
            store, deliverable=deliverable, zone=zone, epoch=epoch,
            fresh=fresh, now=now))
