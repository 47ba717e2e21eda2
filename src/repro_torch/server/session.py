"""Multi-tenant per-client sync: stacked sync vectors, one batched collect.

Port of ``repro.server.session``.  The fleet's sync state is ONE ``[C, N]``
tensor and a whole update tick is one batched pass of torch ops
(``_collect_fleet``), where the reference fused it into one XLA dispatch:

  changed[C, N]  = active & (obs >= min_obs[c]) & (version > synced[c])
                   & subscribed-and-deliverable[c]
  priority[C, N] = per-client priority over the store rows
  top-k          = per-client budgeted selection, a stable sort on (score
                   desc, slot asc) — ``lax.top_k``'s tie order; tied
                   tombstones (all 1e30) and equal-distance objects are
                   the normal case, so never a bare ``torch.topk``
  gather         = gather + stride-downsample straight from store rows to
                   the [C, U, Pc, 3] wire tensor
  sync advance   = a scatter of the shipped versions into a padded column
                   that takes the invalid rows (the reference's dropped
                   out-of-range writes), returned as NEW tensors: a caller
                   that keeps its own sync tensor never sees it change

Every per-client row is computed by elementwise ops, per-row sorts and
gathers, and sums taken in a fixed pairwise order, so a [C_s, N] collect
over a subset of clients gives the same bits as those clients' rows of
the [C, N] collect, on any device (the mesh tier relies on it).  Byte
accounting matches core/updates.py exactly (same wire format).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.knobs import Knobs
from repro_torch.core.local_map import UpdateBatch, compute_priority
from repro_torch.core.store import ObjectStore, deleted_mask
from repro_torch.core.updates import (_HEADER_B, PROTO_HEADER_NBYTES,
                                      TOMBSTONE_NBYTES, UpdatePacket,
                                      class_budget_table)
from repro_torch.device import resolve_device
from repro_torch.obs.trace import block_until_ready
from repro_torch.obs.trace import span as obs_span


class FleetSync(NamedTuple):
    """Stacked per-client sync state, on the session's device."""
    synced_version: torch.Tensor    # [C, N] int32 — last shipped version
    ever_sent: torch.Tensor = None  # [C, N] bool — row was EVER shipped


class FleetBatch(NamedTuple):
    """C clients' update packets as one SoA tuple (leading [C, U] dims)."""
    oid: torch.Tensor        # [C, U] int32
    embed: torch.Tensor      # [C, U, E] f32
    label: torch.Tensor      # [C, U] int32
    points: torch.Tensor     # [C, U, Pc, 3] f16
    n_points: torch.Tensor   # [C, U] int32
    centroid: torch.Tensor   # [C, U, 3] f32
    version: torch.Tensor    # [C, U] int32
    valid: torch.Tensor      # [C, U] bool — live-row prefix mask per client
    deleted: torch.Tensor = None   # [C, U] bool — tombstone rows


def _pairwise_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in a fixed pairwise order (zero-padded to a power of
    two, then halved): elementwise adds only, so a row's sum never depends
    on how many rows ride along (a library reduction may split by the
    output count)."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _downsample_gather(points: torch.Tensor, n_points: torch.Tensor,
                       idx: torch.Tensor, row_budget: torch.Tensor,
                       budget: int):
    """Gather store rows ``idx`` [C, U] and stride-downsample each row to
    its own ``row_budget`` (``budget`` is the shared buffer width and hard
    cap): output point i reads point (i * n) // b, an int32 floor division,
    when the row has more than b points."""
    P = points.shape[1]
    n = torch.clamp(n_points[idx], min=1)                   # [C, U] i32
    b = torch.clamp(row_budget, 1, budget)[..., None]       # [C, U, 1]
    ar = torch.arange(budget, dtype=torch.int32, device=points.device)
    sub = torch.where(n[..., None] > b,
                      torch.div(ar * n[..., None], b, rounding_mode="floor"),
                      ar)
    sub = torch.clamp(sub, max=P - 1)                       # [C, U, B]
    out = points[idx[..., None], sub.long()]                # [C, U, B, 3]
    n_out = torch.minimum(n[..., None], b)[..., 0].to(torch.int32)
    valid = ar < n_out[..., None]
    return torch.where(valid[..., None], out, 0.0), n_out


def _scatter_rows(base: torch.Tensor, cols: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """A new [C, N] tensor: ``base`` with ``vals`` written at ``cols``
    [C, U] per row, where a column of N (an invalid row) lands in a padding
    column that is cut off: dropped, never raising, never row N-1."""
    C, N = base.shape
    out = torch.cat([base, base.new_zeros((C, 1))], dim=1)
    out.scatter_(1, cols, vals)
    return out[:, :N]


def _collect_fleet(store: ObjectStore, synced: torch.Tensor,
                   ever_sent: torch.Tensor, clear_mask: torch.Tensor,
                   mask_c: torch.Tensor, min_obs: torch.Tensor,
                   user_pos: torch.Tensor, interest_embeds,
                   class_budgets: torch.Tensor, *, budget: int,
                   points_budget: int, knobs: Knobs):
    """One update tick for the whole fleet.

    Returns (FleetBatch, new_synced [C, N], new_ever [C, N], nbytes [C],
    counts [C], idx [C, U] — the store slots behind each packet row, for
    the sender's in-flight/ack bookkeeping).  Inputs are never written."""
    # slots freed since the last collect (reset_slots) clear here
    synced = torch.where(clear_mask[None], 0, synced)
    ever_sent = ever_sent & ~clear_mask[None]
    dele = deleted_mask(store)
    ahead = store.version[None] > synced
    live = (store.active[None]
            & (store.obs_count[None] >= min_obs[:, None]) & ahead)
    # a tombstone ships to exactly the clients the object was EVER shipped
    # to (not synced > 0: a rollback drops sync to the acked vector, but
    # the deletion must still reach a client whose ack was lost upstream)
    tomb = dele[None] & ever_sent & ahead
    changed = (live | tomb) & mask_c[:, None]
    pri = compute_priority(store.embed, store.label, store.centroid,
                           user_pos=user_pos[:, None, :], knobs=knobs,
                           interest_embeds=interest_embeds)   # [C, N]
    # deletions jump the queue: a freed client slot outranks a refresh
    pri = torch.where(tomb, 1e30, pri)
    score = torch.where(changed, pri, -torch.inf)
    top, order = torch.sort(score, dim=1, descending=True, stable=True)
    top, idx = top[:, :budget], order[:, :budget]            # [C, U]
    valid = torch.isfinite(top)
    row_del = torch.gather(tomb, 1, idx) & valid             # [C, U]

    row_b = class_budgets[torch.clamp(store.label[idx], 0, 255).long()]
    pts, n = _downsample_gather(store.points, store.n_points, idx, row_b,
                                points_budget)
    n = torch.where(row_del, 0, n)
    pts = torch.where(row_del[..., None, None], 0.0, pts)
    # the centroid of the f32 gathered points, before the f16 wire cast
    denom = torch.clamp(n, min=1).to(torch.float32)[..., None]
    cent = _pairwise_sum(pts, dim=2) / denom                 # [C, U, 3]
    cent = torch.where(row_del[..., None], store.centroid[idx], cent)
    version = store.version[idx]
    batch = FleetBatch(
        oid=store.ids[idx], embed=store.embed[idx], label=store.label[idx],
        points=pts.to(torch.float16), n_points=n, centroid=cent,
        version=version, valid=valid, deleted=row_del)

    N = synced.shape[1]
    shipped = torch.where(valid, idx, N)                     # N -> dropped
    new_synced = _scatter_rows(synced, shipped, version)
    # fully-empty slots must not pin a stale synced version on any client
    new_synced = torch.where((store.active | dele)[None], new_synced, 0)
    # only reset_slots / reset_client may forget a shipped row
    new_ever = _scatter_rows(ever_sent, shipped,
                             torch.ones_like(valid))

    E = store.embed.shape[1]
    n_live = torch.where(valid, n, 0)
    counts = valid.sum(dim=-1)
    n_tomb = row_del.sum(dim=-1)
    nbytes = ((counts - n_tomb) * (_HEADER_B + 2 * E)
              + 6 * n_live.sum(dim=-1) + n_tomb * TOMBSTONE_NBYTES)
    return (batch, new_synced, new_ever, nbytes.to(torch.int32),
            counts.to(torch.int32), idx)


class _PendingCollect(NamedTuple):
    """An issued-but-unresolved collect: device tensors plus the host-side
    context ``collect_finish`` needs.  Nothing here forces a host sync."""
    batch: FleetBatch
    nbytes: torch.Tensor     # [C] device
    counts: torch.Tensor     # [C] device
    idx: torch.Tensor        # [C, U] device
    mask: np.ndarray         # [C] bool — subscribed & deliverable at issue
    zone: int
    epoch: np.ndarray
    fresh: np.ndarray
    now: int | None
    scrub: np.ndarray = None   # [N] bool — slots freed AFTER issue; their
    #                            rows must not enter in-flight/ever_sent
    #                            bookkeeping at finish (deferred pipeline)


@dataclass
class FleetPacket:
    """One tick's C packets: the FleetBatch plus host-side accounting.

    When the session assigns sequence numbers (``seqs[c] >= 0``) the
    single-client views carry the hardened-protocol framing: per-(client,
    zone) seq, the client's sync epoch, and — under the fault-injection
    transport (``proto``) — a crc32 checksum.  Framing bytes are counted
    in ``nbytes`` only when ``proto`` is on."""
    batch: FleetBatch
    counts: np.ndarray       # [C] live rows per client
    nbytes: np.ndarray       # [C] exact wire bytes per client
    tick: int
    zone: int = 0            # zone shard this packet's seq streams belong to
    seqs: np.ndarray = None  # [C] int64 — per-client seq (-1 = unframed)
    epoch: np.ndarray = None  # [C] int64 — per-client sync epoch
    fresh: np.ndarray = None  # [C] bool — epoch restarted from scratch
    proto: bool = False      # fault-injection transport: checksum + header

    @property
    def total_nbytes(self) -> int:
        return int(self.nbytes.sum())

    def block_until_ready(self) -> None:
        """Wait for the packet's device tensors (the card's queued work)."""
        if self.batch is not None:
            block_until_ready(self.batch.valid)

    def tomb_counts(self) -> np.ndarray:
        """[C] tombstone rows actually shipped per client this tick."""
        if self.batch is None or self.batch.deleted is None:
            return np.zeros_like(self.counts)
        return (self.batch.deleted & self.batch.valid).sum(
            dim=1).cpu().numpy()

    def packet_for(self, c: int) -> UpdatePacket:
        """Single-client UpdatePacket view (leading-dim slice, no copy)."""
        cnt = int(self.counts[c])
        if cnt == 0:
            return UpdatePacket(batch=None, count=0, nbytes=0, tick=self.tick)
        b = self.batch
        ub = UpdateBatch(oid=b.oid[c], embed=b.embed[c], label=b.label[c],
                         points=b.points[c], n_points=b.n_points[c],
                         centroid=b.centroid[c], version=b.version[c],
                         valid=b.valid[c],
                         deleted=None if b.deleted is None else b.deleted[c])
        pkt = UpdatePacket(batch=ub, count=cnt, nbytes=int(self.nbytes[c]),
                           tick=self.tick)
        if self.seqs is not None and int(self.seqs[c]) >= 0:
            pkt.zone = self.zone
            pkt.seq = int(self.seqs[c])
            pkt.epoch = int(self.epoch[c])
            pkt.fresh = bool(self.fresh[c])
            if self.proto:
                pkt.checksum = pkt.compute_checksum()
        return pkt


@dataclass
class SessionManager:
    """C clients' sync state against one store (or one zone shard).

    Per-client knobs live as stacked host arrays (pose, min-obs,
    subscription); the sync vectors live on ``device`` as one [C, N]
    tensor.  ``collect`` is the fleet hot path: one batched collect for all
    C clients.  Unsubscribed / undeliverable clients don't advance their
    sync rows, so their next deliverable tick coalesces everything they
    missed.  ``donate`` is accepted for the reference's signature and has
    no effect: the collect always returns new sync tensors."""
    knobs: Knobs
    n_clients: int
    capacity: int                      # N = slot count of the served store
    budget: int = 64                   # max objects shipped per client/tick
    sync: FleetSync = None
    subscribed: np.ndarray = None      # [C] bool
    user_pos: np.ndarray = None        # [C, 3] f32
    min_obs: np.ndarray = None         # [C] int32
    interest_embeds: object = None     # optional [I, E] shared interests
    tick: int = 0
    dirty: bool = True                 # False only when the last collect
    #                                    covered every subscriber and
    #                                    shipped nothing (fleet quiesced)
    proto: bool = False                # fault-injection transport on: count
    #                                    framing bytes + checksum packets
    donate: bool | None = False        # accepted, no effect
    acked: np.ndarray = None           # [C, N] int32 — versions each client
    #                                    has CONFIRMED applying
    next_seq: np.ndarray = None        # [C] int64 — next seq per client
    inflight: list = None              # per-client deque of
    #                                    (seq, tick, slots, versions)
    ever_sent: np.ndarray = None       # [C, N] bool — host mirror of the
    #                                    rows EVER shipped to the client
    device: str | torch.device = "cuda"

    def __post_init__(self):
        C, N = self.n_clients, self.capacity
        self.budget = min(self.budget, N)
        if self.sync is not None:
            self.device = self.sync.synced_version.device
        self.device = resolve_device(self.device)
        if self.sync is None:
            self.sync = FleetSync(
                torch.zeros((C, N), dtype=torch.int32, device=self.device),
                torch.zeros((C, N), dtype=torch.bool, device=self.device))
        elif self.sync.ever_sent is None:
            self.sync = self.sync._replace(
                ever_sent=torch.from_numpy(np.array(self.ever_sent, bool))
                .to(self.device) if self.ever_sent is not None
                else torch.zeros((C, N), dtype=torch.bool,
                                 device=self.device))
        if self.subscribed is None:
            self.subscribed = np.ones((C,), bool)
        if self.user_pos is None:
            self.user_pos = np.zeros((C, 3), np.float32)
        if self.min_obs is None:
            self.min_obs = np.full((C,), self.knobs.min_obs_before_sync,
                                   np.int32)
        if self.acked is None:
            self.acked = np.zeros((C, N), np.int32)
        if self.next_seq is None:
            self.next_seq = np.zeros((C,), np.int64)
        if self.inflight is None:
            self.inflight = [deque() for _ in range(C)]
        if self.ever_sent is None:
            self.ever_sent = np.zeros((C, N), bool)
        self._open_scrubs = []      # scrub masks of issued, unfinished collects
        # [N] bool — slots freed since the last collect; the next collect
        # zeroes their synced/ever_sent columns
        self._pending_clear = np.zeros((N,), bool)
        self._class_budgets = torch.from_numpy(
            class_budget_table(self.knobs).copy()).to(self.device)

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(self.device)

    # -- per-client knob management (control plane, off the hot path) ------
    def set_client(self, c: int, *, user_pos=None, min_obs=None,
                   subscribed=None):
        if user_pos is not None:
            self.user_pos[c] = np.asarray(user_pos, np.float32)
        if min_obs is not None:
            if int(min_obs) != int(self.min_obs[c]):
                self.dirty = True      # eligibility changed: re-collect
            self.min_obs[c] = int(min_obs)
        if subscribed is not None:
            if bool(subscribed) != bool(self.subscribed[c]):
                self.dirty = True      # membership changed: re-collect
            self.subscribed[c] = bool(subscribed)

    def set_all(self, *, subscribed=None, user_pos=None):
        """Whole-fleet writes of the stacked per-client knob arrays; dirty
        marking stays with the caller."""
        if subscribed is not None:
            self.subscribed[:] = np.asarray(subscribed, bool)
        if user_pos is not None:
            self.user_pos[:] = np.asarray(user_pos, np.float32)

    def reset_client(self, c: int, *, keep_seq: bool = False):
        """Fresh join (or zone re-entry): zero the sync + acked rows so the
        next tick ships a full catch-up of the subscribed store.
        ``keep_seq=True`` preserves the client's sequence stream (zone-leave
        prune: only epoch bumps may restart seqs)."""
        self.dirty = True
        sv = self.sync.synced_version.clone()
        ev = self.sync.ever_sent.clone()
        sv[c] = 0
        ev[c] = False
        self.sync = FleetSync(sv, ev)
        self.acked[c] = 0
        self.ever_sent[c] = False
        self.inflight[c].clear()
        if not keep_seq:
            self.next_seq[c] = 0

    def reset_slots(self, slots):
        """Store slots were freed/reassigned (zone shard slot reuse): forget
        every client's synced AND acked version there, and scrub them from
        in-flight entries, so a future occupant ships and is never falsely
        'already acked' by its predecessor's confirmations."""
        if len(slots):
            self.dirty = True
            sl = np.asarray(slots)
            hit = np.zeros((self.capacity,), bool)
            hit[sl] = True
            # the device clear is deferred to the next collect
            self._pending_clear |= hit
            self.acked[:, sl] = 0
            self.ever_sent[:, sl] = False
            for m in self._open_scrubs:
                m[sl] = True
            for q in self.inflight:
                for k, (seq, tk, islots, ivers) in enumerate(q):
                    drop = hit[islots]
                    if drop.any():
                        keep = ~drop
                        q[k] = (seq, tk, islots[keep], ivers[keep])

    # -- ack / resync bookkeeping (hardened protocol control plane) --------
    def ack(self, c: int, seq: int):
        """Cumulative ack: fold the in-flight versions up to and including
        ``seq`` into the client's acked vector (monotonic)."""
        q = self.inflight[c]
        while q and q[0][0] <= seq:
            _, _, islots, ivers = q.popleft()
            if len(islots):
                self.acked[c, islots] = np.maximum(self.acked[c, islots],
                                                   ivers)

    def rollback(self, c: int):
        """Resync: the sync row falls back to the acked vector, the
        sequence stream restarts, and the next collect re-ships exactly the
        un-acked delta.  ``ever_sent`` survives: an upstream ack loss must
        not suppress a later tombstone."""
        self.dirty = True
        sv = self.sync.synced_version.clone()
        sv[c] = self._put(self.acked[c])
        self.sync = self.sync._replace(synced_version=sv)
        self.inflight[c].clear()
        self.next_seq[c] = 0

    def oldest_unacked_tick(self, c: int):
        """Collect tick of the client's oldest un-acked packet (None if
        nothing is outstanding)."""
        q = self.inflight[c]
        return q[0][1] if q else None

    def deletion_debt(self, store: ObjectStore) -> np.ndarray:
        """[C, N] bool: client c still owes an ack that covers slot n's
        tombstone (ever shipped, acked version below the tombstone's)."""
        dele = deleted_mask(store).cpu().numpy()
        ver = store.version.cpu().numpy()
        return dele[None] & self.ever_sent & (self.acked < ver[None])

    # -- hot path ----------------------------------------------------------
    def collect_start(self, store: ObjectStore, *,
                      deliverable: np.ndarray | None = None, zone: int = 0,
                      epoch: np.ndarray | None = None,
                      fresh: np.ndarray | None = None,
                      now: int | None = None) -> _PendingCollect:
        """Issue the fleet collect; return its device tensors.  The sync
        state is rebound to the collect's new tensors and nothing is read
        back to the host: ``collect_finish`` does the transfers."""
        mask = self.subscribed if deliverable is None \
            else self.subscribed & np.asarray(deliverable, bool)
        clear = self._put(self._pending_clear)
        self._pending_clear = np.zeros((self.capacity,), bool)
        with obs_span("session.collect_fleet", cat="sync", zone=zone) as sp:
            batch, new_synced, new_ever, nbytes, counts, idx = \
                _collect_fleet(
                    store, self.sync.synced_version, self.sync.ever_sent,
                    clear, self._put(mask), self._put(self.min_obs),
                    self._put(self.user_pos), self.interest_embeds,
                    self._class_budgets, budget=self.budget,
                    points_budget=self.knobs.max_object_points_client,
                    knobs=self.knobs)
            sp.fence(batch.valid)
        self.sync = FleetSync(new_synced, new_ever)
        # the collect consumes the dirty flag; finish (or any event in
        # between) re-raises it
        self.dirty = False
        scrub = np.zeros((self.capacity,), bool)
        self._open_scrubs.append(scrub)
        return _PendingCollect(batch=batch, nbytes=nbytes, counts=counts,
                               idx=idx, mask=mask, zone=zone, epoch=epoch,
                               fresh=fresh, now=now, scrub=scrub)

    def collect_finish(self, p: _PendingCollect) -> FleetPacket:
        """Materialize an issued collect: host transfer + seq/in-flight
        bookkeeping.  Finishing in issue order keeps the packets
        byte-identical to the sequential ``collect`` path."""
        batch = p.batch
        counts = p.counts.cpu().numpy()
        nbytes = p.nbytes.cpu().numpy().astype(np.int64)
        seqs = np.full((self.n_clients,), -1, np.int64)
        if counts.any():
            idx_h = p.idx.cpu().numpy()
            valid_h = batch.valid.cpu().numpy()
            vers_h = batch.version.cpu().numpy()
            stamp = self.tick if p.now is None else p.now
            scrubbed = p.scrub is not None and p.scrub.any()
            for c in np.nonzero(counts)[0]:
                seqs[c] = self.next_seq[c]
                self.next_seq[c] += 1
                v = valid_h[c]
                sl, vv = idx_h[c][v], vers_h[c][v]
                if scrubbed:
                    # slots freed after issue: the packet still ships as
                    # computed, but its rows stay out of the retirement
                    # bookkeeping of the slot's next occupant
                    keep = ~p.scrub[sl]
                    sl, vv = sl[keep], vv[keep]
                self.inflight[c].append((int(seqs[c]), stamp, sl, vv))
                self.ever_sent[c, sl] = True
            if self.proto:
                nbytes[counts > 0] += PROTO_HEADER_NBYTES
        pkt = FleetPacket(batch=batch, counts=counts, nbytes=nbytes,
                          tick=self.tick, zone=p.zone, seqs=seqs,
                          epoch=np.zeros((self.n_clients,), np.int64)
                          if p.epoch is None
                          else np.asarray(p.epoch, np.int64),
                          fresh=np.zeros((self.n_clients,), bool)
                          if p.fresh is None else np.asarray(p.fresh, bool),
                          proto=self.proto)
        self.tick += 1
        if p.scrub is not None:
            self._open_scrubs = [m for m in self._open_scrubs
                                 if m is not p.scrub]
        # quiesced iff every subscriber was covered and nothing shipped;
        # OR, not assign, so marks raised between issue and finish survive
        self.dirty = (self.dirty or bool(pkt.counts.any())
                      or not (p.mask == self.subscribed).all())
        return pkt

    def collect(self, store: ObjectStore, *,
                deliverable: np.ndarray | None = None, zone: int = 0,
                epoch: np.ndarray | None = None,
                fresh: np.ndarray | None = None,
                now: int | None = None) -> FleetPacket:
        """One fleet update tick for all C clients.  Every non-empty
        per-client packet takes the next number on that client's sequence
        stream, and the shipped (slot, version) pairs are queued in-flight
        until the client's cumulative ack lands."""
        return self.collect_finish(self.collect_start(
            store, deliverable=deliverable, zone=zone, epoch=epoch,
            fresh=fresh, now=now))
