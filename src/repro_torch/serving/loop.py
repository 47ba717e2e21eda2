"""Async pipelined serving loop: overlapped ingest / fleet-sync / query.

Port of ``repro.serving.loop``.  One tick issues all three dispatch
families against one consistent snapshot:

- **Ingest** writes the NEXT store generation.  Overlapped mode writes the
  dead back buffer of the ``SnapshotStore`` double buffer in place (the
  port's counterpart of the reference's donation): the scatter catches the
  two-tick-old buffer up (pending + current delta), O(changed rows) per
  tick instead of the O(capacity) copy the synchronous path pays.  Queries
  keep reading the published front buffer, so a request served mid-ingest
  sees exactly the pre-tick store, never a torn mix: the write goes to the
  other generation, and the one CUDA stream orders it after every query
  already queued against ``front``.
- **Fleet sync** issues every dirty zone's collect before materializing
  any packet (``FleetServer.tick_start`` / ``tick_finish``).
- **Queries** drain from the ``BatchScheduler`` with a non-blocking step
  fn (``PendingResult`` handles); the loop resolves results once per tick
  instead of once per batch.
- **Publish** swaps the double buffer; the loop's cluster index (when
  enabled) is maintained against the publish buffer from the delta's
  touched slots, so a two-stage plan stays exact against the snapshot.

The synchronous mode runs the identical workload with a synchronize after
every dispatch and the copying ingest (``apply_delta``: ``copy_store`` of
``front``, then the scatter).  It must stay functional: an in-place write
into ``front`` would change what an in-flight query reads.  Both modes
serve queries against the post-previous-tick snapshot, so their per-query
results are byte-identical.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.store import (ObjectStore, SnapshotStore, copy_store,
                                    deleted_mask)
from repro_torch.device import resolve_device, synchronize
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import span as obs_span
from repro_torch.serving.batching import (BatchScheduler, PendingResult,
                                          make_query_step_fn)


# ---------------------------------------------------------------------------
# The ingest scatter: a seeded stream of per-tick mapping deltas (the
# mapping frontend's output, pre-drawn so two loop variants replay the
# identical workload).
# ---------------------------------------------------------------------------
class IngestDelta(NamedTuple):
    """One tick's store mutations, SoA with a fixed row budget U."""
    slots: torch.Tensor      # [U] int32 target store slots (unique per tick)
    embed: torch.Tensor      # [U, E] f32 unit-norm
    centroid: torch.Tensor   # [U, 3] f32
    points: torch.Tensor     # [U, P, 3] f32
    n_points: torch.Tensor   # [U] int32
    label: torch.Tensor      # [U] int32
    tomb: torch.Tensor       # [U] bool — row is a removal (tombstone)
    valid: torch.Tensor      # [U] bool


def apply_delta_(store: ObjectStore, d: IngestDelta) -> ObjectStore:
    """Scatter one delta into ``store`` in place (invalid rows skipped);
    returns the store.

    Upserts refresh geometry/embedding and clear any tombstone (respawn);
    tombstone rows mirror ``_tombstone_slots`` semantics (active off,
    deleted on, point count zeroed).  Every touched row's version bumps so
    the sync protocol ships it."""
    if store.deleted is None:
        store = store._replace(deleted=deleted_mask(store).clone())
    up = d.valid & ~d.tomb
    tb = d.valid & d.tomb
    s_up = d.slots[up].long()
    s_tb = d.slots[tb].long()
    s_all = d.slots[d.valid].long()
    store.active[s_up] = True
    store.active[s_tb] = False
    store.deleted[s_up] = False
    store.deleted[s_tb] = True
    store.embed[s_up] = d.embed[up]
    store.label[s_up] = d.label[up]
    store.points[s_up] = d.points[up]
    store.n_points[s_up] = d.n_points[up]
    store.n_points[s_tb] = 0
    store.centroid[s_up] = d.centroid[up]
    store.obs_count[s_all] += 1
    store.version[s_all] += 1
    return store


def apply_delta(store: ObjectStore, d: IngestDelta) -> ObjectStore:
    """The functional update: a new store, ``store`` untouched (every
    [cap, ...] column is copied, as the reference's copying jit does)."""
    return apply_delta_(copy_store(store), d)


@dataclass
class IngestStream:
    """Seeded per-tick delta schedule over a store's live region.

    Each tick touches ``churn`` distinct slots drawn from ``[0, n_live)``:
    mostly upserts (drifted centroid, re-embedded, fresh cloud), a
    ``tomb_prob`` fraction tombstones.  A slot tombstoned at tick t may be
    re-upserted later (respawn) — versions only ever advance, so the sync
    protocol stays monotonic.  The draws are numpy's, in the reference's
    order; all tensors are pre-staged on the device as [T, U, ...] stacks
    and ``delta_at`` is a slice."""
    n_ticks: int
    n_live: int
    embed_dim: int
    max_points: int
    churn: int = 64
    tomb_prob: float = 0.05
    drift: float = 0.15            # per-touch centroid drift (m)
    room: float = 16.0
    seed: int = 0
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        T, U, E, P = self.n_ticks, self.churn, self.embed_dim, \
            self.max_points
        slots = np.stack([rng.choice(self.n_live, size=U, replace=False)
                          for _ in range(T)]).astype(np.int32)
        emb = rng.normal(size=(T, U, E)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
        # touched rows drift instead of teleporting: anchor to a per-slot
        # home so zone routing changes occasionally, not constantly
        half = self.room / 2
        home = rng.uniform(-half, half,
                           size=(self.n_live, 3)).astype(np.float32)
        home[:, 1] = rng.uniform(0.0, 2.0, size=self.n_live)
        cent = home[slots] + self.drift * rng.normal(
            size=(T, U, 3)).astype(np.float32)
        pts = rng.normal(size=(T, U, P, 3)).astype(np.float32)
        npts = rng.integers(4, P, size=(T, U)).astype(np.int32)
        lab = rng.integers(0, 20, size=(T, U)).astype(np.int32)
        tomb = rng.random(size=(T, U)) < self.tomb_prob
        put = lambda a: torch.from_numpy(a).to(self.device)   # noqa: E731
        self._stack = IngestDelta(
            slots=put(slots), embed=put(emb), centroid=put(cent),
            points=put(pts), n_points=put(npts), label=put(lab),
            tomb=put(tomb), valid=put(np.ones((T, U), bool)))
        self._slots_np = slots

    def delta_at(self, t: int) -> IngestDelta:
        return IngestDelta(*(x[t] for x in self._stack))

    def slots_at(self, t: int) -> np.ndarray:
        """Host copy of tick ``t``'s slots (no device read)."""
        return self._slots_np[t]


# ---------------------------------------------------------------------------
@dataclass
class ServingLoop:
    """Event-driven serving tick over (SnapshotStore, FleetServer, queries).

    One tick, in both modes, does the same logical work against the same
    snapshot (the store published at the END of the previous tick):

      1. issue the ingest scatter producing the next generation
      2. mirror the snapshot into the fleet zones + collect dirty zones
      3. submit this tick's query arrivals; run scheduler steps
      4. publish the new generation; resolve query results

    ``overlap=False`` synchronizes after every dispatch (and needs no back
    buffer: ``SnapshotStore(front=store)``); ``overlap=True`` resolves
    results once per tick and writes the back generation in place
    (``SnapshotStore.of(store)``).
    """
    server: object                    # FleetServer
    store: SnapshotStore
    ingest: IngestStream
    loadgen: object = None            # LoadGenerator | None
    overlap: bool = True
    batch_size: int = 16
    max_batches_per_tick: int = 2     # service capacity: backlog above this
    subscribe_radius: float = 6.0
    index: object = None              # ClusterIndex over the publish buffer
    # measured state
    tick_idx: int = 0
    results: dict = field(default_factory=dict)    # rid -> QueryResult (np)
    tick_ms: list = field(default_factory=list)
    sent_bytes: int = 0
    n_served: int = 0
    scheduler: BatchScheduler = None

    def __post_init__(self):
        self.scheduler = BatchScheduler(
            batch_size=self.batch_size,
            step_fn=make_query_step_fn(
                lambda: self.store.front, pad_to=self.batch_size,
                block=not self.overlap,
                get_index=(lambda: self.index)
                if self.index is not None else None))
        self._mode = "overlapped" if self.overlap else "sync"
        self._device = self.store.front.active.device
        self._deliverable = np.ones((self.server.n_clients,), bool)
        self._carry = {}          # overlap: last tick's unresolved results
        self._sync_started = []   # overlap: issued, unframed fleet collects

    def enable_index(self, **kw) -> None:
        """Attach a cluster index maintained against the PUBLISH buffer:
        refreshed from each published delta's touched slots, so two-stage
        plans read the same snapshot flat sweeps do."""
        from repro_torch.index import ClusterIndex
        self.index = ClusterIndex.for_target(self.store.front, **kw)
        self.__post_init__()       # rebuild the step fn with get_index

    # ------------------------------------------------------------------
    def _issue_ingest(self, d: IngestDelta) -> ObjectStore:
        with obs_span("serving.ingest", cat="ingest", mode=self._mode) as sp:
            if self.overlap:
                back = self.store.take_back()
                if self.store.pending is not None:
                    back = apply_delta_(back, self.store.pending)
                new = apply_delta_(back, d)
            else:
                new = apply_delta(self.store.front, d)
                synchronize(self._device)
            sp.fence(new.active)
        return new

    def _sync_tick(self, t: int) -> None:
        front = self.store.front
        with obs_span("serving.sync", cat="sync", mode=self._mode):
            if self.loadgen is not None:
                poses = self.loadgen.poses(t)
                if poses is not None:
                    self.server.set_poses(poses, self.subscribe_radius)
            self.server.refresh(front)
            if self.overlap:
                # issue only — framing is deferred a full tick
                # (_finish_sync): the sync state chains on the device
                self._sync_started.append(
                    (t, self.server.tick_start(self._deliverable, tick=t)))
            else:
                packets = self.server.tick(self._deliverable, tick=t,
                                           overlap=False)
                for _, pkt in packets:
                    pkt.block_until_ready()
                self._account_packets(packets, t)

    def _account_packets(self, packets: list, t: int) -> None:
        self.sent_bytes += sum(p.total_nbytes for _, p in packets)
        # The serving fleet is always-connected: every delivered packet
        # is applied immediately, so ack it the same tick (keeps inflight
        # queues O(1) instead of growing over the run).
        self.server.ack_tick(packets, tick=t)

    def _finish_sync(self, upto: int) -> None:
        """Frame every deferred collect issued at tick <= ``upto`` into
        packets, in issue order (byte-identical to the sequential path)."""
        while self._sync_started and self._sync_started[0][0] <= upto:
            t0, started = self._sync_started.pop(0)
            self._account_packets(self.server.tick_finish(started), t0)

    def _query_tick(self, t: int) -> dict:
        out = {}
        with obs_span("serving.query", cat="query", mode=self._mode):
            now = time.perf_counter()
            if self.loadgen is not None:
                for cid, spec in self.loadgen.arrivals[t]:
                    rid = self.scheduler.submit(spec)
                    self.loadgen.note_submit(rid, now)
            for _ in range(self.max_batches_per_tick):
                if not self.scheduler.waiting:
                    break
                served = self.scheduler.step()
                claim = time.perf_counter()
                if self.loadgen is not None:
                    for rid in served:
                        self.loadgen.note_served(rid, claim)
                out.update(served)
        return out

    def _resolve(self, out: dict) -> None:
        """Materialize this tick's query results — the one per-tick read
        in overlapped mode (it waits only on work queued before it)."""
        for rid, res in out.items():
            if isinstance(res, PendingResult):
                res = res.resolve()
                self.scheduler.done[rid] = res
            self.results[rid] = res
            self.n_served += 1
        if self.loadgen is not None and out:
            done = time.perf_counter()
            for rid in out:
                self.loadgen.note_resolved(rid, done)

    # ------------------------------------------------------------------
    def tick(self) -> None:
        t = self.tick_idx
        wall0 = time.perf_counter()
        d = self.ingest.delta_at(t)
        new = self._issue_ingest(d)
        self._sync_tick(t)
        out = self._query_tick(t)
        if self.overlap:
            self.store.publish(new, pending=d)
        else:
            # synchronous mode never touched the back buffer: swap the
            # front pointer only
            self.store.front = new
            self.store.pending = None
            self.store.version += 1
        if self.index is not None:
            # index maintenance rides the publish: update from the delta's
            # touched slots against the NEW publish buffer
            self.index.update_slots(self.store.front,
                                    self.ingest.slots_at(t))
        if self.overlap:
            # software pipelining: frame LAST tick's packets and resolve
            # LAST tick's queries now, carry this tick's.  The next tick's
            # in-place ingest writes the generation these queries read
            # only after they ran: the one stream orders them.
            self._finish_sync(t - 1)
            self._resolve(self._carry)
            self._carry = out
        else:
            self._resolve(out)
        self.tick_idx += 1
        ms = (time.perf_counter() - wall0) * 1e3
        self.tick_ms.append(ms)
        reg = obs_metrics.get_registry()
        if reg is not None:
            reg.histogram("serving_tick_ms",
                          "serving loop tick wall time").observe(
                              ms, mode=self._mode)

    def run(self, n_ticks: int) -> dict:
        for _ in range(n_ticks):
            self.tick()
        # drain: the carried tick, then whatever arrivals are still queued
        self._finish_sync(self.tick_idx)
        self._resolve(self._carry)
        self._carry = {}
        while self.scheduler.waiting:
            out = self.scheduler.step()
            claim = time.perf_counter()
            if self.loadgen is not None:
                for rid in out:
                    self.loadgen.note_served(rid, claim)
            self._resolve(out)
        synchronize(self._device)
        wall_s = sum(self.tick_ms) / 1e3
        stats = {
            "mode": self._mode,
            "n_ticks": n_ticks,
            "ticks_per_s": n_ticks / max(wall_s, 1e-9),
            "tick_ms": obs_metrics.exact_percentiles(self.tick_ms),
            "n_queries_served": self.n_served,
            "sent_bytes_total": int(self.sent_bytes),
            "store_version": self.store.version,
        }
        if self.loadgen is not None:
            stats.update(self.loadgen.record(self._mode))
        return stats
