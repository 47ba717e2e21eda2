"""Fleet server: the zone-sharded store composed with per-zone sessions.

Port of ``repro.server.fleet.FleetServer``.  A server tick is one batched
collect per *dirty* zone — never a Python loop over clients — and a client
subscribed to quiet zones costs (and receives) nothing.  Each client's
delivery / ingest / mode step is ``core.runtime.ClientSession``.

``FleetSimulator`` drives tens-to-hundreds of clients against one mapped
scene: heterogeneous NetworkModels (mixed RTTs / bandwidths, staggered
outages), join / leave churn mid-session, per-client poses wandering the
room (zone subscriptions follow), and SQ queries multiplexed through
``serving.batching.BatchScheduler``.  It is a thin wrapper: it translates
its seeded fleet parameters into a declarative ``sim.Scenario`` and replays
it through ``sim.ScenarioEngine``, keeping only the stats-dict surface and
the scheduler's query hook.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.knobs import Knobs
from repro_torch.core.query import Query, QueryResult, compile_query
from repro_torch.core.runtime import ClientSession, NetworkModel
from repro_torch.core.store import ObjectStore
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import span as obs_span
from repro_torch.server.session import SessionManager
from repro_torch.server.zones import ZoneGrid, ZoneShardedStore


# ---------------------------------------------------------------------------
@dataclass
class FleetServer:
    """Zone-sharded store + per-zone multi-client sync sessions.

    The hardened control plane lives here: per-client sync epochs (bumped
    on resync / rejoin / retransmit timeout), cumulative-ack routing into
    the per-zone sessions, and sync-vector-driven tombstone retirement —
    a deleted slot is releasable only once every subscriber's ACKED
    version covers the deletion, with a lease timeout evicting
    permanently-partitioned clients so they can't leak slots forever."""
    knobs: Knobs
    embed_dim: int
    n_clients: int
    grid: ZoneGrid
    budget: int = 64                   # per-client objects per tick per zone
    proto: bool = False                # fault-injection transport framing
    donate: bool | None = False        # accepted, no effect
    n_session_shards: int = 1          # >1: each zone's session tier is a
    #                                    MeshSessionTier — the client axis
    #                                    partitioned across S session shards
    #                                    (one per device), control plane
    #                                    routed to the owning shard, packets
    #                                    byte-identical (server/mesh.py)
    roster: object = None              # shared ClientRoster when sharded
    #                                    (None = round-robin over clients)
    index: bool = True                 # maintain per-zone cluster indexes
    #                                    (repro_torch.index; queries go
    #                                     two-stage only past min_flat_size,
    #                                     so small fleets keep flat sweeps)
    device: str | torch.device = "cuda"   # where the shards and sessions
    #                                       live
    zoned: ZoneShardedStore = None
    sessions: list = field(default_factory=list)   # one SessionManager/zone
    subscribed: np.ndarray = None      # [C, Z] bool (host mirror)
    epoch: np.ndarray = None           # [C] int64 per-client sync epoch
    epoch_fresh: np.ndarray = None     # [C] bool — epoch restarted from
    #                                    scratch (client resets its map on
    #                                    adoption); cleared on first ack
    last_ack_tick: np.ndarray = None   # [C] int64 — lease bookkeeping
    needs_fresh: np.ndarray = None     # [C] bool — lease expired: next
    #                                    deliverable tick forces a fresh
    #                                    epoch instead of trusting state

    def __post_init__(self):
        if self.zoned is None:
            self.zoned = ZoneShardedStore(knobs=self.knobs,
                                          embed_dim=self.embed_dim,
                                          grid=self.grid, device=self.device)
        self.device = self.zoned.device
        if self.index and not self.zoned.indexes:
            self.zoned.enable_index()
        if not self.sessions:
            if self.n_session_shards > 1:
                from repro_torch.server.mesh import (ClientRoster,
                                                     MeshSessionTier)
                if self.roster is None:
                    self.roster = ClientRoster.round_robin(
                        self.n_clients, self.n_session_shards)
                self.sessions = [
                    MeshSessionTier(knobs=self.knobs, roster=self.roster,
                                    capacity=self.zoned.zone_capacity,
                                    budget=self.budget, proto=self.proto,
                                    donate=self.donate, device=self.device)
                    for _ in range(self.grid.n_zones)]
            else:
                self.sessions = [
                    SessionManager(
                        knobs=self.knobs, n_clients=self.n_clients,
                        capacity=self.zoned.zone_capacity,
                        budget=self.budget, proto=self.proto,
                        donate=self.donate,
                        subscribed=np.zeros((self.n_clients,), bool),
                        device=self.device)
                    for _ in range(self.grid.n_zones)]
        if self.subscribed is None:
            self.subscribed = np.zeros((self.n_clients, self.grid.n_zones),
                                       bool)
        C = self.n_clients
        if self.epoch is None:
            self.epoch = np.zeros((C,), np.int64)
        if self.epoch_fresh is None:
            self.epoch_fresh = np.zeros((C,), bool)
        if self.last_ack_tick is None:
            self.last_ack_tick = np.zeros((C,), np.int64)
        if self.needs_fresh is None:
            self.needs_fresh = np.zeros((C,), bool)

    # -- control plane -----------------------------------------------------
    def refresh(self, store: ObjectStore):
        """Mirror the mapping frontend's store into the zone shards; freed
        shard slots reset every client's sync version there (slot reuse
        must not hide the next occupant behind a stale synced_version),
        and zones with any copied/freed rows are marked dirty."""
        freed, changed = self.zoned.refresh_from(store)
        for z in range(self.grid.n_zones):
            if freed[z]:
                self.sessions[z].reset_slots(freed[z])
            elif changed[z]:
                self.sessions[z].dirty = True

    def set_client_pose(self, c: int, pos, radius: float):
        subs = self.zoned.subscriptions(pos, radius)
        left = self.subscribed[c] & ~subs
        self.subscribed[c] = subs
        for z in range(self.grid.n_zones):
            if left[z]:
                # zone exit: forget what the client held there (it prunes
                # its side too — prune-on-unsubscribe), so re-entry ships a
                # clean catch-up instead of trusting stale state.  The seq
                # stream survives: no epoch bump for a mere zone crossing.
                self.sessions[z].reset_client(c, keep_seq=True)
            self.sessions[z].set_client(c, user_pos=pos, subscribed=subs[z])

    def set_poses(self, poses: np.ndarray, radius: float) -> None:
        """Whole-fleet pose update: one [C, Z] broadcast subscription test
        + per-zone array writes, semantically identical to C
        ``set_client_pose`` calls (the 60 FPS pose-stream hot path — the
        per-client loop is ~C*Z Python iterations per tick)."""
        poses = np.asarray(poses, np.float32)
        subs = self.zoned.grid.overlaps_batch(poses, radius)   # [C, Z]
        left = self.subscribed & ~subs
        changed = self.subscribed != subs
        self.subscribed = subs
        for z, sess in enumerate(self.sessions):
            for c in np.nonzero(left[:, z])[0]:
                sess.reset_client(int(c), keep_seq=True)   # zone exit
            if changed[:, z].any():
                sess.dirty = True                          # membership
            # routed whole-fleet write: in-place on a plain session, split
            # by the roster on a sharded tier (direct [:] writes would
            # silently no-op against the tier's assembled-copy property)
            sess.set_all(subscribed=subs[:, z], user_pos=poses)

    def _bump_epoch(self, c: int, *, fresh: bool):
        """Advance the client's sync epoch.  fresh=True restarts the whole
        session (join / crash recovery / lease expiry: client resets its
        map, server forgets sync + acked state); fresh=False is a resync
        rollback (sync falls back to acked, un-acked delta re-ships).

        A pending fresh flag is sticky: if the client never acked the
        fresh epoch (its packets may all have been lost), a follow-up
        resync bump must stay fresh — downgrading to a rollback would let
        the client keep a map the server has already written off."""
        fresh = fresh or bool(self.epoch_fresh[c])
        self.epoch[c] += 1
        self.epoch_fresh[c] = fresh
        for s in self.sessions:
            if fresh:
                s.reset_client(c)
            else:
                s.rollback(c)

    def join(self, c: int, pos, radius: float, *, tick: int = 0):
        self._bump_epoch(c, fresh=True)
        self.last_ack_tick[c] = tick
        self.needs_fresh[c] = False
        self.set_client_pose(c, pos, radius)

    def leave(self, c: int):
        self.subscribed[c] = False
        for s in self.sessions:
            s.reset_client(c)          # a gone client must not pin slots
            s.set_client(c, subscribed=False)

    def crash(self, c: int):
        """The device restarted: its volatile protocol/map state is gone.
        Drop the server-side session rows so nothing stale blocks
        retirement while it is down; the rejoin (`join`) hands it a fresh
        epoch and a full catch-up."""
        for s in self.sessions:
            s.reset_client(c)

    def crash_shard(self, shard: int, *, tick: int = 0):
        """A session shard's host died: its slice of the sync/ack/in-flight
        state is gone.  Recovery is per-CLIENT fresh epochs for exactly the
        clients homed on that shard (their next deliverable tick ships a
        full catch-up); clients on surviving shards keep their epochs,
        streams, and in-flight windows untouched — asserted in
        tests/test_fault_tolerance.py."""
        assert self.roster is not None, "crash_shard needs a sharded tier"
        for c in np.nonzero(self.roster.assign == shard)[0]:
            self._bump_epoch(int(c), fresh=True)
            self.last_ack_tick[c] = tick
            self.needs_fresh[c] = False

    # -- hardened-protocol control plane -----------------------------------
    def ack(self, c: int, zone: int, epoch: int, seq: int, *, tick: int = 0):
        """Route a client's cumulative ack ``(zone, epoch, seq)`` into the
        zone session.  Acks from a superseded epoch are dropped — their seq
        numbering no longer matches the stream."""
        if epoch != int(self.epoch[c]):
            reg = obs_metrics.get_registry()
            if reg is not None:
                reg.counter("fleet_stale_acks_total",
                            "acks dropped for a superseded epoch").inc(
                                client=int(c))
            return
        self.epoch_fresh[c] = False    # client adopted: later packets cont
        self.last_ack_tick[c] = tick
        self.sessions[zone].ack(c, seq)
        reg = obs_metrics.get_registry()
        if reg is not None:
            reg.counter("fleet_acks_total",
                        "cumulative acks applied").inc(client=int(c),
                                                       zone=int(zone))

    def ack_tick(self, packets: list, *, tick: int) -> int:
        """Batched ack of one tick's own packets — the always-connected
        fleet fast path (the serving loop's clients apply every delivered
        packet immediately).  Equivalent to ``ack(c, z, epoch[c], seq)``
        per framed client but without the per-call epoch lookup: these
        seqs were just issued under the CURRENT epochs, so none can be
        stale.  Returns the number of (client, zone) acks applied."""
        n = 0
        acked = np.zeros((self.n_clients,), bool)
        for z, pkt in packets:
            sess = self.sessions[z]
            for c in np.nonzero(pkt.seqs >= 0)[0]:
                sess.ack(int(c), int(pkt.seqs[c]))
            acked[pkt.seqs >= 0] = True
            n += int((pkt.seqs >= 0).sum())
        if acked.any():
            self.epoch_fresh[acked] = False
            self.last_ack_tick[acked] = tick
        reg = obs_metrics.get_registry()
        if reg is not None and n:
            reg.counter("fleet_acks_total",
                        "cumulative acks applied").inc(n, batched=1)
        return n

    def request_resync(self, c: int):
        """Client detected an unrecoverable gap: roll it back to its acked
        state under a bumped epoch (its reorder buffers restart too)."""
        with obs_span("fleet.resync", cat="sync", client=int(c)):
            self._bump_epoch(c, fresh=False)
        reg = obs_metrics.get_registry()
        if reg is not None:
            reg.counter("fleet_resyncs_total",
                        "server-side resync rollbacks").inc(client=int(c))

    def maintain(self, *, tick: int, deliverable: np.ndarray,
                 retx_ticks: int):
        """Server-side retransmit timeout: a reachable client whose oldest
        un-acked packet has aged past ``retx_ticks`` is rolled back (cont
        epoch) so the un-acked delta re-ships — covers tail loss the
        client-side gap detector can't see (nothing after the hole)."""
        for c in range(self.n_clients):
            if not deliverable[c] or not self.subscribed[c].any():
                continue
            oldest = [t for s in self.sessions
                      if (t := s.oldest_unacked_tick(c)) is not None]
            if oldest and tick - min(oldest) >= retx_ticks:
                self._bump_epoch(c, fresh=False)

    def blocked_tombstone_oids(self, *, tick: int,
                               lease_ticks: int | None = None) -> set:
        """Object ids whose tombstoned slots must NOT be released yet:
        some subscriber's acked version does not cover the deletion.

        The lease is the partition escape hatch: a client that owes
        deletions and hasn't acked anything for ``lease_ticks`` forfeits
        its hold — its next deliverable tick starts a fresh epoch (full
        catch-up), so correctness survives the forfeit.  Clients owing
        nothing keep their lease trivially current (an idle caught-up
        client is never expired into a spurious resync)."""
        owes = np.zeros((self.n_clients,), bool)
        debt = []
        for z, sess in enumerate(self.sessions):
            d = sess.deletion_debt(self.zoned.zones[z])    # [C, N]
            d &= sess.subscribed[:, None]
            debt.append(d)
            owes |= d.any(axis=1)
        self.last_ack_tick[~owes] = tick
        if lease_ticks is not None:
            expired = owes & (tick - self.last_ack_tick >= lease_ticks)
            if expired.any():
                self.needs_fresh |= expired
                for z in range(len(debt)):
                    debt[z][expired] = False
        blocked = set()
        for z, d in enumerate(debt):
            slots = np.nonzero(d.any(axis=0))[0]
            if len(slots):
                ids = self.zoned.zones[z].ids.cpu().numpy()[slots]
                blocked.update(int(i) for i in ids)
        return blocked

    # -- hot path ------------------------------------------------------------
    def tick(self, deliverable: np.ndarray, *, tick: int | None = None,
             overlap: bool = False) -> list:
        """One fleet update tick: one batched collect per DIRTY zone that
        has a deliverable subscriber.  A zone is clean (skipped outright)
        when its last collect covered every subscriber and shipped nothing,
        and no refresh/join/subscription change has touched it since —
        idle-tick cost scales with changed zones, not zone count.  Returns
        [(zone, FleetPacket)] — per-client packets are leading-dim views.

        ``overlap=True`` issues every dirty zone's collect first and only
        then materializes the packets (collect_start/finish): zone k's
        host bookkeeping overlaps zone k+1's device compute instead of
        waiting per zone.  Zones are independent (per-zone
        sessions, server state only read), so the packets are byte-
        identical to the sequential path — asserted in tests.
        """
        if overlap:
            return self.tick_finish(self.tick_start(deliverable, tick=tick))
        self._epoch_catchup(deliverable, tick)
        out = []
        with obs_span("fleet.tick", cat="sync") as sp:
            zs = [z for z, sess in enumerate(self.sessions)
                  if sess.dirty and (sess.subscribed & deliverable).any()]
            out = [(z, self.sessions[z].collect(
                self.zoned.zones[z], deliverable=deliverable, zone=z,
                epoch=self.epoch, fresh=self.epoch_fresh, now=tick))
                for z in zs]
            sp.set(zones_collected=len(out))
        self._tick_metrics(out)
        return out

    def _epoch_catchup(self, deliverable: np.ndarray,
                       tick: int | None) -> None:
        pend = self.needs_fresh & np.asarray(deliverable, bool) \
            & self.subscribed.any(axis=1)
        for c in np.nonzero(pend)[0]:
            # lease expired while partitioned: now that the client is
            # reachable again, restart its session under a fresh epoch
            self._bump_epoch(int(c), fresh=True)
            self.last_ack_tick[c] = self.sessions[0].tick if tick is None \
                else tick
            self.needs_fresh[c] = False

    def tick_start(self, deliverable: np.ndarray, *,
                   tick: int | None = None) -> list:
        """Issue every dirty zone's collect; return [(zone,
        _PendingCollect)] for ``tick_finish``.  The sync state
        (synced_version + ever_sent) lives on the device, so the next
        tick's collects chain off these with no host dependency on the
        framing."""
        deliverable = np.asarray(deliverable, bool)
        self._epoch_catchup(deliverable, tick)
        with obs_span("fleet.tick_start", cat="sync") as sp:
            started = [(z, self.sessions[z].collect_start(
                self.zoned.zones[z], deliverable=deliverable, zone=z,
                epoch=self.epoch, fresh=self.epoch_fresh, now=tick))
                for z, sess in enumerate(self.sessions)
                if sess.dirty and (sess.subscribed & deliverable).any()]
            sp.set(zones_collected=len(started))
        return started

    def tick_finish(self, started: list) -> list:
        """Frame issued collects into packets (host transfers + seq/
        in-flight bookkeeping), in issue order — byte-identical to the
        sequential path."""
        with obs_span("fleet.tick_finish", cat="sync"):
            out = [(z, self.sessions[z].collect_finish(p))
                   for z, p in started]
        self._tick_metrics(out)
        return out

    def _tick_metrics(self, out: list) -> None:
        reg = obs_metrics.get_registry()
        if reg is not None and out:
            cnt = reg.counter("fleet_sent_bytes_total",
                              "downstream wire bytes by client/zone")
            for z, pkt in out:
                for c in np.nonzero(pkt.nbytes)[0]:
                    cnt.inc(int(pkt.nbytes[c]), client=int(c), zone=int(z))

    def per_client_nbytes(self, packets: list) -> np.ndarray:
        total = np.zeros((self.n_clients,), np.int64)
        for _, pkt in packets:
            total += pkt.nbytes
        return total

    # -- query plane ---------------------------------------------------------
    def query(self, spec: Query, *, use_pallas: bool = False) -> QueryResult:
        """Run a declarative query against the zone-sharded fleet store.

        ``compile_query`` prunes shards from the spec's zone / near
        predicates before dispatch; each selected shard runs the same
        predicate+score+top-k plan (one ``query_topk_bias`` call when flat)
        — coarse-to-fine through its cluster index once the shard passes
        the engagement threshold (two calls).  Result slots are global
        ``zone * zone_capacity + shard_slot`` rows.  ``use_pallas`` is
        accepted for the reference's signature and ignored."""
        return compile_query(spec, self.zoned,
                             use_pallas=use_pallas)(self.zoned)


# ---------------------------------------------------------------------------
@dataclass
class SimClient:
    cid: int
    session: ClientSession             # the engine-owned per-tick step
    anchor: np.ndarray                 # wander center
    radius: float                      # zone-subscription radius
    join_tick: int = 0
    leave_tick: int = 10**9
    active: bool = False
    queries: int = 0
    lq_ticks: int = 0
    net: NetworkModel = None

    def pose_at(self, t: float) -> np.ndarray:
        ang = 0.15 * t + 0.7 * self.cid
        return self.anchor + np.array([0.8 * np.cos(ang), 0.0,
                                       0.8 * np.sin(ang)], np.float32)


def _heterogeneous_net(rng, tick_s: float, n_ticks: int) -> NetworkModel:
    """Mixed-quality links (paper Sec. 4.3 regimes) + staggered outages."""
    rtt = float(rng.choice([20.0, 40.0, 66.0]))
    bw = float(rng.choice([50.0, 100.0, 200.0]))
    outages = ()
    if rng.random() < 0.5:
        start = float(rng.uniform(0, n_ticks * tick_s * 0.8))
        outages = ((start, start + float(rng.uniform(1, 4) * tick_s)),)
    return NetworkModel(rtt_ms=rtt, bandwidth_mbps=bw, outages=outages)


@dataclass
class FleetSimulator:
    """Drive C simulated clients against one mapped scene for N ticks."""
    knobs: Knobs
    embed_dim: int
    n_clients: int = 16
    grid: ZoneGrid = None
    budget: int = 32
    seed: int = 0
    tick_s: float = 1.0
    churn: float = 0.25                # fraction of clients that join late
    query_prob: float = 0.5
    query_radius: float = 6.0          # SQ spatial predicate around the pose
    device: str | torch.device = "cuda"
    server: FleetServer = None
    clients: list = field(default_factory=list)
    scheduler: object = None
    stats: dict = field(default_factory=dict)
    log: object = None                 # the last run's sim.MetricsLog

    def __post_init__(self):
        if self.grid is None:
            self.grid = ZoneGrid.for_room(8.0, nx=2, nz=2)
        if self.server is None:
            self.server = FleetServer(knobs=self.knobs,
                                      embed_dim=self.embed_dim,
                                      n_clients=self.n_clients,
                                      grid=self.grid, budget=self.budget,
                                      device=self.device)
        self.device = self.server.device

    def _build_clients(self, n_ticks: int):
        rng = np.random.default_rng(self.seed)
        half = self.grid.zone_size * max(self.grid.nx, self.grid.nz) / 2
        self.clients = []
        for c in range(self.n_clients):
            net = _heterogeneous_net(rng, self.tick_s, n_ticks)
            anchor = np.array([rng.uniform(-half * 0.8, half * 0.8), 1.5,
                               rng.uniform(-half * 0.8, half * 0.8)],
                              np.float32)
            join = 0
            leave = 10**9
            if rng.random() < self.churn:
                join = int(rng.integers(1, max(n_ticks // 2, 2)))
            if rng.random() < self.churn / 2:
                leave = int(rng.integers(n_ticks // 2, n_ticks))
            # session is attached after the engine builds it (the engine
            # owns DeviceClient/ClientSession; SimClient is the public view)
            self.clients.append(SimClient(
                cid=c, session=None, anchor=anchor, radius=1.5,
                join_tick=join, leave_tick=leave, net=net))

    def _build_scheduler(self, get_map):
        from repro_torch.serving.batching import (BatchScheduler,
                                                  make_query_step_fn)
        bs = max(4, min(self.n_clients, 16))
        return BatchScheduler(batch_size=bs,
                              step_fn=make_query_step_fn(get_map, pad_to=bs))

    def _scenario(self, n_ticks: int):
        """Declarative Scenario mirroring this simulator's seeded fleet —
        the engine replays it; the simulator itself only maps results back
        to the stats dict."""
        from repro_torch.sim.scenario import (ClientSpec, GridSpec, NetTrace,
                                              PoseTrack, QueryPlan, Scenario)
        specs = tuple(ClientSpec(
            cid=cl.cid,
            net=NetTrace(rtt_ms=cl.net.rtt_ms,
                         bandwidth_mbps=cl.net.bandwidth_mbps,
                         outages=cl.net.outages),
            track=PoseTrack(anchor=tuple(float(x) for x in cl.anchor),
                            orbit_radius=0.8, angular_rate=0.15,
                            phase=0.7 * cl.cid),
            join_tick=cl.join_tick, leave_tick=cl.leave_tick,
            subscribe_radius=cl.radius) for cl in self.clients)
        room = self.grid.zone_size * max(self.grid.nx, self.grid.nz)
        return Scenario(
            seed=self.seed, n_ticks=n_ticks, tick_s=self.tick_s,
            embed_dim=self.embed_dim, knobs=self.knobs,
            grid=GridSpec(room=room, nx=self.grid.nx, nz=self.grid.nz),
            budget=self.budget, clients=specs,
            query=QueryPlan(prob=self.query_prob, radius=self.query_radius,
                            k=3))

    def run(self, *, n_ticks: int = 30, mapper=None, frames=None,
            embedder=None, classes=None, noise=None) -> dict:
        """Run the fleet: a thin wrapper over sim.ScenarioEngine.

        ``mapper`` + ``frames`` drive the mapping frontend (``noise`` is
        the engine's per-tick noise hook, see ``ScenarioEngine``); SQ
        queries ride ``serving.BatchScheduler`` via the engine's query hook,
        so the scheduler stats (hedges/served) stay observable.
        ``tick_ms_mean`` and ``hedges`` are wall-clock measurements."""
        from repro_torch.sim.engine import ScenarioEngine
        self._build_clients(n_ticks)
        self.scheduler = self._build_scheduler(
            lambda: mapper.store if mapper else None)
        hedges0 = self.scheduler.hedge_count

        def submit_sq(cid, t, spec):
            self.scheduler.submit(spec)

        engine = ScenarioEngine(
            self._scenario(n_ticks), mapper=mapper,
            frames=list(frames) if frames is not None else None,
            classes=classes, embedder=embedder, server=self.server,
            noise=noise, device=self.device,
            query_hook=submit_sq if mapper is not None else None,
            tick_hook=(lambda t: self.scheduler.step())
            if mapper is not None else None)
        for cl in self.clients:            # expose engine-owned sessions
            cl.session = engine.sessions[cl.cid]
        self.log = log = engine.run()

        if mapper is not None:
            self.scheduler.drain()      # serve every remaining submission
        sq = log.queried * (log.mode_sq == 1)
        lq = log.queried * (log.mode_sq == 0)
        for cl in self.clients:
            cl.active = bool(log.client_active[-1, cl.cid])
            cl.queries = int(sq[:, cl.cid].sum())
            cl.lq_ticks = int(lq[:, cl.cid].sum())
        self.stats = {
            "n_ticks": n_ticks,
            "n_clients": self.n_clients,
            "active_at_end": int(log.client_active[-1].sum()),
            "tick_ms_mean": float(np.mean(engine.wall_ms))
            if engine.wall_ms else 0.0,
            "down_bytes_total": int(log.sent_bytes.sum()),
            "down_bytes_per_client": int(log.sent_bytes.sum())
            / max(self.n_clients, 1),
            "delivered_packets": int(log.delivered.sum()),
            "delayed_packets": int(log.delayed.sum()),
            "sq_queries": int(sq.sum()),
            "lq_fallbacks": int(lq.sum()),
            "hedges": self.scheduler.hedge_count - hedges0,
            "served": len(self.scheduler.done),
            "unserved": len(self.scheduler.waiting),
            "dropped_by_full_zone": self.server.zoned.dropped,
        }
        return self.stats
