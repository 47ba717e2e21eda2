"""The discrete-event session loop: one engine for every scenario.

Port of ``repro.sim.engine``.  Per tick it applies the scenario's knob +
object events to the world (or steps a mapping frontend over rendered
frames), mirrors the store into the zone-sharded fleet server, advances
client churn/poses, runs one batched fleet collect per dirty zone, delivers
packets through the outage-aware ``ClientSession`` step, executes the seeded
query plan (SQ/LQ mode switching on observed latency), and logs everything
into a structured ``MetricsLog``.

Determinism is the contract: the loop draws no unseeded randomness and no
wall clock enters the log, so the same Scenario replays to a bit-identical
MetricsLog — on the card, on the CPU, and equal to the reference's.
Latency and power are MODELs (NetworkModel transfer times, PowerModel
coefficients, the LQ latency curve below), never measurements.

The mapper path's per-view embedder noise is the one input the reference
draws with JAX (``fold_in(key(seed), tick)``).  ``ScenarioEngine(noise=)``
takes a callable from tick to a ``[D, E]`` tensor or a ``torch.Generator``;
by default each tick gets a CPU generator seeded from ``(seed, tick)``, so
the card and the CPU port draw the same noise.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.local_map import local_map_nbytes
from repro_torch.core.query import Query
from repro_torch.core.runtime import (ClientSession, DeviceClient,
                                      NetworkModel, PowerModel)
from repro_torch.core.store import deleted_mask, remove_objects
from repro_torch.core.updates import TOMBSTONE_NBYTES
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import span as obs_span
from repro_torch.server.fleet import FleetServer
from repro_torch.server.zones import ZoneGrid
from repro_torch.sim.scenario import Scenario
from repro_torch.sim.world import WorldState

# modeled on-device query cost (ms): the fallback when no LQ curve is on
# disk (see lq_model_ms)
LQ_MODEL_MS = 3.5
_LQ_CURVE_PATH = (Path(__file__).resolve().parents[3]
                  / "BENCH_query_engine.json")
# SQ wire model: fp16 query embedding up, k result rows (id+score+slot) down
_SQ_ROW_B = 16


def load_lq_curve(path=None):
    """(sizes [K], full_mix ms [K]) from the committed
    BENCH_query_engine.json at the repository root, or None when the file
    is missing/unparseable (callers fall back to ``LQ_MODEL_MS``).

    The file is the reference's modeled LQ latency curve: the JAX query
    engine's full_mix times in a CPU container.  Here it is only a model
    coefficient, read so that the port's MetricsLog equals the reference's;
    it is not a time of the card."""
    try:
        data = json.loads(Path(path or _LQ_CURVE_PATH).read_text())
    except (OSError, ValueError):
        return None
    pts = sorted((int(k), float(v["full_mix"])) for k, v in data.items()
                 if isinstance(v, dict) and str(k).isdigit()
                 and "full_mix" in v)
    if not pts:
        return None
    return (np.asarray([p[0] for p in pts], np.float64),
            np.asarray([p[1] for p in pts], np.float64))


def lq_model_ms(n_objects: int, curve=None) -> float:
    """Modeled on-device (LQ) query latency at the client's actual map
    size: log-size linear interpolation over the curve, clamped to its
    range.  A pure function of (curve file, object count), so replays stay
    bit-deterministic; no curve -> the ``LQ_MODEL_MS`` constant."""
    if curve is None:
        return LQ_MODEL_MS
    ns, ms = curve
    n = min(max(float(max(n_objects, 1)), float(ns[0])), float(ns[-1]))
    return float(np.interp(np.log(n), np.log(ns), ms))


def tick_seed(seed: int, tick: int) -> int:
    """The default per-tick noise seed of a mapper-backed run."""
    return int(np.random.SeedSequence((seed, tick)).generate_state(1)[0])


@dataclass
class MetricsLog:
    """Per-tick structured metrics, all [T] or [T, C] numpy arrays.

    Every field is reproducible bit-for-bit from the Scenario alone —
    ``equals`` is exact array equality (NaN-aware), which is what the
    golden-replay test asserts.  ``summary`` splits exact counters/byte
    totals from MODELed float metrics so a committed snapshot can hold the
    former to the digit and the latter to a tolerance.
    """
    tick: np.ndarray            # [T] int32
    events: np.ndarray          # [T, 3] int32 — spawned, moved, removed
    gc_released: np.ndarray     # [T] int32 tombstone slots retired
    server_live: np.ndarray     # [T] int32
    server_tombstones: np.ndarray   # [T] int32
    sent_bytes: np.ndarray      # [T, C] int64 — wire bytes sent this tick
    sent_tomb_bytes: np.ndarray  # [T, C] int64 — the tombstone-row share
    recv_bytes: np.ndarray      # [T, C] int64 — bytes ingested this tick
    delivered: np.ndarray       # [T, C] int32 — packets ingested this tick
    delayed: np.ndarray         # [T, C] int32 — packets delayed this tick
    client_active: np.ndarray   # [T, C] bool — joined and not left
    client_live: np.ndarray     # [T, C] int32 — local-map live objects
    client_nbytes: np.ndarray   # [T, C] int64 — local-map bytes (fixed cap)
    mode_sq: np.ndarray         # [T, C] int8 — 1 SQ, 0 LQ, -1 inactive
    queried: np.ndarray         # [T, C] int8 — 1 if a query ran this tick
    query_hit: np.ndarray       # [T, C] int8 — top-1 label correct
    #                             (1/0, -1 = no query or no ground truth)
    query_ms: np.ndarray        # [T, C] f64 MODELed latency (NaN = none)
    power_w: np.ndarray         # [T, C] f64 MODELed device power
    up_bytes: np.ndarray        # [T, C] int64 — upstream control bytes
    faults: np.ndarray          # [T, C, 4] int32 — packets lost, duplicate
    #                             drops, corrupt drops, resync requests
    wall_ms: list = None        # [T] measured tick wall time — NOT part of
    #                             the determinism contract: excluded from
    #                             _FIELDS/equals, surfaced only in the
    #                             summary's ``wall`` section

    _FIELDS = ("tick", "events", "gc_released", "server_live",
               "server_tombstones", "sent_bytes", "sent_tomb_bytes",
               "recv_bytes", "delivered", "delayed", "client_active",
               "client_live", "client_nbytes", "mode_sq", "queried",
               "query_hit", "query_ms", "power_w", "up_bytes", "faults")

    @property
    def n_ticks(self) -> int:
        return len(self.tick)

    @property
    def n_clients(self) -> int:
        return self.sent_bytes.shape[1]

    def equals(self, other) -> bool:
        """Bit-exact equality (the golden-replay invariant); ``other`` may
        be the reference's MetricsLog."""
        return all(np.array_equal(getattr(self, f), getattr(other, f),
                                  equal_nan=True) for f in self._FIELDS)

    def diff(self, other) -> list:
        return [f for f in self._FIELDS
                if not np.array_equal(getattr(self, f), getattr(other, f),
                                      equal_nan=True)]

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        """JSON-able snapshot: ``exact`` (counts + byte totals, compared to
        the digit) and ``approx`` (MODELed latency/power, compared within
        tolerance)."""
        sq = self.queried * (self.mode_sq == 1)
        lq = self.queried * (self.mode_sq == 0)
        q_ms = self.query_ms[~np.isnan(self.query_ms)]
        exact = {
            "n_ticks": int(self.n_ticks),
            "n_clients": int(self.n_clients),
            "spawned": int(self.events[:, 0].sum()),
            "moved": int(self.events[:, 1].sum()),
            "removed": int(self.events[:, 2].sum()),
            "gc_released": int(self.gc_released.sum()),
            "server_live_final": int(self.server_live[-1]),
            "server_tombstones_final": int(self.server_tombstones[-1]),
            "sent_bytes_total": int(self.sent_bytes.sum()),
            "sent_bytes_per_client": [int(x) for x in
                                      self.sent_bytes.sum(axis=0)],
            "tombstone_bytes_total": int(self.sent_tomb_bytes.sum()),
            "recv_bytes_total": int(self.recv_bytes.sum()),
            "delivered_total": int(self.delivered.sum()),
            "delayed_total": int(self.delayed.sum()),
            "client_live_final": [int(x) for x in self.client_live[-1]],
            "sq_queries": int(sq.sum()),
            "lq_queries": int(lq.sum()),
            "query_hits": int((self.query_hit == 1).sum()),
            "idle_zero_byte_ticks": int((self.sent_bytes.sum(axis=1)
                                         == 0).sum()),
            "up_bytes_total": int(self.up_bytes.sum()),
            "packets_lost": int(self.faults[:, :, 0].sum()),
            "dup_drops": int(self.faults[:, :, 1].sum()),
            "corrupt_drops": int(self.faults[:, :, 2].sum()),
            "resync_requests": int(self.faults[:, :, 3].sum()),
        }
        approx = {
            "query_ms_mean": float(q_ms.mean()) if len(q_ms) else 0.0,
            "query_ms_max": float(q_ms.max()) if len(q_ms) else 0.0,
            "power_w_mean": float(self.power_w.mean()),
        }
        out = {"exact": exact, "approx": approx}
        if self.wall_ms:
            # measured wall clock: informational only, never part of the
            # golden compare (assert_matches_snapshot reads exact/approx)
            out["wall"] = obs_metrics.exact_percentiles(self.wall_ms)
        return out

    def assert_matches_snapshot(self, snapshot: dict,
                                rel_tol: float = 0.25) -> None:
        """Compare against a committed ``summary()`` dict: exact fields to
        the digit, approx fields within ``rel_tol`` relative tolerance."""
        got = self.summary()
        for k, want in snapshot["exact"].items():
            assert got["exact"][k] == want, \
                f"snapshot drift: {k}: got {got['exact'][k]}, want {want}"
        for k, want in snapshot["approx"].items():
            g = got["approx"][k]
            assert abs(g - want) <= rel_tol * max(abs(want), 1e-9), \
                f"snapshot drift: {k}: got {g}, want {want} ±{rel_tol:.0%}"


# ---------------------------------------------------------------------------
@dataclass
class ScenarioEngine:
    """Run a Scenario through the full device-cloud loop.

    ``mapper``/``frames``/``classes`` switch the map source from the
    event-driven WorldState to a real mapping frontend (its device is the
    caller's to choose).  With ``scene`` set, object events mutate the
    Scene and the tick's frame is RE-RENDERED from the changed geometry
    before the mapper sees it; 'remove' also tombstones the mapper's store
    directly.  ``noise(tick)`` gives the mapper's per-view noise, a
    ``[D, E]`` tensor or a ``torch.Generator`` (default: a CPU generator
    seeded from ``tick_seed(seed, tick)``).
    ``query_hook(cid, t, spec)`` externalizes SQ execution (the
    FleetSimulator routes through serving.BatchScheduler); ``tick_hook(t)``
    runs after every tick (scheduler pumping).
    """
    scenario: Scenario
    mapper: object = None
    frames: list = None
    scene: object = None               # data.scenes.Scene behind ``frames``
    #                                    (enables dynamic-scene re-render)
    classes: dict = None
    embedder: object = None            # query-side embeddings (mapper path)
    query_hook: object = None
    tick_hook: object = None
    noise: object = None               # tick -> [D, E] tensor | Generator
    async_loop: bool = False           # overlapped server tick: issue every
    #                                    dirty zone's collect before any
    #                                    packet materializes; replay stays
    #                                    bit-identical (asserted in tests)
    power: PowerModel = field(default_factory=PowerModel)
    device: str | torch.device = "cuda"
    # built state (exposed for wrappers/tests)
    server: FleetServer = None
    world: WorldState = None
    sessions: dict = None              # cid -> ClientSession
    joined: dict = None                # cid -> bool

    def __post_init__(self):
        sc = self.scenario
        assert sc.knobs is not None, "Scenario.knobs must be set"
        cids = [c.cid for c in sc.clients]
        assert cids == list(range(len(cids))), \
            "ClientSpec.cid must be 0..C-1 (FleetServer indexing)"
        self.device = resolve_device(self.device)
        # hardened mode: fault-injection transport + protocol framing bytes
        self._hardened = sc.faults is not None or bool(sc.crash_events)
        grid = ZoneGrid.for_room(sc.grid.room, sc.grid.nx, sc.grid.nz)
        if self.server is None:
            self.server = FleetServer(knobs=sc.knobs,
                                      embed_dim=sc.embed_dim,
                                      n_clients=len(sc.clients), grid=grid,
                                      budget=sc.budget,
                                      proto=self._hardened,
                                      device=self.device)
        if self.mapper is None and self.world is None:
            self.world = WorldState(knobs=sc.knobs, embed_dim=sc.embed_dim,
                                    seed=sc.seed, device=self.device)
        self.sessions = {
            c.cid: ClientSession(
                dev=DeviceClient(knobs=sc.knobs, embed_dim=sc.embed_dim,
                                 device=self.device),
                net=NetworkModel(rtt_ms=c.net.rtt_ms,
                                 bandwidth_mbps=c.net.bandwidth_mbps,
                                 outages=c.net.outages),
                knobs=sc.knobs, dt=sc.tick_s, cid=c.cid, faults=sc.faults)
            for c in sc.clients}
        self.joined = {c.cid: False for c in sc.clients}
        self._radius = {c.cid: c.subscribe_radius for c in sc.clients}
        self._events = defaultdict(list)
        for ev in sc.events:
            self._events[ev.tick].append(ev)
        self._knob_events = defaultdict(list)
        for ev in sc.knob_events:
            self._knob_events[ev.tick].append(ev)
        self._crashes = defaultdict(list)
        for ev in sc.crash_events:
            self._crashes[ev.tick].append(ev)
        self._crashed_until = {}           # cid -> first tick back up
        self._scene_dirty = False          # a scene event happened: frames
        #                                    rendered before it are stale —
        #                                    re-render each tick's frame at
        #                                    use time (sticky)
        # LQ latency curve (None -> LQ_MODEL_MS fallback); loaded once so
        # every tick interpolates the same committed artifact
        self._lq_curve = load_lq_curve()

    # ------------------------------------------------------------------
    def _store(self):
        return self.mapper.store if self.mapper is not None \
            else self.world.store

    def _query_embed(self, class_id: int):
        if self.world is not None:
            return self.world.embedder.embed_text(class_id, self.device)
        if self.embedder is not None:
            return self.embedder.embed_text(class_id, self.device)
        return None

    def _live_classes(self) -> np.ndarray:
        if self.world is not None:
            return self.world.live_classes()
        st = self.mapper.store
        return np.unique(st.label.cpu().numpy()[st.active.cpu().numpy()])

    def _noise(self, i: int):
        if self.noise is not None:
            return self.noise(i)
        return torch.Generator().manual_seed(
            tick_seed(self.scenario.seed, i))

    def _apply_events(self, i: int) -> tuple:
        spawned = moved = removed = 0
        for ev in self._events.get(i, ()):
            if self.mapper is not None:
                s, m = self._apply_scene_event(ev)
                spawned += s
                moved += m
                if ev.kind == "remove":
                    before = int(deleted_mask(self.mapper.store).sum())
                    self.mapper.store = remove_objects(self.mapper.store,
                                                       [ev.oid])
                    removed += int(deleted_mask(self.mapper.store).sum()) \
                        - before
                continue
            before = (self.world.spawned, self.world.moved,
                      self.world.removed)
            self.world.apply(ev, tick=i)
            spawned += self.world.spawned - before[0]
            moved += self.world.moved - before[1]
            removed += self.world.removed - before[2]
        return spawned, moved, removed

    def _apply_scene_event(self, ev) -> tuple:
        """Mutate the mapper-backed Scene for one object event so the
        tick's RE-RENDERED frame shows it (see ``scene``).  Returns
        (spawned, moved) deltas; 'remove' geometry is dropped here but
        counted by the store-tombstone path in ``_apply_events``.
        Deterministic: spawn geometry is seeded by (scene seed, oid),
        mirroring WorldState.spawn."""
        if self.scene is None:
            return 0, 0
        from repro_torch.data.scenes import SceneObject, _object_cloud
        objs = self.scene.objects
        if ev.kind == "spawn":
            if any(o.oid == ev.oid for o in objs):
                return 0, 0
            rng = np.random.default_rng((self.scene.rng_seed, ev.oid))
            center = np.asarray(ev.pos, np.float32)
            pts = (_object_cloud(rng, ev.class_id % 3, 0.5, ev.n_points)
                   + center).astype(np.float32)
            objs.append(SceneObject(oid=ev.oid, class_id=ev.class_id,
                                    center=center, points=pts))
            if self.classes is not None:
                self.classes[ev.oid] = ev.class_id
            self._scene_dirty = True
            return 1, 0
        if ev.kind == "move":
            for o in objs:
                if o.oid == ev.oid:
                    d = np.asarray(ev.delta, np.float32)
                    o.points = o.points + d
                    o.center = o.center + d
                    self._scene_dirty = True
                    return 0, 1
            return 0, 0
        if ev.kind == "remove":
            keep = [o for o in objs if o.oid != ev.oid]
            if len(keep) != len(objs):
                self.scene.objects = keep
                self._scene_dirty = True
        return 0, 0

    def _apply_knob_events(self, i: int) -> None:
        for ev in self._knob_events.get(i, ()):
            targets = [ev.cid] if ev.cid is not None \
                else [c.cid for c in self.scenario.clients]
            for cid in targets:
                if ev.min_obs is not None:
                    for s in self.server.sessions:
                        s.set_client(cid, min_obs=ev.min_obs)
                if ev.subscribe_radius is not None:
                    self._radius[cid] = ev.subscribe_radius

    # ------------------------------------------------------------------
    def run(self) -> MetricsLog:
        sc = self.scenario
        dev = self.device
        C, T = len(sc.clients), sc.total_ticks
        rec = {f: [] for f in MetricsLog._FIELDS}
        prev_down = np.zeros(C, np.int64)
        prev_delivered = np.zeros(C, np.int32)
        prev_delayed = np.zeros(C, np.int32)
        prev_up = np.zeros(C, np.int64)
        prev_faults = np.zeros((C, 4), np.int32)
        self.wall_ms = []      # measured tick wall time — NOT in MetricsLog

        for i in range(T):
            wall0 = time.perf_counter()
            # manual enter/exit keeps the tick body un-nested; works
            # identically for the no-op span when tracing is off
            tick_span = obs_span("engine.tick", cat="engine", tick=i)
            tick_span.__enter__()
            t = i * sc.tick_s
            if i == sc.n_ticks:
                # drain phase: the chaos is over — clean links so every
                # retransmitted delta can land and the run converges
                for sess in self.sessions.values():
                    sess.faults = None
            self._apply_knob_events(i)
            for ev in self._crashes.get(i, ()):
                # crash: the device loses its volatile state and drops off;
                # it rejoins (fresh epoch, full catch-up) once back up
                self._crashed_until[ev.cid] = i + max(ev.down_ticks, 1)
                if self.joined[ev.cid]:
                    self.joined[ev.cid] = False
                    self.sessions[ev.cid].crash()
                    self.server.crash(ev.cid)
                    self.server.leave(ev.cid)
            with obs_span("engine.apply_events", cat="engine"):
                spawned, moved, removed = self._apply_events(i)
            if self.mapper is not None and self.frames is not None \
                    and i < len(self.frames):
                frame = self.frames[i]
                if self.scene is not None and self._scene_dirty:
                    # dynamic scene: this frame was rendered before the
                    # event — re-splat its viewpoint against the mutated
                    # geometry so the mapper OBSERVES the change
                    from repro_torch.data.scenes import rerender_frame
                    frame = rerender_frame(self.scene, frame)
                    self.frames[i] = frame
                with obs_span("engine.map_frame", cat="ingest"):
                    self.mapper.process_frame(frame, self.classes,
                                              self._noise(i))
            gc_n = 0
            if self.world is not None and sc.tombstone_ttl is not None:
                # sync-vector-driven slot retirement: a tombstone is
                # releasable only once every subscriber's ACKED version
                # covers the deletion (lease-capped for partitioned
                # clients)
                blocked = self.server.blocked_tombstone_oids(
                    tick=i, lease_ticks=sc.lease_ticks)
                gc_n = self.world.gc(tick=i, ttl=sc.tombstone_ttl,
                                     protected=blocked)
            store = self._store()
            with obs_span("engine.refresh", cat="sync"):
                self.server.refresh(store)

            # churn + pose advance + deliverability
            deliverable = np.zeros(C, bool)
            active = np.zeros(C, bool)
            for spec in sc.clients:
                cid, sess = spec.cid, self.sessions[spec.cid]
                in_window = spec.join_tick <= i < spec.leave_tick \
                    and i >= self._crashed_until.get(cid, 0)
                if not self.joined[cid] and in_window:
                    self.joined[cid] = True
                    self.server.join(cid, spec.track.pose_at(t),
                                     self._radius[cid], tick=i)
                elif self.joined[cid] and not in_window:
                    self.joined[cid] = False
                    self.server.leave(cid)
                if self.joined[cid]:
                    pos = spec.track.pose_at(t)
                    sess.user_pos = torch.from_numpy(pos).to(dev)
                    self.server.set_client_pose(cid, pos, self._radius[cid])
                    # zone-crossing mid-flight fix: the device's delivery
                    # gate tracks the NEW subscriptions immediately
                    sess.zone_subs = self.server.subscribed[cid].copy()
                    deliverable[cid] = sess.net.is_up(t)
                    active[cid] = True

            if self._hardened:
                retx = sc.faults.retx_ticks if sc.faults is not None else 3
                self.server.maintain(tick=i, deliverable=deliverable,
                                     retx_ticks=retx)
            packets = self.server.tick(deliverable, tick=i,
                                       overlap=self.async_loop)
            sent = self.server.per_client_nbytes(packets)
            tomb_sent = np.zeros(C, np.int64)
            for _, pkt in packets:
                tomb_sent += pkt.tomb_counts().astype(np.int64) \
                    * TOMBSTONE_NBYTES

            # client step: delivery + ingest + SQ/LQ mode
            mode = np.full(C, -1, np.int8)
            step_span = obs_span("engine.client_step", cat="client")
            step_span.__enter__()
            for spec in sc.clients:
                cid, sess = spec.cid, self.sessions[spec.cid]
                if not active[cid]:
                    continue
                m = None
                for _, pkt in packets:
                    m = sess.step(t, pkt.packet_for(cid))
                if m is None:
                    m = sess.step(t)
                mode[cid] = 1 if m == "SQ" else 0
                # prune-on-unsubscribe: entries in zones the client left
                # are dead state it will never receive tombstones for
                subs = self.server.subscribed[cid]
                if not subs.all():
                    sess.prune_zones(self.server.grid, subs)
            step_span.__exit__(None, None, None)

            # upstream control plane: cumulative acks + resync requests
            ctrl_span = obs_span("engine.control_plane", cat="sync")
            ctrl_span.__enter__()
            for spec in sc.clients:
                cid, sess = spec.cid, self.sessions[spec.cid]
                if not self.joined[cid]:
                    sess.drain_acks(), sess.drain_ctrl()   # gone: discard
                    continue
                if not sess.net.is_up(t):
                    continue            # buffered until the link is back
                for k, (z, ep, seq) in enumerate(sess.drain_acks()):
                    if sess.faults is not None \
                            and sess.faults.uplink_lost(1, cid, i, k, seq):
                        continue
                    self.server.ack(cid, z, ep, seq, tick=i)
                for k, (kind, z) in enumerate(sess.drain_ctrl()):
                    if sess.faults is not None \
                            and sess.faults.uplink_lost(2, cid, i, k, z):
                        continue
                    if kind == "resync":
                        self.server.request_resync(cid)
            ctrl_span.__exit__(None, None, None)

            # seeded query plan
            queried = np.zeros(C, np.int8)
            hit = np.full(C, -1, np.int8)
            q_ms = np.full(C, np.nan)
            classes = self._live_classes()
            query_span = obs_span("engine.queries", cat="query")
            query_span.__enter__()
            for spec in sc.clients:
                cid = spec.cid
                if not active[cid] or not len(classes):
                    continue
                rng = np.random.default_rng(
                    (sc.seed, 131 * i + cid))
                if rng.random() >= sc.query.prob:
                    continue
                target = int(classes[int(rng.integers(len(classes)))])
                emb = self._query_embed(target)
                if emb is None:
                    continue
                sess = self.sessions[cid]
                queried[cid] = 1
                E = sc.embed_dim
                if mode[cid] == 1:       # SQ over the fleet store
                    spec_q = Query(
                        embed=emb,
                        near=(torch.from_numpy(spec.track.pose_at(t)).to(dev),
                              torch.tensor(sc.query.radius,
                                           dtype=torch.float32, device=dev)),
                        k=sc.query.k)
                    q_ms[cid] = sess.net.transfer_ms(
                        2 * E + sc.query.k * _SQ_ROW_B)
                    if self.query_hook is not None:
                        self.query_hook(cid, t, spec_q)
                    else:
                        res = self.server.query(spec_q)
                        hit[cid] = self._score_hit(res, target)
                else:                    # LQ on the device local map
                    res = sess.dev.query_spec(Query(embed=emb,
                                                    k=sc.query.k))
                    q_ms[cid] = lq_model_ms(
                        int(sess.dev.local.active.sum()), self._lq_curve)
                    hit[cid] = self._score_hit(res, target)
            query_span.__exit__(None, None, None)

            # MODELed device power for this tick
            sq_qps = (queried * (mode == 1)) / sc.tick_s
            lq_qps = (queried * (mode == 0)) / sc.tick_s
            power = np.array([
                self.power.average_power(streaming=bool(active[c]),
                                         local_qps=float(lq_qps[c]),
                                         server_qps=float(sq_qps[c]))
                if active[c] else 0.0 for c in range(C)])

            if self.tick_hook is not None:
                self.tick_hook(t)

            # record: one host read for the store's counts, one for every
            # client's live count
            st = self._store()
            counts = torch.stack([st.active.sum(),
                                  deleted_mask(st).sum()]).cpu().numpy()
            locals_ = [self.sessions[c].dev.local for c in range(C)]
            live = torch.stack([m.active.sum() for m in locals_]) \
                .cpu().numpy().astype(np.int32)
            down = np.array([self.sessions[c].down_bytes for c in range(C)],
                            np.int64)
            dlv = np.array([self.sessions[c].delivered for c in range(C)],
                           np.int32)
            dly = np.array([self.sessions[c].delayed for c in range(C)],
                           np.int32)
            rec["tick"].append(i)
            rec["events"].append((spawned, moved, removed))
            rec["gc_released"].append(gc_n)
            rec["server_live"].append(int(counts[0]))
            rec["server_tombstones"].append(int(counts[1]))
            rec["sent_bytes"].append(sent.astype(np.int64))
            rec["sent_tomb_bytes"].append(tomb_sent)
            rec["recv_bytes"].append(down - prev_down)
            rec["delivered"].append(dlv - prev_delivered)
            rec["delayed"].append(dly - prev_delayed)
            prev_down, prev_delivered, prev_delayed = down, dlv, dly
            rec["client_active"].append(active.copy())
            rec["client_live"].append(live)
            rec["client_nbytes"].append(np.array(
                [local_map_nbytes(m) for m in locals_], np.int64))
            rec["mode_sq"].append(mode.copy())
            rec["queried"].append(queried.copy())
            rec["query_hit"].append(hit.copy())
            rec["query_ms"].append(q_ms.copy())
            rec["power_w"].append(power)
            up = np.array([self.sessions[c].up_bytes for c in range(C)],
                          np.int64)
            flt = np.array([[self.sessions[c].lost,
                             self.sessions[c].dup_drops,
                             self.sessions[c].corrupt_drops,
                             self.sessions[c].resyncs]
                            for c in range(C)], np.int32)
            rec["up_bytes"].append(up - prev_up)
            rec["faults"].append(flt - prev_faults)
            prev_up, prev_faults = up, flt
            tick_wall = (time.perf_counter() - wall0) * 1e3
            self.wall_ms.append(tick_wall)
            tick_span.__exit__(None, None, None)
            reg = obs_metrics.get_registry()
            if reg is not None:
                reg.histogram("engine_tick_ms").observe(tick_wall)
                reg.counter("engine_queries_total").inc(int(queried.sum()))

        return MetricsLog(**{f: np.asarray(v) for f, v in rec.items()},
                          wall_ms=self.wall_ms)

    # ------------------------------------------------------------------
    def _score_hit(self, res, target_cls: int) -> int:
        """Top-1 retrieval correctness against world ground truth."""
        if self.world is None:
            return -1
        oid = int(res.oids.reshape(-1)[0])
        if oid == 0:
            return 0
        return int(self.world.labels.get(oid) == target_cls)


def run_scenario(scenario: Scenario, **kw) -> MetricsLog:
    """One-call convenience: build the engine and run it."""
    return ScenarioEngine(scenario, **kw).run()
