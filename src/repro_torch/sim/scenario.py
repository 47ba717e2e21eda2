"""Declarative scenario specs (port of ``repro.sim.scenario``, pure numpy:
the same seed draws the same events): everything a dynamic-scene session
needs, as plain seeded data — no callables, no hidden state — so a
scenario can be replayed bit-identically, committed as a golden workload,
or generated randomly under hypothesis.

A ``Scenario`` bundles:
  * object lifecycle events   spawn / move / remove per tick (ObjectEvent)
  * user trajectories         parametric orbit tracks per client (PoseTrack)
  * network traces            RTT / bandwidth / outage windows (NetTrace)
  * fleet churn               join/leave ticks per client (ClientSpec)
  * knob schedule             per-client min-obs / radius changes (KnobEvent)
  * query plan                seeded per-tick query probability (QueryPlan)

``churn_scenario`` is the canonical generator: a seeded dynamic scene with
spawns, motion, and >= ``remove_frac`` of objects tombstoned mid-run — the
workload behind the golden-replay test, the property suite, and
benchmarks/scenario_suite.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.knobs import Knobs


@dataclass(frozen=True)
class NetTrace:
    """One client's link: fixed RTT/bandwidth + scheduled outage windows."""
    rtt_ms: float = 20.0
    bandwidth_mbps: float = 200.0
    outages: tuple = ()           # ((t_start, t_end) seconds, ...)


@dataclass(frozen=True)
class PoseTrack:
    """Parametric user trajectory: an orbit around an anchor (declarative
    stand-in for a head-pose trace; zone subscriptions follow it)."""
    anchor: tuple = (0.0, 1.5, 0.0)
    orbit_radius: float = 0.8
    angular_rate: float = 0.15    # rad / s
    phase: float = 0.0

    def pose_at(self, t: float) -> np.ndarray:
        ang = self.angular_rate * t + self.phase
        return np.asarray(self.anchor, np.float32) + np.array(
            [self.orbit_radius * np.cos(ang), 0.0,
             self.orbit_radius * np.sin(ang)], np.float32)


@dataclass(frozen=True)
class ClientSpec:
    cid: int
    net: NetTrace = NetTrace()
    track: PoseTrack = PoseTrack()
    join_tick: int = 0
    leave_tick: int = 10**9
    subscribe_radius: float = 1.5


@dataclass(frozen=True)
class ObjectEvent:
    """One object lifecycle event, applied at the START of ``tick``.

    kind='spawn'   place object ``oid`` of ``class_id`` at ``pos`` with
                   ``n_points`` points
    kind='move'    translate object ``oid`` by ``delta`` (version bump)
    kind='remove'  tombstone object ``oid`` (server prune -> version-bumped
                   tombstone row -> client slot freed on delivery)
    """
    tick: int
    kind: str                     # 'spawn' | 'move' | 'remove'
    oid: int
    class_id: int = 0
    pos: tuple = (0.0, 1.0, 0.0)
    n_points: int = 64
    delta: tuple = (0.0, 0.0, 0.0)


@dataclass(frozen=True)
class KnobEvent:
    """Knob-schedule entry, applied at the start of ``tick`` (control
    plane: per-client transient filter / subscription radius)."""
    tick: int
    cid: int | None = None        # None = every client
    min_obs: int | None = None
    subscribe_radius: float | None = None


@dataclass(frozen=True)
class CrashEvent:
    """Client crash/restart: at the start of ``tick`` client ``cid`` loses
    all volatile state (local map, in-flight packets, protocol position)
    and stays down for ``down_ticks`` ticks, then rejoins — the server
    hands it a fresh sync epoch and a full catch-up instead of silently
    replaying stale per-client sync state."""
    tick: int
    cid: int
    down_ticks: int = 2


@dataclass(frozen=True)
class QueryPlan:
    """Seeded per-tick query schedule: each active client queries with
    probability ``prob`` for a uniformly drawn live class; SQ specs carry a
    radius-around-pose spatial predicate."""
    prob: float = 0.5
    radius: float = 6.0
    k: int = 3


@dataclass(frozen=True)
class GridSpec:
    """Zone-grid shape (declarative mirror of zones.ZoneGrid.for_room)."""
    room: float = 8.0
    nx: int = 1
    nz: int = 1


@dataclass(frozen=True)
class Scenario:
    seed: int = 0
    n_ticks: int = 20
    tick_s: float = 1.0
    embed_dim: int = 32
    knobs: Knobs = None
    grid: GridSpec = GridSpec()
    budget: int = 32              # per-client objects shipped per tick/zone
    clients: tuple = ()           # ClientSpec, ...
    events: tuple = ()            # ObjectEvent, ...  (sorted by tick)
    knob_events: tuple = ()       # KnobEvent, ...
    query: QueryPlan = QueryPlan()
    drain_ticks: int = 0          # extra event-free ticks appended at the
    #                               end with every link up (packets drain)
    tombstone_ttl: int | None = None   # release tombstones this many ticks
    #                               after removal (None = never in-run)
    faults: object = None         # core.runtime.FaultModel — seeded packet
    #                               loss/dup/reorder/corruption (None =
    #                               clean legacy transport)
    crash_events: tuple = ()      # CrashEvent, ... — client crash/restart
    lease_ticks: int | None = None     # tombstone-retirement lease: a
    #                               partitioned client that owes deletion
    #                               acks forfeits its hold after this many
    #                               ack-free ticks (fresh epoch on return)

    def client(self, cid: int) -> ClientSpec:
        for c in self.clients:
            if c.cid == cid:
                return c
        raise KeyError(cid)

    @property
    def total_ticks(self) -> int:
        return self.n_ticks + self.drain_ticks


# ---------------------------------------------------------------------------
def churn_scenario(*, seed: int = 0, n_objects: int = 24, n_ticks: int = 24,
                   n_clients: int = 3, remove_frac: float = 0.25,
                   move_frac: float = 0.25, spawn_late: int = 4,
                   outage_frac: float = 0.5, drain_ticks: int = 6,
                   knobs: Knobs | None = None, embed_dim: int = 32,
                   grid: GridSpec = GridSpec(), n_labels: int = 12,
                   query_prob: float = 0.5,
                   tombstone_ttl: int | None = None,
                   faults: object = None, crash_events: tuple = (),
                   lease_ticks: int | None = None) -> Scenario:
    """The canonical dynamic-scene workload, fully determined by ``seed``.

    * ``n_objects`` spawn up front (tick 0) plus ``spawn_late`` more spread
      over the first half of the run;
    * ``move_frac`` of objects get one translation event mid-run;
    * >= ``remove_frac`` of all spawned objects are tombstoned mid-run
      (between 1/3 and 2/3 of the way through);
    * each client gets a heterogeneous link (mixed RTT/bw tiers,
      ``outage_frac`` chance of one mid-run outage) and a join tick that
      staggers the fleet; ``drain_ticks`` outage-free ticks close the run
      so every packet lands.
    """
    rng = np.random.default_rng(seed)
    kn = knobs or Knobs(server_capacity=128, client_capacity=64,
                        max_object_points_server=64,
                        max_object_points_client=16, min_obs_before_sync=1)
    half = grid.room / 2
    events = []
    oids = list(range(1, n_objects + spawn_late + 1))
    for i, oid in enumerate(oids):
        tick = 0 if i < n_objects else int(rng.integers(1, max(n_ticks // 2,
                                                               2)))
        events.append(ObjectEvent(
            tick=tick, kind="spawn", oid=oid,
            class_id=int(rng.integers(0, n_labels)),
            pos=tuple(float(x) for x in
                      (rng.uniform(-half * 0.9, half * 0.9),
                       rng.uniform(0.2, 2.0),
                       rng.uniform(-half * 0.9, half * 0.9))),
            n_points=int(rng.integers(8, kn.max_object_points_server))))
    n_move = int(round(move_frac * len(oids)))
    for oid in rng.choice(oids, size=n_move, replace=False):
        events.append(ObjectEvent(
            tick=int(rng.integers(max(n_ticks // 4, 1),
                                  max(3 * n_ticks // 4, 2))),
            kind="move", oid=int(oid),
            delta=tuple(float(x) for x in rng.uniform(-0.6, 0.6, 3))))
    n_remove = max(1, int(round(remove_frac * len(oids))))
    removed = rng.choice(oids, size=n_remove, replace=False)
    for oid in removed:
        events.append(ObjectEvent(
            tick=int(rng.integers(max(n_ticks // 3, 1),
                                  max(2 * n_ticks // 3, 2))),
            kind="remove", oid=int(oid)))
    events.sort(key=lambda e: (e.tick, e.kind, e.oid))

    clients = []
    horizon = n_ticks  # outages end before the drain phase
    for c in range(n_clients):
        outages = ()
        if rng.random() < outage_frac:
            start = float(rng.uniform(1, horizon * 0.7))
            outages = ((start, min(start + float(rng.uniform(2, 5)),
                                   float(horizon))),)
        clients.append(ClientSpec(
            cid=c,
            net=NetTrace(rtt_ms=float(rng.choice([20.0, 40.0, 66.0])),
                         bandwidth_mbps=float(rng.choice([50.0, 100.0,
                                                          200.0])),
                         outages=outages),
            track=PoseTrack(anchor=(float(rng.uniform(-half * 0.6,
                                                      half * 0.6)), 1.5,
                                    float(rng.uniform(-half * 0.6,
                                                      half * 0.6))),
                            phase=0.7 * c),
            join_tick=0 if c == 0 else int(rng.integers(0, max(n_ticks // 3,
                                                               1) + 1)),
            subscribe_radius=max(grid.room, 2.0) if grid.nx * grid.nz == 1
            else 1.5))
    return Scenario(seed=seed, n_ticks=n_ticks, embed_dim=embed_dim,
                    knobs=kn, grid=grid, clients=tuple(clients),
                    events=tuple(events), query=QueryPlan(prob=query_prob),
                    drain_ticks=drain_ticks, tombstone_ttl=tombstone_ttl,
                    faults=faults, crash_events=tuple(crash_events),
                    lease_ticks=lease_ticks)
