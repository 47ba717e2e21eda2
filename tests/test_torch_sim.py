"""The port's scenario engine (``repro_torch.sim``) against the JAX
reference, on the CPU at the reference's own test sizes.

``churn_scenario`` draws the reference's events; ``WorldState`` writes the
reference's store (ints exactly, floats within 1e-6); the golden churn
scenario reproduces ``tests/golden/scenario_churn_v1.json`` and a
MetricsLog that ``equals`` the reference's, in both the sequential and
the overlapped server tick.  Then the port's versions of the reference's
dynamic-scene cases (``tests/test_scenario_engine.py``) and of its
hostile-network cases (``tests/test_fault_tolerance.py``): convergence,
exact tombstone bytes, late joiners, outages, knob schedule and GC, the
chaos arms (each also equal to the reference's MetricsLog), partitions and
leases, crash restart, resync backoff, idempotent and stale deliveries, and
the mesh-sharded session tier.  Last, the exact counters the benchmarks
committed: scenario_suite's ``sent_bytes_total`` and fault_tolerance's
``down_bytes``.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import sim as jsim
from repro.core.knobs import Knobs as JKnobs
from repro.core import runtime as jrt
from repro.sim import world as jworld

from repro_torch.core.knobs import Knobs
from repro_torch.core.local_map import (ObjectUpdate, apply_update,
                                        init_local_map, local_map_nbytes)
from repro_torch.core.runtime import (ClientSession, DeviceClient,
                                      FaultModel, NetworkModel)
from repro_torch.core.store import deleted_mask, init_store
from repro_torch.core.updates import (TOMBSTONE_NBYTES, collect_updates,
                                      init_sync)
from repro_torch.server import FleetServer, ZoneGrid
from repro_torch.sim import (ClientSpec, CrashEvent, KnobEvent, NetTrace,
                             ObjectEvent, PoseTrack, QueryPlan, Scenario,
                             churn_scenario, run_scenario)
from repro_torch.sim.engine import ScenarioEngine
from repro_torch.sim.scenario import GridSpec
from repro_torch.sim.world import WorldState

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "scenario_churn_v1.json"
CPU = dict(device="cpu")
E = 32
# tests/test_scenario_engine.py's knobs
KW_ENGINE = dict(server_capacity=64, client_capacity=32,
                 max_object_points_server=32, max_object_points_client=8,
                 min_obs_before_sync=1)
KN = Knobs(**KW_ENGINE)
# tests/test_fault_tolerance.py's knobs
KW_FT = dict(server_capacity=32, client_capacity=16,
             max_object_points_server=16, max_object_points_client=8,
             min_obs_before_sync=1)
KN_FT = Knobs(**KW_FT)
N_TICKS = 8
DRAIN = 8
GOLDEN_KW = dict(seed=23, n_objects=20, n_ticks=20, n_clients=3,
                 remove_frac=0.25, drain_ticks=8)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _client_ids(session):
    m = session.dev.local
    return set(_np(m.ids)[_np(m.active)].tolist())


def _to_reference(obj):
    """A port scenario dataclass (or tuple of them) as the reference's:
    the same class name in ``repro.sim`` / ``repro.core.runtime``, the
    same field values."""
    if isinstance(obj, tuple):
        return tuple(_to_reference(x) for x in obj)
    if isinstance(obj, Knobs):
        return JKnobs(**dataclasses.asdict(obj))
    if not dataclasses.is_dataclass(obj):
        return obj
    cls = getattr(jsim, type(obj).__name__, None) \
        or getattr(jrt, type(obj).__name__)
    return cls(**{f.name: _to_reference(getattr(obj, f.name))
                  for f in dataclasses.fields(obj)})


# ---------------------------------------------------------------------------
# scenario generation and the world store
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    GOLDEN_KW,
    dict(seed=5, n_objects=40, n_ticks=30, n_clients=6, move_frac=0.5,
         grid=GridSpec(room=12.0, nx=2, nz=2), tombstone_ttl=3),
    dict(seed=29, n_objects=24, n_ticks=24, n_clients=4, drain_ticks=12,
         outage_frac=0.0, query_prob=0.0,
         faults=FaultModel(seed=30, loss_prob=0.05),
         crash_events=(CrashEvent(tick=12, cid=1, down_ticks=2),))],
    ids=["golden", "zoned", "fault_tolerance"])
def test_churn_scenario_draws_the_reference_events(kw):
    got = churn_scenario(**kw)
    want = jsim.churn_scenario(**{k: _to_reference(v)
                                  for k, v in kw.items()})
    assert _to_reference(got) == want


def test_world_state_writes_the_reference_store():
    kn = Knobs(server_capacity=8, client_capacity=8,
               max_object_points_server=16, max_object_points_client=8,
               min_obs_before_sync=2)
    jkn = JKnobs(**dataclasses.asdict(kn))
    events = [ObjectEvent(tick=0, kind="spawn", oid=o, class_id=o % 5,
                          pos=(0.3 * o - 1.0, 1.0, 0.2 * o),
                          n_points=5 + 3 * o) for o in range(1, 7)]
    events += [ObjectEvent(tick=1, kind="move", oid=2,
                           delta=(0.4, -0.1, 0.3)),
               ObjectEvent(tick=1, kind="move", oid=9, delta=(1.0, 0, 0)),
               ObjectEvent(tick=1, kind="spawn", oid=3),       # already live
               ObjectEvent(tick=2, kind="remove", oid=4),
               ObjectEvent(tick=2, kind="remove", oid=4),      # already gone
               ObjectEvent(tick=2, kind="move", oid=2, delta=(0.1, 0, 0)),
               ObjectEvent(tick=3, kind="spawn", oid=20, class_id=7,
                           n_points=40),                    # n past P
               ObjectEvent(tick=3, kind="spawn", oid=21, class_id=8),
               ObjectEvent(tick=3, kind="spawn", oid=22, class_id=9)]  # full
    tw = WorldState(knobs=kn, embed_dim=E, seed=4, **CPU)
    jw = jworld.WorldState(knobs=jkn, embed_dim=E, seed=4)

    def same():
        for f in ("ids", "active", "label", "n_points", "obs_count",
                  "version", "next_id", "deleted"):
            np.testing.assert_array_equal(_np(getattr(tw.store, f)),
                                          np.asarray(getattr(jw.store, f)),
                                          err_msg=f)
        for f in ("embed", "points", "centroid", "bbox_min", "bbox_max"):
            np.testing.assert_allclose(_np(getattr(tw.store, f)),
                                       np.asarray(getattr(jw.store, f)),
                                       rtol=1e-6, atol=1e-6, err_msg=f)
        assert (tw.spawned, tw.moved, tw.removed, tw.labels,
                tw.removed_at) == (jw.spawned, jw.moved, jw.removed,
                                   jw.labels, jw.removed_at)

    for ev in events:
        tw.apply(ev, tick=ev.tick)
        jw.apply(_to_reference(ev), tick=ev.tick)
        same()
    assert tw.gc(tick=3, ttl=2) == 0                        # too young
    assert tw.gc(tick=4, ttl=2, protected={4}) == 0         # ack pending
    assert tw.gc(tick=4, ttl=2) == jw.gc(tick=4, ttl=2) == 1
    same()
    tw.apply(events[-1], tick=4)            # the freed slot takes oid 22
    jw.apply(_to_reference(events[-1]), tick=4)
    same()
    assert tw.live_ids() == jw.live_ids()
    np.testing.assert_array_equal(tw.live_classes(), jw.live_classes())


# ---------------------------------------------------------------------------
# the golden churn scenario
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def golden_reference():
    return jsim.run_scenario(jsim.churn_scenario(**GOLDEN_KW))


@pytest.mark.parametrize("async_loop", [False, True],
                         ids=["sequential", "overlapped"])
def test_golden_snapshot_and_reference_replay(golden_reference, async_loop):
    """Acceptance: the port reproduces the committed snapshot (exact to the
    digit, modeled latency/power within its tolerance) and a MetricsLog
    bit-equal to the reference's, in both server tick schedules."""
    sc = churn_scenario(**GOLDEN_KW)
    n_spawned = sum(1 for e in sc.events if e.kind == "spawn")
    n_removed = sum(1 for e in sc.events if e.kind == "remove")
    assert n_removed / n_spawned >= 0.20
    log = run_scenario(sc, async_loop=async_loop, **CPU)
    log.assert_matches_snapshot(json.loads(GOLDEN.read_text()))
    assert log.equals(golden_reference), log.diff(golden_reference)
    assert log.summary()["approx"] == golden_reference.summary()["approx"]
    assert len(log.wall_ms) == log.n_ticks


def test_golden_replay_bit_identical():
    sc = churn_scenario(**GOLDEN_KW)
    a, b = run_scenario(sc, **CPU), run_scenario(sc, **CPU)
    assert a.equals(b), a.diff(b)


def test_engine_async_loop_replay_bit_identical():
    sc = churn_scenario(seed=11, n_objects=12, n_ticks=12, n_clients=2,
                        remove_frac=0.25, drain_ticks=4)
    a = run_scenario(sc, **CPU)
    b = run_scenario(sc, async_loop=True, **CPU)
    assert a.equals(b), f"drift in fields: {a.diff(b)}"


# ---------------------------------------------------------------------------
# tests/test_scenario_engine.py, through the port
# ---------------------------------------------------------------------------
def test_churn_convergence_and_byte_scaling():
    sc = churn_scenario(**GOLDEN_KW)
    eng = ScenarioEngine(sc, **CPU)
    log = eng.run()

    # 1. convergence: every client == the server's live set, tombstones out
    srv = eng.world.live_ids()
    assert len(srv) == int(log.server_live[-1])
    removed_oids = {e.oid for e in sc.events if e.kind == "remove"}
    for cid in range(len(sc.clients)):
        assert _client_ids(eng.sessions[cid]) == srv, f"client {cid}"
        assert not (_client_ids(eng.sessions[cid]) & removed_oids)

    # 2. the drain tail is quiescent: zero bytes once everything shipped
    assert (log.sent_bytes[-3:] == 0).all()
    assert log.n_ticks - int((log.sent_bytes.sum(axis=1) > 0).sum()) \
        == log.summary()["exact"]["idle_zero_byte_ticks"]

    # 3. downstream tracks churn: every nonzero tick has an event (or a
    # packet in flight from one) within the catch-up window
    event_ticks = {e.tick for e in sc.events} | {0}
    busy = np.nonzero(log.sent_bytes.sum(axis=1))[0]
    for t in busy:
        assert any(t - 6 <= et <= t for et in event_ticks), t


def test_removal_only_tick_ships_exactly_tombstone_bytes():
    events = [ObjectEvent(tick=0, kind="spawn", oid=i, class_id=i % 4,
                          pos=(0.5 * i - 2.0, 1.0, 0.0), n_points=16)
              for i in range(1, 9)]
    events += [ObjectEvent(tick=6, kind="remove", oid=2),
               ObjectEvent(tick=6, kind="remove", oid=5)]
    sc = Scenario(
        seed=3, n_ticks=10, embed_dim=E, knobs=KN,
        grid=GridSpec(room=8.0, nx=1, nz=1), budget=16,
        clients=tuple(ClientSpec(cid=c, net=NetTrace(),
                                 track=PoseTrack(anchor=(0.0, 1.5, 0.0)),
                                 subscribe_radius=8.0) for c in range(2)),
        events=tuple(events), query=QueryPlan(prob=0.0), drain_ticks=2)
    log = run_scenario(sc, **CPU)
    assert (log.sent_bytes[6] == 2 * TOMBSTONE_NBYTES).all()
    assert (log.sent_bytes[3:6] == 0).all()
    assert (log.sent_bytes[7:] == 0).all()
    assert (log.client_live[-1] == 6).all()


def test_late_joiner_never_sees_removed_objects():
    events = [ObjectEvent(tick=0, kind="spawn", oid=i, class_id=0,
                          pos=(float(i) - 3.0, 1.0, 0.0), n_points=8)
              for i in range(1, 7)]
    events += [ObjectEvent(tick=3, kind="remove", oid=1),
               ObjectEvent(tick=3, kind="remove", oid=2)]
    sc = Scenario(
        seed=4, n_ticks=10, embed_dim=E, knobs=KN,
        grid=GridSpec(room=8.0, nx=1, nz=1), budget=16,
        clients=(ClientSpec(cid=0, subscribe_radius=8.0),
                 ClientSpec(cid=1, subscribe_radius=8.0, join_tick=6)),
        events=tuple(events), query=QueryPlan(prob=0.0), drain_ticks=2)
    eng = ScenarioEngine(sc, **CPU)
    log = eng.run()
    assert _client_ids(eng.sessions[0]) == {3, 4, 5, 6}
    assert _client_ids(eng.sessions[1]) == {3, 4, 5, 6}
    # the late joiner's catch-up is live rows only — no tombstones
    assert int(log.sent_bytes[6, 1]) == 4 * (24 + 2 * E) + 6 * 4 * 8


def test_tombstone_convergence_across_outage():
    events = [ObjectEvent(tick=0, kind="spawn", oid=i, class_id=0,
                          pos=(float(i) - 2.0, 1.0, 0.0), n_points=8)
              for i in range(1, 5)]
    events += [ObjectEvent(tick=4, kind="remove", oid=3)]
    sc = Scenario(
        seed=5, n_ticks=10, embed_dim=E, knobs=KN,
        grid=GridSpec(room=8.0, nx=1, nz=1), budget=16,
        clients=(ClientSpec(cid=0, subscribe_radius=8.0,
                            net=NetTrace(outages=((3.0, 7.0),))),),
        events=tuple(events), query=QueryPlan(prob=0.0), drain_ticks=2)
    eng = ScenarioEngine(sc, **CPU)
    log = eng.run()
    assert (log.sent_bytes[3:7, 0] == 0).all()     # nothing during outage
    assert _client_ids(eng.sessions[0]) == {1, 2, 4}
    # the reconnect tick carried the tombstone (9 B) — not a re-ship of 3
    assert int(log.sent_bytes[7, 0]) == TOMBSTONE_NBYTES


def test_knob_schedule_and_gc():
    kn = Knobs(server_capacity=6, client_capacity=16,
               max_object_points_server=16, max_object_points_client=8,
               min_obs_before_sync=1)
    events = [ObjectEvent(tick=0, kind="spawn", oid=i, class_id=0,
                          pos=(float(i), 1.0, 0.0), n_points=8)
              for i in range(1, 7)]                    # store FULL (cap 6)
    events += [ObjectEvent(tick=2, kind="remove", oid=1),
               ObjectEvent(tick=5, kind="spawn", oid=99, class_id=1,
                           pos=(0.0, 1.0, 1.0), n_points=8)]
    sc = Scenario(
        seed=6, n_ticks=12, embed_dim=E, knobs=kn,
        grid=GridSpec(room=8.0, nx=1, nz=1), budget=16,
        clients=(ClientSpec(cid=0, subscribe_radius=8.0),),
        events=tuple(events),
        knob_events=(KnobEvent(tick=1, min_obs=1),),
        query=QueryPlan(prob=0.0), drain_ticks=2, tombstone_ttl=2)
    eng = ScenarioEngine(sc, **CPU)
    log = eng.run()
    assert int(log.gc_released.sum()) == 1
    # oid 99 could only spawn on the GC-freed slot — and it converged
    assert _client_ids(eng.sessions[0]) == {2, 3, 4, 5, 6, 99}
    assert log.equals(jsim.run_scenario(_to_reference(sc)))


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance.py, through the port
# ---------------------------------------------------------------------------
def _canonical_map(m) -> dict:
    """Content view of a LocalMap keyed by oid (slot order and priority
    are transport-dependent, the object CONTENT must not be)."""
    act = _np(m.active)
    cols = {f: _np(getattr(m, f)) for f in ("ids", "version", "label",
                                            "n_points", "centroid", "embed",
                                            "points")}
    return {int(cols["ids"][s]): (
        int(cols["version"][s]), int(cols["label"][s]),
        int(cols["n_points"][s]), cols["centroid"][s].tobytes(),
        cols["embed"][s].tobytes(), cols["points"][s].tobytes())
        for s in np.nonzero(act)[0]}


def _base_scenario(*, seed=7, n_clients=2, outage=None, faults=None,
                   crash_events=(), lease_ticks=None, drain=DRAIN,
                   remove_ticks=(4,), n_obj=5, ttl=2):
    events = [ObjectEvent(tick=0, kind="spawn", oid=oid, class_id=oid % 4,
                          pos=(0.5 * oid - 1.0, 1.0, 0.3 * oid - 0.7),
                          n_points=4 + oid)
              for oid in range(1, n_obj + 1)]
    for k, tk in enumerate(remove_ticks):
        events.append(ObjectEvent(tick=tk, kind="remove", oid=k + 1))
    events.append(ObjectEvent(tick=3, kind="move", oid=n_obj,
                              delta=(0.4, 0.0, -0.2)))
    events.sort(key=lambda e: (e.tick, e.kind, e.oid))
    clients = tuple(ClientSpec(
        cid=c, net=NetTrace(outages=outage if (outage and c == 1) else ()),
        track=PoseTrack(anchor=(0.0, 1.5, 0.0)), subscribe_radius=10.0)
        for c in range(n_clients))
    return Scenario(seed=seed, n_ticks=N_TICKS, embed_dim=E, knobs=KN_FT,
                    grid=GridSpec(room=8.0, nx=1, nz=1), budget=16,
                    clients=clients, events=tuple(events),
                    query=QueryPlan(prob=0.0), drain_ticks=drain,
                    tombstone_ttl=ttl, faults=faults,
                    crash_events=crash_events, lease_ticks=lease_ticks)


_CHAOS_ARMS = [
    ("loss", 11, FaultModel(seed=3, loss_prob=0.3), (), (4,)),
    ("dup", 12, FaultModel(seed=2, dup_prob=0.5), (), (3, 5)),
    ("reorder", 13, FaultModel(seed=3, reorder_prob=0.5,
                               reorder_jitter_s=2.5), (), (4,)),
    ("corrupt", 14, FaultModel(seed=4, corrupt_prob=0.3), (), (5,)),
    ("everything+crash", 15,
     FaultModel(seed=2, loss_prob=0.15, dup_prob=0.2, reorder_prob=0.25,
                corrupt_prob=0.1),
     (CrashEvent(tick=4, cid=1, down_ticks=2),), (3, 6)),
]


@pytest.mark.parametrize("name,seed,faults,crashes,removes", _CHAOS_ARMS,
                         ids=[a[0] for a in _CHAOS_ARMS])
def test_chaos_converges_fixed_arms(name, seed, faults, crashes, removes):
    """Under each seeded loss/dup/reorder/corrupt/crash mix: after the
    drain tail the maps match the fault-free replay object for object,
    memory stays bounded, no tombstone slot leaks, the chaos run replays
    bit-identically — and its MetricsLog equals the reference's."""
    mk = lambda **kw: _base_scenario(seed=seed, remove_ticks=removes,  # noqa
                                     **kw)
    faulty = mk(faults=faults, crash_events=crashes)
    eng_f = ScenarioEngine(faulty, **CPU)
    log_f = eng_f.run()
    eng_c = ScenarioEngine(mk(), **CPU)
    eng_c.run()

    assert (log_f.client_live <= KN_FT.client_capacity).all()
    cap_bytes = local_map_nbytes(init_local_map(KN_FT, E, **CPU))
    assert (log_f.client_nbytes == cap_bytes).all()

    srv_live = eng_f.world.live_ids()
    assert srv_live == eng_c.world.live_ids()
    for cid in eng_f.sessions:
        got = _canonical_map(eng_f.sessions[cid].dev.local)
        want = _canonical_map(eng_c.sessions[cid].dev.local)
        assert got == want, f"client {cid} diverged: " \
            f"{sorted(got)} vs {sorted(want)}"
        assert set(got) == srv_live
    assert int(deleted_mask(eng_f.world.store).sum()) == 0

    log_f2 = ScenarioEngine(mk(faults=faults, crash_events=crashes),
                            **CPU).run()
    assert log_f.equals(log_f2), log_f.diff(log_f2)
    want = jsim.run_scenario(_to_reference(faulty))
    assert log_f.equals(want), log_f.diff(want)

    flt = log_f.faults.sum(axis=(0, 1))          # lost, dup, corrupt, resync
    if faults.loss_prob:
        assert flt[0] > 0
    if faults.dup_prob:
        assert flt[1] > 0
    if faults.corrupt_prob:
        assert flt[2] > 0


def test_partitioned_subscriber_blocks_retirement_without_lease():
    horizon = float(N_TICKS + DRAIN + 1)
    sc = _base_scenario(outage=((3.0, horizon),), remove_ticks=(4,),
                        lease_ticks=None)
    eng = ScenarioEngine(sc, **CPU)
    log = eng.run()
    assert int(deleted_mask(eng.world.store).sum()) == 1
    assert int(log.gc_released.sum()) == 0
    m0 = _canonical_map(eng.sessions[0].dev.local)
    m1 = _canonical_map(eng.sessions[1].dev.local)
    assert 1 not in m0
    assert 1 in m1


def test_lease_expiry_retires_slot_and_forces_fresh_epoch():
    horizon = float(N_TICKS + DRAIN + 1)
    sc = _base_scenario(outage=((3.0, horizon),), remove_ticks=(4,),
                        lease_ticks=4)
    eng = ScenarioEngine(sc, **CPU)
    log = eng.run()
    assert int(deleted_mask(eng.world.store).sum()) == 0
    assert int(log.gc_released.sum()) == 1
    assert bool(eng.server.needs_fresh[1])


def test_crash_restart_rejoins_with_fresh_epoch():
    sc = _base_scenario(n_clients=1, remove_ticks=(), ttl=None)
    sc = dataclasses.replace(
        sc, events=sc.events + (ObjectEvent(tick=6, kind="remove", oid=2),),
        crash_events=(CrashEvent(tick=5, cid=0, down_ticks=2),))
    eng = ScenarioEngine(sc, **CPU)
    log = eng.run()
    assert not log.client_active[5, 0] and not log.client_active[6, 0]
    assert log.client_live[5, 0] == 0
    assert int(eng.server.epoch[0]) == 2
    got = _canonical_map(eng.sessions[0].dev.local)
    assert set(got) == eng.world.live_ids()
    assert 2 not in got


def _one_object_store(E_, oids, *, embed=None):
    """A store with ``oids`` live in slots 0.. (obs past the transient
    filter), written in place."""
    st = init_store(KN_FT.server_capacity, E_,
                    KN_FT.max_object_points_server, **CPU)
    for s, oid in enumerate(oids):
        st.ids[s] = oid
        st.active[s] = True
        if embed is not None:
            st.embed[s] = embed
        st.n_points[s] = 4 if embed is None else 6 + s
        st.obs_count[s] = 3
        st.version[s] = 1 if embed is None else 1 + s
    return st


def test_resync_backoff_doubles_and_caps():
    fm = FaultModel(resync_timeout_s=2.0, resync_backoff_cap_s=8.0)
    sess = ClientSession(dev=DeviceClient(knobs=KN_FT, embed_dim=8, **CPU),
                         net=NetworkModel(), knobs=KN_FT, dt=1.0, cid=0,
                         faults=fm)
    store = _one_object_store(8, [7])
    pkt, _ = collect_updates(store, init_sync(KN_FT.server_capacity),
                             KN_FT, tick=0)
    pkt.zone, pkt.seq, pkt.epoch = 0, 1, 0      # seq 0 was lost: gap
    sess._receive(0.0, pkt)
    assert sess.delivered == 0                  # buffered, not applied
    fired = []
    for t in range(1, 16):
        sess.step(float(t))
        for kind, _ in sess.drain_ctrl():
            fired.append(t)
    assert fired == [2, 6, 14]                  # 2 -> 4 -> 8 -> capped
    assert sess.resyncs == 3


def test_duplicate_packet_apply_is_byte_identical_noop():
    store = _one_object_store(E, [3, 8, 11],
                              embed=torch.ones(E) / np.sqrt(float(E)))
    pkt, _ = collect_updates(store, init_sync(KN_FT.server_capacity),
                             KN_FT, tick=0)
    assert pkt.count == 3
    dev = DeviceClient(knobs=KN_FT, embed_dim=E, **CPU)
    up = torch.zeros(3)
    dev.ingest(pkt, user_pos=up)
    once = [_np(x).copy() for x in dev.local]
    dev.ingest(pkt, user_pos=up)
    for a, b in zip(once, dev.local):
        assert a.tobytes() == _np(b).tobytes()


def test_stale_version_update_is_dropped():
    m = init_local_map(KN_FT, 8, **CPU)
    mk = lambda ver, val: ObjectUpdate(        # noqa: E731
        oid=torch.tensor(5, dtype=torch.int32),
        embed=torch.full((8,), val), label=torch.tensor(1,
                                                        dtype=torch.int32),
        points=torch.zeros((KN_FT.max_object_points_client, 3),
                           dtype=torch.float16),
        n_points=torch.tensor(4, dtype=torch.int32), centroid=torch.zeros(3),
        version=torch.tensor(ver, dtype=torch.int32))
    m = apply_update(m, mk(3, 0.5), torch.tensor(1.0))
    before = [_np(x).copy() for x in m]
    m = apply_update(m, mk(2, 0.9), torch.tensor(9.0))   # stale: dropped
    for a, b in zip(before, m):
        assert a.tobytes() == _np(b).tobytes()
    assert int(m.version[0]) == 3


# -------------------------------------------- the mesh-sharded session tier
def _shard_scenario(*, seed=21, faults=None, n_clients=4, drain=DRAIN,
                    remove_ticks=(4,)):
    events = [ObjectEvent(tick=0, kind="spawn", oid=oid, class_id=oid % 4,
                          pos=(1.1 * oid - 3.0, 1.0, 0.3 * oid - 0.7),
                          n_points=4 + oid)
              for oid in range(1, 6)]
    for k, tk in enumerate(remove_ticks):
        events.append(ObjectEvent(tick=tk, kind="remove", oid=k + 1))
    events.sort(key=lambda e: (e.tick, e.kind, e.oid))
    clients = tuple(ClientSpec(
        cid=c, net=NetTrace(),
        track=PoseTrack(anchor=(2.0 * c - 3.0, 1.5, 0.0)),
        subscribe_radius=10.0) for c in range(n_clients))
    return Scenario(seed=seed, n_ticks=N_TICKS, embed_dim=E, knobs=KN_FT,
                    grid=GridSpec(room=8.0, nx=2, nz=1), budget=16,
                    clients=clients, events=tuple(events),
                    query=QueryPlan(prob=0.0), drain_ticks=drain,
                    tombstone_ttl=2, faults=faults)


def _toy_store(n_obj=6):
    st = init_store(KN_FT.server_capacity, E, KN_FT.max_object_points_server,
                    **CPU)
    for s in range(n_obj):
        st.ids[s] = s + 1
        st.active[s] = True
        st.embed[s] = torch.ones(E) / np.sqrt(float(E))
        st.centroid[s] = torch.tensor([1.2 * s - 3.0, 1.0, 0.0])
        st.n_points[s] = 4 + s
        st.obs_count[s] = 3
        st.version[s] = 1 + s
    return st


def _shard_server(sc, n_shards):
    grid = ZoneGrid.for_room(sc.grid.room, sc.grid.nx, sc.grid.nz)
    return FleetServer(knobs=sc.knobs, embed_dim=sc.embed_dim,
                       n_clients=len(sc.clients), grid=grid,
                       budget=sc.budget, proto=sc.faults is not None,
                       n_session_shards=n_shards, **CPU)


def test_sharded_tier_chaos_byte_identical_to_unsharded():
    fm = FaultModel(seed=5, loss_prob=0.2, dup_prob=0.2, reorder_prob=0.3,
                    reorder_jitter_s=2.0)
    sc = _shard_scenario(faults=fm)
    eng_1 = ScenarioEngine(sc, server=_shard_server(sc, 1), **CPU)
    log_1 = eng_1.run()
    eng_s = ScenarioEngine(_shard_scenario(faults=fm),
                           server=_shard_server(sc, 3), **CPU)
    log_s = eng_s.run()
    assert log_1.equals(log_s), log_1.diff(log_s)
    assert (eng_s.server.epoch == eng_1.server.epoch).all()

    clean = ScenarioEngine(_shard_scenario(faults=None), **CPU)
    clean.run()
    assert eng_s.world.live_ids() == clean.world.live_ids()
    for cid in eng_s.sessions:
        got = _canonical_map(eng_s.sessions[cid].dev.local)
        want = _canonical_map(clean.sessions[cid].dev.local)
        assert got == want, f"client {cid} diverged under sharding"
    assert int(deleted_mask(eng_s.world.store).sum()) == 0


def _owner(tier, c):
    return tier.parts[int(tier.roster.assign[c])], int(tier.roster.row[c])


def test_epoch_stale_ack_at_owning_shard_is_dropped():
    sc = _shard_scenario(faults=FaultModel(seed=1))
    srv = _shard_server(sc, 3)
    srv.refresh(_toy_store())
    for c in range(4):
        srv.join(c, (2.0 * c - 3.0, 1.5, 0.0), 10.0)
    deliver = np.ones(4, bool)
    pkts = srv.tick(deliver, tick=0)
    (z, pkt), = [(z, p) for z, p in pkts if p.seqs[1] >= 0][:1]
    stale_epoch, stale_seq = int(srv.epoch[1]), int(pkt.seqs[1])
    # the client's ack is delayed; meanwhile a gap forces a resync bump
    srv.request_resync(1)
    part, row = _owner(srv.sessions[z], 1)
    before = np.asarray(part.acked[row]).copy()
    fresh_before = bool(srv.epoch_fresh[1])
    srv.ack(1, z, stale_epoch, stale_seq, tick=2)      # stale: dropped
    assert (np.asarray(part.acked[row]) == before).all()
    assert bool(srv.epoch_fresh[1]) == fresh_before
    # a current-epoch ack for the re-shipped packet lands normally
    pkts2 = srv.tick(deliver, tick=1)
    (z2, pkt2), = [(z, p) for z, p in pkts2 if p.seqs[1] >= 0][:1]
    srv.ack(1, z2, int(srv.epoch[1]), int(pkt2.seqs[1]), tick=3)
    part2, row2 = _owner(srv.sessions[z2], 1)
    assert np.asarray(part2.acked[row2]).any()


def test_resync_rolls_back_only_the_owning_shard_rows():
    sc = _shard_scenario(faults=FaultModel(seed=1))
    srv = _shard_server(sc, 3)
    srv.refresh(_toy_store())
    for c in range(4):
        srv.join(c, (2.0 * c - 3.0, 1.5, 0.0), 10.0)
    srv.tick(np.ones(4, bool), tick=0)
    tier = srv.sessions[0]
    home = int(tier.roster.assign[2])
    snap = {s: _np(p.sync.synced_version).copy()
            for s, p in enumerate(tier.parts) if p is not None}
    srv.request_resync(2)
    for s, p in enumerate(tier.parts):
        if p is None:
            continue
        now = _np(p.sync.synced_version)
        if s != home:
            assert (now == snap[s]).all(), f"shard {s} perturbed"
        else:
            keep = np.ones(now.shape[0], bool)
            keep[int(tier.roster.row[2])] = False
            assert (now[keep] == snap[s][keep]).all()


# ---------------------------------------------------------------------------
# the benchmarks' committed exact counters
# ---------------------------------------------------------------------------
_BIG = Knobs(server_capacity=256, client_capacity=128,
             max_object_points_server=64, max_object_points_client=16,
             min_obs_before_sync=1)


@pytest.mark.parametrize("kw,sent", [
    (GOLDEN_KW, 15150),
    (dict(seed=23, n_objects=60, n_ticks=40, n_clients=8, remove_frac=0.3,
          drain_ticks=8), 111840)], ids=["small", "mid"])
def test_scenario_suite_sent_bytes(kw, sent):
    """BENCH_scenario_suite.json's ``sent_bytes_total``, every client
    converged."""
    eng = ScenarioEngine(churn_scenario(**kw), **CPU)
    log = eng.run()
    assert log.summary()["exact"]["sent_bytes_total"] == sent
    srv = eng.world.live_ids()
    assert all(_client_ids(s) == srv for s in eng.sessions.values())


@pytest.mark.parametrize("loss,crash,down", [
    (0.0, False, 25987), (0.01, False, 26533), (0.05, False, 27675),
    (0.2, False, 40844), (0.05, True, 31898)],
    ids=["loss_0", "loss_0.01", "loss_0.05", "loss_0.2", "crash_recovery"])
def test_fault_tolerance_down_bytes(loss, crash, down):
    """BENCH_fault_tolerance.json's ``down_bytes`` at the benchmark's
    default shape (benchmarks/fault_tolerance.py), every arm converged."""
    crashes = (CrashEvent(tick=12, cid=1, down_ticks=2),) if crash else ()
    sc = churn_scenario(seed=29, n_objects=24, n_ticks=24, n_clients=4,
                        drain_ticks=12, outage_frac=0.0, query_prob=0.0,
                        faults=FaultModel(seed=30, loss_prob=loss),
                        crash_events=crashes)
    eng = ScenarioEngine(sc, **CPU)
    log = eng.run()
    assert log.summary()["exact"]["sent_bytes_total"] == down
    srv = eng.world.live_ids()
    assert all(_client_ids(s) == srv for s in eng.sessions.values())


def test_engine_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScenarioEngine(churn_scenario(seed=1, n_objects=4, n_ticks=4,
                                      n_clients=1))
