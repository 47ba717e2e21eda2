"""The port's scenario engine on its mapper path (``ScenarioEngine(mapper=
...)``, ``FleetSimulator``) against the JAX reference, on the CPU.

The mapper's per-view embedder noise is the one input the reference draws
with JAX: the parity cases feed the port the reference's own per-tick draws
(``jax.random.normal(fold_in(key(seed), tick), (D, E))``) through the
engine's ``noise`` hook, and then require a MetricsLog that ``equals`` the
reference's.  Covered: ``rerender_frame``; the dynamic-scene spawn / move /
remove cases of ``tests/test_scenario_properties.py`` on fixed seeds; the
network-drop scenario of ``examples/network_drop_session.py`` (outage at
ticks 4-8, two removals at tick 9); and the FleetSimulator smoke case of
``tests/test_fleet.py`` (stats equal but for the measured ``tick_ms_mean``
and ``hedges``).
"""
import jax
import numpy as np
import pytest
import torch

from repro import sim as jsim
from repro.core import MappingServer as JMappingServer
from repro.core.knobs import Knobs as JKnobs
from repro.data import scenes as jscenes
from repro.perception.embedder import OracleEmbedder as JOracleEmbedder
from repro.server.fleet import FleetSimulator as JFleetSimulator
from repro.server.zones import ZoneGrid as JZoneGrid

from repro_torch.core import MappingServer
from repro_torch.core.knobs import Knobs
from repro_torch.data import scenes as tscenes
from repro_torch.perception.embedder import OracleEmbedder
from repro_torch.server import FleetSimulator, ZoneGrid
from repro_torch.sim import (ClientSpec, NetTrace, ObjectEvent, PoseTrack,
                             QueryPlan, Scenario)
from repro_torch.sim.engine import ScenarioEngine, tick_seed
from repro_torch.sim.scenario import GridSpec

CPU = dict(device="cpu")
E = 32


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def reference_noise(seed, D, E_):
    """The engine's noise hook fed the reference's per-tick draws."""
    key = jax.random.key(seed)
    return lambda i: torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key, i), (D, E_))))


def _to_reference(sc: Scenario):
    """The same Scenario built from the reference's dataclasses."""
    import dataclasses
    conv = lambda o: getattr(jsim, type(o).__name__)(  # noqa: E731
        **{f.name: conv_v(getattr(o, f.name))
           for f in dataclasses.fields(o)})

    def conv_v(v):
        if isinstance(v, tuple):
            return tuple(conv_v(x) for x in v)
        if isinstance(v, Knobs):
            return JKnobs(**dataclasses.asdict(v))
        return conv(v) if dataclasses.is_dataclass(v) else v
    return conv(sc)


# ---------------------------------------------------------------------------
def test_rerender_frame_matches_the_reference():
    """rerender_frame == render_frame on an unchanged scene, and after a
    move and a removal both packages re-splat the same pixels."""
    kw = dict(h=60, w=80, n_frames=40)
    t_scene, j_scene = tscenes.make_scene(6, seed=7), \
        jscenes.make_scene(6, seed=7)
    f = tscenes.render_frame(t_scene, 13, **kw)
    g = tscenes.rerender_frame(t_scene, f)
    for a in ("depth", "inst", "visible_ids"):
        assert np.array_equal(getattr(f, a), getattr(g, a))
    for scene in (t_scene, j_scene):
        scene.objects[0].points = scene.objects[0].points + np.float32(0.4)
        del scene.objects[2]
    jf = jscenes.render_frame(j_scene, 13, **kw)
    g = tscenes.rerender_frame(t_scene, f)
    jg = jscenes.rerender_frame(j_scene, jf)
    for a in ("depth", "inst", "visible_ids", "pose", "intrinsics"):
        assert np.array_equal(getattr(g, a), getattr(jg, a)), a
    assert not np.array_equal(g.inst, f.inst)


# ---------------------------------------------------------------------------
# mapper-backed dynamic scenes (tests/test_scenario_properties.py)
# ---------------------------------------------------------------------------
def _mapper_setup(kn, seed=2, n_objects=6, n_ticks=10, pkg="torch"):
    if pkg == "torch":
        scene = tscenes.make_scene(n_objects=n_objects, seed=seed)
        emb = OracleEmbedder(embed_dim=E)
        mapper = MappingServer(knobs=kn, embedder=emb, **CPU)
        stream = tscenes.scene_stream
    else:
        scene = jscenes.make_scene(n_objects=n_objects, seed=seed)
        emb = JOracleEmbedder(embed_dim=E)
        mapper = JMappingServer(knobs=JKnobs(**kn.__dict__), embedder=emb)
        stream = jscenes.scene_stream
    classes = {o.oid: o.class_id for o in scene.objects}
    frames = list(stream(scene, n_frames=5 * n_ticks, keyframe_interval=5,
                         h=60, w=80))
    return scene, classes, emb, mapper, frames


def _mapper_scenario(events, n_ticks=10, seed=11):
    kn = Knobs(server_capacity=64, client_capacity=32,
               max_object_points_server=32, max_object_points_client=8,
               max_detections_per_frame=8, min_obs_before_sync=1)
    return kn, Scenario(
        seed=seed, n_ticks=n_ticks, embed_dim=E, knobs=kn,
        grid=GridSpec(room=8.0, nx=1, nz=1), budget=16,
        clients=(ClientSpec(cid=0, net=NetTrace(),
                            track=PoseTrack(anchor=(0.0, 1.5, 0.0)),
                            subscribe_radius=10.0),),
        events=tuple(events), query=QueryPlan(prob=0.0), drain_ticks=4)


def _live(mapper):
    st = mapper.store
    act = _np(st.active)
    return act, _np(st.label), _np(st.centroid), set(_np(st.ids)[act]
                                                     .tolist())


def test_mapper_scene_spawn_move_remove_visible():
    """All three event kinds act on a mapper-backed run: a spawned object
    of a class the scene never held is mapped near its spawn point, a moved
    object is re-mapped at its new position, a removed one is tombstoned,
    and the client converges — with the reference's noise, the MetricsLog
    equals the reference's."""
    kn, _ = _mapper_scenario(())
    scene, classes, emb, mapper, frames = _mapper_setup(kn)
    spawn_cls = min(set(range(20)) - {o.class_id for o in scene.objects})
    center0 = next(o.center for o in scene.objects if o.oid == 1).copy()
    delta = np.array([1.5, 0.0, 0.0])
    events = [
        ObjectEvent(tick=2, kind="spawn", oid=50, class_id=spawn_cls,
                    pos=(0.6, 1.0, 0.2), n_points=256),
        ObjectEvent(tick=4, kind="move", oid=1, delta=tuple(delta)),
        ObjectEvent(tick=6, kind="remove", oid=2),
    ]
    _, sc = _mapper_scenario(events)
    noise = reference_noise(sc.seed, kn.max_detections_per_frame, E)
    eng = ScenarioEngine(sc, mapper=mapper, frames=frames, scene=scene,
                         classes=classes, embedder=emb, noise=noise, **CPU)
    log = eng.run()
    assert log.events[:, 0].sum() == 1          # spawn counted
    assert log.events[:, 1].sum() == 1          # move counted
    assert log.events[:, 2].sum() == 1          # remove counted
    assert 50 in {o.oid for o in scene.objects}
    assert 2 not in {o.oid for o in scene.objects}

    act, lab, cent, live = _live(mapper)
    hits = act & (lab == spawn_cls)
    assert hits.any()
    assert np.linalg.norm(cent[hits] - np.array([0.6, 1.0, 0.2]),
                          axis=1).min() < 1.0
    assert np.linalg.norm(cent[act] - (center0 + delta), axis=1).min() < 1.0
    assert 2 not in live
    m = eng.sessions[0].dev.local
    assert set(_np(m.ids)[_np(m.active)].tolist()) == live

    jscene, jclasses, jemb, jmapper, jframes = _mapper_setup(kn, pkg="jax")
    want = jsim.ScenarioEngine(_to_reference(sc), mapper=jmapper,
                               frames=jframes, scene=jscene,
                               classes=jclasses, embedder=jemb).run()
    assert log.equals(want), log.diff(want)
    assert live == set(np.asarray(jmapper.store.ids)[
        np.asarray(jmapper.store.active)].tolist())


def test_mapper_scene_replay_is_bit_identical():
    """Dynamic-scene re-rendering stays inside the determinism contract:
    the same scenario (fresh scene + mapper each run, the default per-tick
    noise) replays to a bit-identical MetricsLog."""
    events = [ObjectEvent(tick=1, kind="spawn", oid=60, class_id=1,
                          pos=(-0.4, 1.0, 0.5), n_points=32),
              ObjectEvent(tick=3, kind="move", oid=60,
                          delta=(0.8, 0.0, -0.4)),
              ObjectEvent(tick=5, kind="remove", oid=60)]
    kn, sc = _mapper_scenario(events, n_ticks=8)

    def run():
        scene, classes, emb, mapper, frames = _mapper_setup(kn, n_ticks=8)
        return ScenarioEngine(sc, mapper=mapper, frames=frames, scene=scene,
                              classes=classes, embedder=emb, **CPU).run()
    a, b = run(), run()
    assert a.equals(b), a.diff(b)
    assert tick_seed(sc.seed, 1) != tick_seed(sc.seed, 2)


@pytest.mark.parametrize("seed,kind_ix", [(3, 0), (17, 1), (40, 2),
                                          (101, 0), (256, 2)])
def test_mapper_scene_event_properties(seed, kind_ix):
    """Seeded sweep: each event kind alone keeps the run deterministic and
    its effect observable in the mapper store."""
    kind = ("spawn", "move", "remove")[kind_ix]
    kn, _ = _mapper_scenario((), n_ticks=6, seed=seed)
    scene, classes, emb, mapper, frames = _mapper_setup(kn, n_ticks=6)
    spawn_cls = min(set(range(20)) - {o.class_id for o in scene.objects})
    pos = np.array([((seed % 7) - 3) * 0.3, 1.0, 0.2])
    if kind == "spawn":
        events = [ObjectEvent(tick=2, kind="spawn", oid=70,
                              class_id=spawn_cls, pos=tuple(pos),
                              n_points=256)]
    elif kind == "move":
        events = [ObjectEvent(tick=2, kind="move", oid=1 + seed % 4,
                              delta=(1.2, 0.0, 0.0))]
    else:
        events = [ObjectEvent(tick=2, kind="remove", oid=1 + seed % 4)]
    _, sc = _mapper_scenario(events, n_ticks=6, seed=seed)
    eng = ScenarioEngine(sc, mapper=mapper, frames=frames, scene=scene,
                         classes=classes, embedder=emb, **CPU)
    eng.run()
    act, lab, cent, live = _live(mapper)
    if kind == "spawn":
        hits = act & (lab == spawn_cls)
        assert hits.any()
        assert np.linalg.norm(cent[hits] - pos, axis=1).min() < 1.0
    elif kind == "remove":
        assert events[0].oid not in live
    else:
        assert eng._scene_dirty      # the move re-rendered the stream


# ---------------------------------------------------------------------------
# examples/network_drop_session.py's scenario
# ---------------------------------------------------------------------------
def network_drop(pkg):
    """The example's scene, mapper and Scenario in one package."""
    sc_mod, kn_cls, emb_cls, srv_cls = (
        (tscenes, Knobs, OracleEmbedder, MappingServer) if pkg == "torch"
        else (jscenes, JKnobs, JOracleEmbedder, JMappingServer))
    scene = sc_mod.make_scene(n_objects=25, seed=2)
    classes = {o.oid: o.class_id for o in scene.objects}
    emb = emb_cls(embed_dim=256)
    kn = kn_cls(server_capacity=256, client_capacity=64,
                max_object_points_server=512, max_object_points_client=128,
                max_detections_per_frame=16, min_obs_before_sync=1)
    srv = srv_cls(knobs=kn, embedder=emb,
                  **(CPU if pkg == "torch" else {}))
    frames = list(sc_mod.scene_stream(scene, n_frames=60,
                                      keyframe_interval=5, h=240, w=320))
    mod = __import__("repro_torch.sim" if pkg == "torch" else "repro.sim",
                     fromlist=["Scenario"])
    scenario = mod.Scenario(
        seed=0, n_ticks=len(frames), tick_s=1.0, embed_dim=256, knobs=kn,
        grid=mod.GridSpec(room=scene.room_size, nx=1, nz=1), budget=64,
        clients=(mod.ClientSpec(
            cid=0, net=mod.NetTrace(rtt_ms=20.0, outages=((4.0, 8.0),)),
            track=mod.PoseTrack(anchor=(0.0, 1.5, 0.0), orbit_radius=0.0),
            subscribe_radius=scene.room_size),),
        events=(mod.ObjectEvent(tick=9, kind="remove", oid=1),
                mod.ObjectEvent(tick=9, kind="remove", oid=2)),
        query=mod.QueryPlan(prob=0.6, radius=scene.room_size, k=3))
    return dict(scenario=scenario, mapper=srv, frames=frames[:9],
                classes=classes, embedder=emb)


def test_network_drop_session_replays_the_reference():
    """The example's 12 ticks (the stream cut after tick 8, the outage over
    ticks 4-8, the removals at tick 9) with the reference's noise: the
    MetricsLog equals the reference's, SQ while up, LQ in the outage, the
    reconnect flush and the 9-byte tombstones on the wire."""
    tkw, jkw = network_drop("torch"), network_drop("jax")
    sc = tkw["scenario"]
    assert sc.n_ticks == 12
    log = ScenarioEngine(noise=reference_noise(sc.seed, 16, 256), **CPU,
                         **tkw).run()
    want = jsim.ScenarioEngine(**jkw).run()
    assert log.equals(want), log.diff(want)
    assert (log.mode_sq[4:8, 0] == 0).all() and log.mode_sq[0, 0] == 1
    assert (log.sent_bytes[4:8, 0] == 0).all()
    assert int(log.sent_bytes[8, 0]) > 0                # reconnect flush
    assert log.events[9, 2] == 2
    assert int(log.sent_tomb_bytes[9:, 0].sum()) == 2 * 9
    assert int(log.client_live[-1, 0]) == int(log.server_live[-1])


# ---------------------------------------------------------------------------
# tests/test_fleet.py's FleetSimulator smoke case
# ---------------------------------------------------------------------------
def test_fleet_simulator_smoke_matches_the_reference():
    kw = dict(server_capacity=64, client_capacity=32,
              max_object_points_server=64, max_object_points_client=16,
              max_detections_per_frame=8, min_obs_before_sync=1)

    def run(pkg):
        if pkg == "torch":
            emb, scene_mod = OracleEmbedder(embed_dim=E), tscenes
            mapper = MappingServer(knobs=Knobs(**kw), embedder=emb, **CPU)
        else:
            emb, scene_mod = JOracleEmbedder(embed_dim=E), jscenes
            mapper = JMappingServer(knobs=JKnobs(**kw), embedder=emb)
        scene = scene_mod.make_scene(n_objects=10, seed=2)
        classes = {o.oid: o.class_id for o in scene.objects}
        frames = list(scene_mod.scene_stream(scene, n_frames=40,
                                             keyframe_interval=5,
                                             h=60, w=80))
        if pkg == "torch":
            sim = FleetSimulator(knobs=Knobs(**kw), embed_dim=E,
                                 n_clients=6, seed=3, **CPU,
                                 grid=ZoneGrid.for_room(scene.room_size,
                                                        2, 2))
            extra = dict(noise=reference_noise(0, 8, E))
        else:
            sim = JFleetSimulator(knobs=JKnobs(**kw), embed_dim=E,
                                  n_clients=6, seed=3,
                                  grid=JZoneGrid.for_room(scene.room_size,
                                                          2, 2))
            extra = {}
        stats = sim.run(n_ticks=8, mapper=mapper, frames=frames,
                        embedder=emb, classes=classes, **extra)
        return sim, stats

    sim, stats = run("torch")
    jsim_, want = run("jax")
    assert stats["down_bytes_total"] >= 0
    per = sum(c.session.down_bytes for c in sim.clients)
    assert per <= stats["down_bytes_total"]   # in-flight may lag delivery
    assert stats["served"] == stats["sq_queries"]   # full drain: no backlog
    assert stats["unserved"] == 0
    assert stats["dropped_by_full_zone"] == 0
    measured = ("tick_ms_mean", "hedges")
    assert {k: v for k, v in stats.items() if k not in measured} \
        == {k: v for k, v in want.items() if k not in measured}
    assert [(c.join_tick, c.leave_tick, c.queries, c.lq_ticks, c.active)
            for c in sim.clients] == \
        [(c.join_tick, c.leave_tick, c.queries, c.lq_ticks, c.active)
         for c in jsim_.clients]
