"""The port's serving loop (``repro_torch.serving.loop``, ``.loadgen``)
against the JAX reference, at the reference's own test sizes on the CPU.

The cases of ``tests/test_serving_loop.py``: a query racing the in-place
ingest sees exactly the pre-tick snapshot, a tombstone is seen pre or post
and never mixed, the in-place double-buffered chain equals the copying
chain, sync and overlapped serving are byte-identical end to end, and the
fleet tick with overlap equals the sequential one.  The seeded draws
(``IngestStream``, ``LoadGenerator``) equal the reference's, the stores
they build equal the reference's bit for bit, and the loop's per-query
results equal the reference loop's (oids exactly, scores within 1e-5).
Last, ``StageTimes.record`` and the index metrics land in the port's
registry.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import store as jstore
from repro.core.knobs import Knobs as JKnobs
from repro.serving import loadgen as jloadgen
from repro.serving import loop as jloop
from repro.server.fleet import FleetServer as JFleetServer
from repro.server.zones import ZoneGrid as JZoneGrid

from repro_torch import obs as t_obs
from repro_torch.core.knobs import Knobs
from repro_torch.core.query import Query, execute_query
from repro_torch.core.store import SnapshotStore, synthetic_store
from repro_torch.serving.loadgen import LoadGenerator, LoadSpec
from repro_torch.serving.loop import (IngestStream, ServingLoop, apply_delta,
                                      apply_delta_)
from repro_torch.server import FleetServer, ZoneGrid

E, P, CAP, NLIVE = 32, 16, 128, 96
KW = dict(server_capacity=CAP, client_capacity=64,
          max_object_points_server=P, max_object_points_client=8,
          min_obs_before_sync=1)
KN, JKN = Knobs(**KW), JKnobs(**KW)
CPU = dict(device="cpu")
SCORE = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _store(seed=1):
    return synthetic_store(NLIVE, CAP, E, P, seed=seed, **CPU)


def _stream(n_ticks=6, seed=3, **kw):
    kw.setdefault("churn", 24)
    return IngestStream(n_ticks=n_ticks, n_live=NLIVE, embed_dim=E,
                        max_points=P, seed=seed, **CPU, **kw)


def _jstream(n_ticks=6, seed=3, **kw):
    kw.setdefault("churn", 24)
    return jloop.IngestStream(n_ticks=n_ticks, n_live=NLIVE, embed_dim=E,
                              max_points=P, seed=seed, **kw)


def _oracle_topk(store, q, k):
    """Numpy flat-sweep oracle over a store: active slots only, cosine
    score, descending."""
    act = _np(store.active)
    sim = _np(store.embed) @ np.asarray(q)
    sim[~act] = -np.inf
    order = np.argsort(-sim, kind="stable")[:k]
    return _np(store.ids)[order], sim[order]


def _stores_equal(a, b):
    """Two stores (either package) field for field, bit for bit."""
    return all((x is None and y is None)
               or np.array_equal(_np(x), _np(y)) for x, y in zip(a, b))


def _row(store, s):
    return [x[s] for x in store if x is not None and x.ndim]


def _host(store):
    return store._replace(**{f: v.clone() for f, v in store._asdict().items()
                             if v is not None})


# ---------------------------------------------------------------------------
# double-buffer consistency: a query racing the in-place ingest sees a
# consistent snapshot
# ---------------------------------------------------------------------------
def test_mid_ingest_query_is_exactly_pre_tick_snapshot():
    snap = SnapshotStore.of(_store())
    d = _stream().delta_at(0)
    pre = _host(snap.front)                              # pre-tick oracle
    post = apply_delta(snap.front, d)                    # post-tick oracle
    assert _stores_equal(pre, snap.front)                # front untouched

    # aim the query at a slot this delta re-embeds, so pre and post top-k
    # differ — a torn read could not pass both arms below
    row = int(np.argmin(_np(d.tomb)))
    slot = int(_np(d.slots)[row])
    q = _np(d.embed)[row]
    pre_ids, pre_sc = _oracle_topk(pre, q, 5)
    post_ids, post_sc = _oracle_topk(post, q, 5)
    assert int(_np(post.ids)[slot]) == int(post_ids[0])
    assert not np.array_equal(pre_sc, post_sc)

    # the ingest writes the back generation in place while front serves
    back = snap.take_back()
    new = apply_delta_(back, d)
    mid = execute_query(snap.front, Query(embed=torch.from_numpy(q), k=5))
    assert np.array_equal(_np(mid.oids), pre_ids)
    np.testing.assert_allclose(_np(mid.scores), pre_sc, **SCORE)
    assert _stores_equal(pre, snap.front)

    snap.publish(new, pending=d)
    after = execute_query(snap.front, Query(embed=torch.from_numpy(q), k=5))
    assert np.array_equal(_np(after.oids), post_ids)
    np.testing.assert_allclose(_np(after.scores), post_sc, **SCORE)
    assert _stores_equal(post, snap.front)


def test_tombstone_during_query_pre_or_post_never_mixed():
    snap = SnapshotStore.of(_store())
    q = _np(snap.front.embed[7])
    pre_ids, _ = _oracle_topk(snap.front, q, 3)
    victim_slot = 7
    assert int(_np(snap.front.ids)[victim_slot]) == int(pre_ids[0])
    d0 = _stream().delta_at(0)
    U = d0.slots.shape[0]
    one = torch.zeros(U, dtype=torch.bool)
    one[0] = True
    slots = torch.zeros(U, dtype=torch.int32)
    slots[0] = victim_slot
    d = d0._replace(slots=slots, tomb=one, valid=one)

    back = snap.take_back()
    new = apply_delta_(back, d)
    mid = execute_query(snap.front, Query(embed=torch.from_numpy(q), k=3))
    # mid-removal: the victim is still the top hit of the published snap
    assert int(_np(mid.oids)[0]) == int(pre_ids[0])

    snap.publish(new, pending=d)
    post = execute_query(snap.front, Query(embed=torch.from_numpy(q), k=3))
    post_ids, _ = _oracle_topk(snap.front, q, 3)
    assert int(pre_ids[0]) not in _np(post.oids)
    assert np.array_equal(_np(post.oids), post_ids)
    # only the valid row acted: slot 0, the padding rows' slot, kept its
    # pre-tick row (snap.back is the pre-tick generation now)
    assert _stores_equal(_row(new, 0), _row(snap.back, 0))


# ---------------------------------------------------------------------------
# the seeded draws and the scatter equal the reference's
# ---------------------------------------------------------------------------
def test_ingest_stream_draws_equal_the_reference():
    ts, js = _stream(n_ticks=4, tomb_prob=0.2), _jstream(n_ticks=4,
                                                         tomb_prob=0.2)
    for t in range(4):
        a, b = ts.delta_at(t), js.delta_at(t)
        for f in a._fields:
            np.testing.assert_array_equal(_np(getattr(a, f)),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(ts.slots_at(t), np.asarray(b.slots))


def test_in_place_chain_equals_copying_chain_and_the_reference():
    """The double-buffered in-place chain (the two-tick-old buffer replays
    pending + current each tick) equals the copying chain, and both equal
    the reference's functional chain bit for bit."""
    stream, jst_ = _stream(n_ticks=5), _jstream(n_ticks=5)
    ref = _store()
    jref = jstore.synthetic_store(NLIVE, CAP, E, P, seed=1)
    for t in range(5):
        old, prev = ref, _host(ref)
        ref = apply_delta(old, stream.delta_at(t))
        assert _stores_equal(prev, old)              # the input untouched
        jref = jloop.apply_delta(jref, jst_.delta_at(t))
    assert _stores_equal(ref, jref)

    snap = SnapshotStore.of(_store())
    for t in range(5):
        d = stream.delta_at(t)
        back = snap.take_back()
        if snap.pending is not None:
            back = apply_delta_(back, snap.pending)
        snap.publish(apply_delta_(back, d), pending=d)
    assert _stores_equal(ref, snap.front)


# ---------------------------------------------------------------------------
# whole-loop equality: the overlapped schedule is unobservable end to end
# ---------------------------------------------------------------------------
def _loop(overlap, n_ticks=10, C=6, *, shards=1, index=False):
    store = _store()
    srv = FleetServer(knobs=KN, embed_dim=E, n_clients=C,
                      grid=ZoneGrid.for_room(16.0, 2, 2), budget=16,
                      n_session_shards=shards, **CPU)
    lg = LoadGenerator(LoadSpec(n_clients=C, n_ticks=n_ticks, base_hz=3.0,
                                burst_hz=30.0, burst_prob=0.1),
                       embed_dim=E, **CPU)
    ing = _stream(n_ticks=n_ticks)
    snap = SnapshotStore.of(store) if overlap \
        else SnapshotStore(front=store)
    for c in range(C):
        srv.join(c, lg.pose_at(c, 0), 6.0)
    loop = ServingLoop(server=srv, store=snap, ingest=ing, loadgen=lg,
                       overlap=overlap, batch_size=8,
                       max_batches_per_tick=2)
    if index:
        loop.enable_index(min_flat_size=16)
    stats = loop.run(n_ticks)
    return loop, stats


def _same_results(a, b, exact=True):
    assert set(a.results) == set(b.results)
    for rid in a.results:
        assert np.array_equal(a.results[rid].oids, b.results[rid].oids)
        if exact:
            assert np.array_equal(a.results[rid].scores,
                                  b.results[rid].scores)
        else:
            np.testing.assert_allclose(a.results[rid].scores,
                                       b.results[rid].scores, **SCORE)


@pytest.fixture(scope="module")
def sync_loop():
    return _loop(False)


def test_serving_loop_sync_vs_overlapped_byte_identical(sync_loop):
    a, sa = sync_loop
    b, sb = _loop(True)
    assert sa["n_queries_served"] == sb["n_queries_served"] > 0
    assert sa["sent_bytes_total"] == sb["sent_bytes_total"] > 0
    _same_results(a, b)
    assert _stores_equal(a.store.front, b.store.front)
    assert b.store.version == a.store.version == 10


def test_serving_loop_matches_the_reference(sync_loop):
    """The same seeded workload through the reference's synchronous loop:
    the same requests, the same top-k, the same bytes and final store."""
    a, sa = sync_loop
    C, T = 6, 10
    srv = JFleetServer(knobs=JKN, embed_dim=E, n_clients=C,
                       grid=JZoneGrid.for_room(16.0, 2, 2), budget=16)
    lg = jloadgen.LoadGenerator(jloadgen.LoadSpec(
        n_clients=C, n_ticks=T, base_hz=3.0, burst_hz=30.0,
        burst_prob=0.1), embed_dim=E)
    for c in range(C):
        srv.join(c, lg.pose_at(c, 0), 6.0)
    jst = jstore.synthetic_store(NLIVE, CAP, E, P, seed=1)
    b = jloop.ServingLoop(server=srv, store=jstore.SnapshotStore(front=jst),
                          ingest=_jstream(n_ticks=T), loadgen=lg,
                          overlap=False, batch_size=8,
                          max_batches_per_tick=2)
    sb = b.run(T)
    assert sa["n_queries_served"] == sb["n_queries_served"]
    assert sa["sent_bytes_total"] == sb["sent_bytes_total"]
    assert sa["n_arrivals"] == sb["n_arrivals"]
    _same_results(a, b, exact=False)
    assert _stores_equal(a.store.front,
                         jax.tree.map(np.asarray, b.store.front))


def test_serving_loop_index_and_sharded_tier_equal_the_flat_loop(sync_loop):
    """``enable_index`` keeps the cluster index on the publish buffer: its
    two-stage results equal the flat loop's; a 3-part mesh session tier
    sends the same bytes."""
    a, sa = sync_loop
    for overlap in (False, True):
        reg = t_obs.MetricsRegistry()
        prev = t_obs.set_registry(reg)
        try:
            b, sb = _loop(overlap, index=True)
        finally:
            t_obs.set_registry(prev)
        assert reg.counter("query_index_two_stage_total").total() > 0
        assert sb["sent_bytes_total"] == sa["sent_bytes_total"]
        _same_results(a, b, exact=False)
    c, sc = _loop(True, shards=3)
    assert sc["sent_bytes_total"] == sa["sent_bytes_total"]
    _same_results(a, c)


def test_fleet_tick_overlap_byte_identity():
    """server.tick(overlap=True) emits byte-identical packets to the
    sequential per-zone path, across refreshes and pose churn."""
    def run(overlap):
        rng = np.random.default_rng(0)
        store = _store()
        srv = FleetServer(knobs=KN, embed_dim=E, n_clients=5,
                          grid=ZoneGrid.for_room(16.0, 2, 2), budget=16,
                          **CPU)
        for c in range(5):
            srv.join(c, rng.uniform(-6, 6, 3).astype(np.float32), 7.0)
        stream = _stream(n_ticks=4, seed=9)
        out = []
        deliverable = np.ones((5,), bool)
        for t in range(4):
            store = apply_delta(store, stream.delta_at(t))
            srv.refresh(store)
            for z, pkt in srv.tick(deliverable, tick=t, overlap=overlap):
                out.append((z, np.asarray(pkt.nbytes).copy(),
                            _np(pkt.batch.oid).copy(),
                            np.asarray(pkt.seqs).copy()))
        return out

    seq, ovl = run(False), run(True)
    assert len(seq) == len(ovl) > 0
    for (za, na, oa, sa), (zb, nb, ob, sb) in zip(seq, ovl):
        assert za == zb
        assert np.array_equal(na, nb)
        assert np.array_equal(oa, ob)
        assert np.array_equal(sa, sb)


# ---------------------------------------------------------------------------
# load generator: seeded, open-loop, the reference's schedule
# ---------------------------------------------------------------------------
def test_loadgen_draws_equal_the_reference():
    spec = dict(n_clients=16, n_ticks=40, base_hz=1.0, burst_hz=20.0,
                burst_prob=0.05, seed=4)
    a = LoadGenerator(LoadSpec(**spec), embed_dim=E, **CPU)
    b = jloadgen.LoadGenerator(jloadgen.LoadSpec(**spec), embed_dim=E)
    assert a.n_arrivals == b.n_arrivals > 0
    assert a.pose_every == b.pose_every
    for ta, tb in zip(a.arrivals, b.arrivals):
        assert len(ta) == len(tb)
        for (ca, qa), (cb, qb) in zip(ta, tb):
            assert ca == cb and qa.k == qb.k
            assert np.array_equal(_np(qa.embed), np.asarray(qb.embed))
            assert np.array_equal(_np(qa.near[0]), np.asarray(qb.near[0]))
            assert np.array_equal(_np(qa.near[1]), np.asarray(qb.near[1]))
            assert qa.embed.dtype == torch.float32
    # bursty: some tick carries >1 arrival; poses follow the cadence
    assert max(len(t) for t in a.arrivals) > 1
    for t in (0, 3):
        np.testing.assert_array_equal(a.poses(t), b.poses(t))
    np.testing.assert_allclose(a.poses(0)[3], a.pose_at(3, 0), atol=1e-6)


def test_loadgen_latency_accounting():
    lg = LoadGenerator(LoadSpec(n_clients=2, n_ticks=4, seed=0),
                       embed_dim=E, **CPU)
    lg.note_submit(0, 1.0)
    lg.note_served(0, 1.010)
    lg.note_resolved(0, 1.025)
    assert lg.wait_ms == [pytest.approx(10.0)]
    assert lg.e2e_ms == [pytest.approx(25.0)]
    reg = t_obs.MetricsRegistry()
    prev = t_obs.set_registry(reg)
    try:
        rep = lg.record("test")
    finally:
        t_obs.set_registry(prev)
    assert rep["e2e_ms"]["p99"] == pytest.approx(25.0)
    assert reg.histogram("serving_query_e2e_ms").count(mode="test") == 1


# ---------------------------------------------------------------------------
# the stage and index metrics in the port's registry
# ---------------------------------------------------------------------------
def test_stage_times_and_index_metrics_land_in_the_registry():
    from repro_torch.core import MappingServer
    from repro_torch.core.pipeline import StageTimes
    from repro_torch.data.scenes import make_scene, scene_stream
    from repro_torch.index import ClusterIndex
    from repro_torch.perception.embedder import OracleEmbedder

    StageTimes(detect_ms=1.0).record("semanticxr")   # no registry: no-op
    kn = Knobs(server_capacity=CAP, client_capacity=64,
               max_object_points_server=64, max_object_points_client=16,
               max_detections_per_frame=8, min_obs_before_sync=1)
    scene = make_scene(n_objects=6, seed=3)
    classes = {o.oid: o.class_id for o in scene.objects}
    frame = next(iter(scene_stream(scene, n_frames=5, keyframe_interval=5,
                                   h=60, w=80)))
    st = _store()
    idx = ClusterIndex.for_target(st, min_flat_size=16)
    spec = Query(embed=st.embed[5], k=3)
    reg = t_obs.MetricsRegistry()
    prev = t_obs.set_registry(reg)
    try:
        for mode, instrument in (("semanticxr", False),
                                 ("semanticxr", True), ("parallel", False)):
            srv = MappingServer(knobs=kn, embedder=OracleEmbedder(
                embed_dim=E), mode=mode, instrument=instrument, **CPU)
            srv.process_frame(frame, classes, torch.Generator())
        execute_query(st, spec, index=idx)
    finally:
        t_obs.set_registry(prev)
    h = reg.histogram("mapping_stage_ms")
    assert h.count(stage="ingest", mode="semanticxr") == 1
    assert h.count(stage="detect", mode="semanticxr") == 2
    for stage in ("embed", "lift", "associate"):
        assert h.count(stage=stage, mode="semanticxr") == 1
        assert h.count(stage=stage, mode="parallel") == 1
    assert reg.counter("query_index_two_stage_total").total() == 1
    assert reg.histogram("query_index_candidate_fraction").count() == 1
