"""The port's core modules against the JAX reference, module by module.

Same numpy-seeded inputs through both packages: geometry, store,
embedder, association, local map, update protocol and the numpy
conversion helpers.  Ids, counts, versions, masks, wire bytes and crc
exact; floats within 1e-4 (geometry), 1e-5 (scores, priorities,
embeddings; 1e-6 for the embedder itself).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import association as jassoc
from repro.core import geometry as jgeo
from repro.core import local_map as jlm
from repro.core import store as jstore
from repro.core import updates as jupd
from repro.core.knobs import Knobs as JKnobs
from repro.perception.embedder import OracleEmbedder as JOracleEmbedder

from repro_torch import convert
from repro_torch.core import association as tassoc
from repro_torch.core import geometry as tgeo
from repro_torch.core import local_map as tlm
from repro_torch.core import store as tstore
from repro_torch.core import updates as tupd
from repro_torch.core.knobs import Knobs
from repro_torch.perception.embedder import OracleEmbedder

GEOM = dict(rtol=1e-4, atol=1e-4)
SCORE = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_state(j, t, exact, close=(), tol=GEOM):
    for f in exact:
        np.testing.assert_array_equal(_np(getattr(t, f)), _np(getattr(j, f)),
                                      err_msg=f)
    for f in close:
        np.testing.assert_allclose(_np(getattr(t, f)), _np(getattr(j, f)),
                                   err_msg=f, **tol)


# ---------------------------------------------------------------- geometry
def _clouds(B, P, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(B, P, 3)).astype(np.float32)
    n = rng.integers(0, P + 1, size=B).astype(np.int32)
    n[0] = 0
    return pts, n


@pytest.mark.parametrize("P,budget", [(50, 16), (40, 64), (300, 300)])
def test_downsample_and_centroid_bbox(P, budget):
    pts, n = _clouds(6, P, P + budget)
    tp, tn = tgeo.downsample(_t(pts), _t(n), budget)
    jp, jn = jax.vmap(lambda p, m: jgeo.downsample(p, m, budget))(
        jnp.asarray(pts), jnp.asarray(n))
    np.testing.assert_array_equal(_np(tn), _np(jn))
    np.testing.assert_array_equal(_np(tp), _np(jp))
    for g, w in zip(tgeo.centroid_bbox(tp, tn),
                    jax.vmap(jgeo.centroid_bbox)(jp, jn)):
        np.testing.assert_allclose(_np(g), _np(w), **GEOM)


def test_downsample_dyn_per_row_budgets():
    pts, n = _clouds(5, 120, 3)
    budgets = np.array([10, 64, 1, 200, 33], np.int32)
    tp, tn = tgeo.downsample_dyn(_t(pts), _t(n), _t(budgets), 64)
    jp, jn = jax.vmap(lambda p, m, b: jgeo.downsample_dyn(p, m, b, 64))(
        jnp.asarray(pts), jnp.asarray(n), jnp.asarray(budgets))
    np.testing.assert_array_equal(_np(tn), _np(jn))
    np.testing.assert_array_equal(_np(tp), _np(jp))


@pytest.mark.parametrize("Pa,Pb,budget", [(64, 40, 64), (32, 100, 48)])
def test_merge_clouds(Pa, Pb, budget):
    a, na = _clouds(7, Pa, 1)
    b, nb = _clouds(7, Pb, 2)
    tp, tn = tgeo.merge_clouds(_t(a), _t(na), _t(b), _t(nb), budget)
    jp, jn = jax.vmap(lambda pa, x, pb, y: jgeo.merge_clouds(
        pa, x, pb, y, budget))(*(jnp.asarray(v) for v in (a, na, b, nb)))
    np.testing.assert_array_equal(_np(tn), _np(jn))
    np.testing.assert_array_equal(_np(tp), _np(jp))


# ------------------------------------------------------------------- store
def test_init_store_dtypes_and_nbytes_match():
    j = jstore.init_store(16, 8, 5)
    t = tstore.init_store(16, 8, 5, device="cpu")
    for f in j._fields:
        assert _np(getattr(t, f)).dtype == _np(getattr(j, f)).dtype, f
        assert tuple(getattr(t, f).shape) == getattr(j, f).shape, f
    assert tstore.store_nbytes(t) == jstore.store_nbytes(j)


def test_synthetic_store_bit_equal():
    j = jstore.synthetic_store(50, 64, 16, 8, seed=3)
    t = tstore.synthetic_store(50, 64, 16, 8, seed=3, device="cpu")
    _assert_state(j, t, j._fields)


def test_remove_and_release_tombstones():
    j = jstore.synthetic_store(20, 32, 8, 6, seed=1)
    t = tstore.synthetic_store(20, 32, 8, 6, seed=1, device="cpu")
    j = jstore.remove_objects(j, [3, 7, 7, 99])
    t = tstore.remove_objects(t, [3, 7, 7, 99])
    _assert_state(j, t, j._fields)
    np.testing.assert_array_equal(tstore.tombstone_slots(t),
                                  jstore.tombstone_slots(j))
    j = jstore.release_tombstones(j)
    t = tstore.release_tombstones(t)
    _assert_state(j, t, j._fields)


# ---------------------------------------------------------------- embedder
def test_embedder_basis_bit_equal_and_embeddings_match():
    je, te = JOracleEmbedder(embed_dim=96), OracleEmbedder(embed_dim=96)
    assert convert.embedder_basis_matches(np.asarray(je._basis))
    np.testing.assert_array_equal(te.basis_np, np.asarray(je._basis))
    cids = np.array([0, 3, 19, 3, 7], np.int32)
    key = jax.random.key(11)
    want = je.embed_observation(jnp.asarray(cids), key, quality=0.5)
    noise = np.array(jax.random.normal(key, (5, 96)))
    got = te.embed_observation(_t(cids), _t(noise), quality=0.5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_np(te.embed_text(4, "cpu")),
                                  _np(je.embed_text(4)))
    g = torch.Generator().manual_seed(0)
    e = te.embed_observation(_t(cids), g)
    np.testing.assert_allclose(_np(torch.linalg.vector_norm(e, dim=1)), 1.0,
                               rtol=1e-6)


# ------------------------------------------------------------- association
def _frame_inputs(seed, st_n, D, E, P, budget):
    """A populated store and a detection batch that half re-observes it:
    matches, inserts, padding rows and a within-frame conflict."""
    rng = np.random.default_rng(seed)
    j = jstore.synthetic_store(st_n, st_n + 6, E, budget, seed=seed)
    emb = np.asarray(j.embed)
    cent = np.asarray(j.centroid)
    det_emb = rng.normal(size=(D, E)).astype(np.float32)
    det_cent = rng.uniform(-4, 4, size=(D, 3)).astype(np.float32)
    hit = rng.choice(st_n, size=D // 2, replace=False)
    det_emb[:D // 2] = emb[hit] + 0.05 * det_emb[:D // 2]
    det_cent[:D // 2] = cent[hit]
    det_emb[1], det_cent[1] = det_emb[0], det_cent[0]     # conflict
    det_emb /= np.linalg.norm(det_emb, axis=1, keepdims=True)
    pts = rng.normal(size=(D, P, 3)).astype(np.float32)
    n = rng.integers(1, P, size=D).astype(np.int32)
    valid = np.arange(D) < D - 2
    labels = rng.integers(0, 20, size=D).astype(np.int32)
    return j, (det_emb, labels, pts, n, valid), det_cent


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_associate_and_prune_match(seed):
    j, det, cent = _frame_inputs(seed, 20, 10, 32, 24, 16)
    t = convert.store_from_numpy(j, device="cpu")
    j = jstore.remove_objects(j, [2])          # a tombstone holds its slot
    t = tstore.remove_objects(t, [2])
    jd = jassoc.Detections(*(jnp.asarray(a) for a in det))
    td = tassoc.Detections(*(_t(a) for a in det))
    for frame in (40, 41):
        j = jassoc.associate(j, jd, frame=jnp.asarray(frame),
                             point_budget=16, det_centroid=jnp.asarray(cent))
        t = tassoc.associate(t, td, frame=frame, point_budget=16,
                             det_centroid=_t(cent))
        j = jassoc.prune_transients(j, frame=jnp.asarray(frame + 30))
        t = tassoc.prune_transients(t, frame=frame + 30)
        _assert_state(j, t, ("ids", "active", "label", "n_points",
                             "obs_count", "version", "last_seen", "next_id",
                             "deleted"),
                      ("points", "centroid", "bbox_min", "bbox_max"))
        _assert_state(j, t, (), ("embed",), SCORE)


def test_association_scores_and_first_argmax():
    j, det, cent = _frame_inputs(5, 12, 6, 16, 8, 8)
    t = convert.store_from_numpy(j, device="cpu")
    js, _ = jassoc.association_scores(
        j, jassoc.Detections(*(jnp.asarray(a) for a in det)),
        det_centroid=jnp.asarray(cent))
    ts, _ = tassoc.association_scores(
        t, tassoc.Detections(*(_t(a) for a in det)), det_centroid=_t(cent))
    np.testing.assert_allclose(_np(ts), _np(js), **SCORE)
    x = torch.tensor([[1.0, 3.0, 3.0], [-torch.inf] * 3, [2.0, 2.0, 1.0]])
    np.testing.assert_array_equal(_np(tassoc.first_argmax(x, 1)), [1, 0, 0])
    np.testing.assert_array_equal(_np(tassoc.first_argmax(x, 0)), [2, 0, 0])


# --------------------------------------------------------------- local map
def _batch(seed, U, E, Pc, oids, versions, deleted=None, valid=None):
    rng = np.random.default_rng(seed)
    b = dict(oid=np.asarray(oids, np.int32),
             embed=rng.normal(size=(U, E)).astype(np.float32),
             label=rng.integers(0, 20, size=U).astype(np.int32),
             points=rng.normal(size=(U, Pc, 3)).astype(np.float16),
             n_points=rng.integers(1, Pc, size=U).astype(np.int32),
             centroid=rng.uniform(-3, 3, size=(U, 3)).astype(np.float32),
             version=np.asarray(versions, np.int32),
             valid=np.ones(U, bool) if valid is None else np.asarray(valid),
             deleted=np.zeros(U, bool) if deleted is None
             else np.asarray(deleted))
    b["embed"] /= np.linalg.norm(b["embed"], axis=1, keepdims=True)
    return b


def test_compute_priority_matches():
    kn = dict(priority_classes=(2, 5), proximity_weight=0.4)
    b = _batch(0, 12, 16, 4, np.arange(1, 13), np.ones(12))
    interest = np.random.default_rng(1).normal(size=(3, 16)).astype(
        np.float32)
    pos = np.array([0.5, 1.0, -1.0], np.float32)
    want = jlm.compute_priority(
        jnp.asarray(b["embed"]), jnp.asarray(b["label"]),
        jnp.asarray(b["centroid"]), user_pos=jnp.asarray(pos),
        knobs=JKnobs(**kn), interest_embeds=jnp.asarray(interest))
    got = tlm.compute_priority(
        _t(b["embed"]), _t(b["label"]), _t(b["centroid"]), user_pos=_t(pos),
        knobs=Knobs(**kn), interest_embeds=_t(interest))
    np.testing.assert_allclose(_np(got), _np(want), **SCORE)


def test_apply_updates_batch_eviction_stale_and_tombstones():
    """A 6-slot map through three batches: fill + eviction by priority,
    stale-version drop and equal-version refresh, tombstone free-then-reuse
    within one batch, padding rows and unknown-id tombstones."""
    E, Pc = 8, 4
    kw = dict(client_capacity=6, max_object_points_client=Pc)
    jm = jlm.init_local_map(JKnobs(**kw), E)
    tm = tlm.init_local_map(Knobs(**kw), E, device="cpu")
    batches = [
        _batch(1, 8, E, Pc, np.arange(1, 9), np.ones(8)),
        _batch(2, 8, E, Pc, [3, 4, 9, 10, 4, 11, 12, 13],
               [0, 2, 1, 1, 2, 1, 1, 1],
               valid=[1, 1, 1, 1, 1, 1, 0, 1]),
        _batch(3, 8, E, Pc, [4, 14, 99, 5, 15, 16, 3, 17], np.full(8, 3),
               deleted=[1, 0, 1, 1, 0, 0, 0, 0]),
    ]
    for i, b in enumerate(batches):
        pri = np.random.default_rng(10 + i).random(8).astype(np.float32)
        jb = jlm.UpdateBatch(**{k: jnp.asarray(v) for k, v in b.items()})
        jm, jt = jlm.apply_updates_batch_slots(jm, jb, jnp.asarray(pri))
        tb = convert.update_batch_from_numpy(b, device="cpu")
        tm, tt = tlm.apply_updates_batch_slots(tm, tb, _t(pri))
        np.testing.assert_array_equal(_np(tt), _np(jt))
        _assert_state(jm, tm, ("ids", "active", "label", "n_points",
                               "version", "points"),
                      ("embed", "centroid", "priority"), SCORE)
    assert tlm.local_map_nbytes(tm) == jlm.local_map_nbytes(jm)
    drop = np.zeros(6, bool)
    drop[[1, 4]] = True
    _assert_state(jlm.prune_slots(jm, jnp.asarray(drop)),
                  tlm.prune_slots(tm, _t(drop)),
                  ("ids", "active", "version", "n_points", "priority"))


# ----------------------------------------------------------------- updates
def _synced_pair(seed):
    j = jstore.synthetic_store(30, 40, 16, 50, seed=seed)
    j = j._replace(obs_count=jnp.asarray(
        np.random.default_rng(seed).integers(1, 4, 40), jnp.int32))
    return j, convert.store_from_numpy(j, device="cpu")


@pytest.mark.parametrize("full_map", [False, True])
def test_collect_updates_bytes_and_checksum(full_map):
    kn = dict(max_object_points_client=12, min_obs_before_sync=2,
              class_point_overrides=((3, 5), (7, 40)))
    j, t = _synced_pair(4)
    jsync, tsync = jupd.init_sync(40), tupd.init_sync(40)
    for tick in range(3):
        jp, jsync = jupd.collect_updates(j, jsync, JKnobs(**kn), tick=tick,
                                         full_map=full_map)
        tp, tsync = tupd.collect_updates(t, tsync, Knobs(**kn), tick=tick,
                                         full_map=full_map)
        assert (tp.count, tp.nbytes) == (jp.count, jp.nbytes)
        assert tp.compute_checksum() == jp.compute_checksum()
        np.testing.assert_array_equal(tsync.synced_version,
                                      jsync.synced_version)
        if jp.count:
            _assert_state(jp.batch, tp.batch,
                          ("oid", "label", "n_points", "version", "valid",
                           "deleted", "points"), ("centroid",))
        # tick 1 removes objects (tombstones ship first), tick 2 bumps one
        if tick == 0:
            j = jstore.remove_objects(j, [2, 5])
            t = tstore.remove_objects(t, [2, 5])
        else:
            j = j._replace(version=j.version.at[9].add(1))
            t.version[9] += 1
    assert tp.deleted_oids == jp.deleted_oids


def test_bucket_and_budget_table():
    for n in (0, 1, 8, 9, 100, 1025):
        assert tupd.bucket(n) == jupd.bucket(n)
    kn = dict(max_object_points_client=30, class_point_overrides=((1, 5),))
    np.testing.assert_array_equal(tupd.class_budget_table(Knobs(**kn)),
                                  jupd.class_budget_table(JKnobs(**kn)))
    assert tupd.update_nbytes(64, 10) == jupd.update_nbytes(64, 10)
    assert tupd.update_nbytes(64, 10, deleted=True) == 9


def test_ingest_tick_packet_bytes_40628():
    """The ingest_tick benchmark configuration (BENCH_gate.md): a 40-object
    map built over 12 keyframes, then one full-map collect."""
    from repro_torch.core.pipeline import MappingServer
    from repro_torch.data.scenes import make_scene, scene_stream
    kn = Knobs(server_capacity=256, client_capacity=128,
               max_object_points_server=512, max_object_points_client=128,
               max_detections_per_frame=16, min_obs_before_sync=1)
    scene = make_scene(n_objects=40, seed=0)
    classes = {o.oid: o.class_id for o in scene.objects}
    srv = MappingServer(knobs=kn, embedder=OracleEmbedder(embed_dim=256),
                        device="cpu")
    key = jax.random.key(0)
    for i, fr in enumerate(scene_stream(scene, n_frames=60,
                                        keyframe_interval=5, h=240, w=320)):
        noise = np.array(jax.random.normal(jax.random.fold_in(key, i),
                                           (16, 256)))
        srv.process_frame(fr, classes, _t(noise))
    pkt, _ = tupd.collect_updates(srv.store, tupd.init_sync(256), kn,
                                  tick=0, full_map=True)
    assert pkt.nbytes == 40628


# ----------------------------------------------------------------- convert
def test_convert_round_trips_copy():
    j = jstore.synthetic_store(10, 16, 8, 6, seed=2)
    t = convert.store_from_numpy(j, device="cpu")
    back = convert.store_to_numpy(t)
    for f in j._fields:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(j, f)))
    t.ids[0] = 77                      # the port owns a copy
    assert int(np.asarray(j.ids)[0]) == 1
    m = jlm.init_local_map(JKnobs(client_capacity=4,
                                  max_object_points_client=3), 8)
    lm = convert.local_map_from_numpy(m, device="cpu")
    assert lm.points.dtype == torch.float16
    for f, v in convert.local_map_to_numpy(lm).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(m, f)))
    b = _batch(0, 8, 8, 3, np.arange(8), np.ones(8))
    ub = convert.update_batch_from_numpy(b, device="cpu")
    for f, v in convert.update_batch_to_numpy(ub).items():
        np.testing.assert_array_equal(v, b[f])


# ------------------------------------------------------------------- depth
def test_depth_gate_and_upstream_model_match():
    from repro.core import depth as jdepth
    from repro_torch.core import depth as tdepth
    d = np.random.default_rng(0).random((48, 64)).astype(np.float32)
    for r in (1, 5):
        np.testing.assert_array_equal(tdepth.downsample_depth(d, r),
                                      np.asarray(jdepth.downsample_depth(
                                          jnp.asarray(d), r)))
        for h, w in ((120, 160), (720, 1280)):
            kn = dict(depth_downsampling_ratio=r)
            area = np.array([10, 400, 2000, 5000, 80000])
            np.testing.assert_array_equal(
                tdepth.mapping_gate(area, Knobs(**kn), frame_pixels=h * w),
                jdepth.mapping_gate(area, JKnobs(**kn), frame_pixels=h * w))
            tr = tdepth.upstream_bytes_per_frame(h, w, Knobs(**kn))
            jr = jdepth.upstream_bytes_per_frame(h, w, JKnobs(**kn))
            assert (tr.rgb_bytes, tr.depth_bytes, tr.pose_bytes, tr.total) \
                == (jr.rgb_bytes, jr.depth_bytes, jr.pose_bytes, jr.total)
            assert tdepth.upstream_mbps(h, w, Knobs(**kn)) \
                == jdepth.upstream_mbps(h, w, JKnobs(**kn))


# ------------------------------------------------------------------- query
QGRID = (-4.0, -4.0, 4.0, 2, 2)


def _query_specs(center, emb, labels_of):
    """(name, spec kwargs) pairs over every predicate and score term; the
    dynamic values are numpy, handed to each engine as its own arrays."""
    r = np.float32(3.0)
    return [
        ("embed_only", dict(embed=emb, k=5)),
        ("embed_spatial", dict(embed=emb, near=(center, r),
                               prox_weight=np.float32(0.2), k=7)),
        ("embed_attrs", dict(embed=emb, labels=labels_of,
                             min_points=np.int32(20), min_obs=np.int32(2),
                             since=np.int32(0), k=6)),
        ("full_mix", dict(embed=emb, near=(center, r),
                          prox_weight=np.float32(0.2), labels=labels_of,
                          min_points=np.int32(4), zones=(0, 3), grid=QGRID,
                          sem_weight=np.float32(0.7), k=5)),
        ("aabb", dict(embed=emb, aabb=(np.float32([-2, 0, -2]),
                                       np.float32([2, 2, 2])), k=4)),
        ("spatial_only", dict(near=(center, r), prox_weight=np.float32(1.0),
                              labels=labels_of, k=5)),
        ("spatial_ties", dict(near=(center, np.float32(100.0)), k=9)),
        ("k_past_capacity", dict(embed=emb, k=300)),
    ]


def _to_j(v):
    return tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple) \
        else jnp.asarray(v)


def _to_t(v):
    return tuple(_t(x) for x in v) if isinstance(v, tuple) else _t(v)


def _query_targets():
    j = jstore.synthetic_store(200, 256, 32, 40, seed=9)
    j = j._replace(obs_count=jnp.asarray(
        np.random.default_rng(9).integers(1, 4, 256), jnp.int32))
    jl = jlm.LocalMap(ids=j.ids[:64], active=j.active[:64],
                      embed=j.embed[:64], label=j.label[:64],
                      points=j.points[:64, :8].astype(jnp.float16),
                      n_points=j.n_points[:64], centroid=j.centroid[:64],
                      version=j.version[:64],
                      priority=jnp.zeros((64,), jnp.float32))
    return [("store", j, convert.store_from_numpy(j, device="cpu")),
            ("local", jl, convert.local_map_from_numpy(jl, device="cpu"))]


@pytest.mark.parametrize("target", ["store", "local"])
def test_query_engine_matches_reference(target):
    from repro.core import query as jq
    from repro_torch.core import query as tq
    _, j, t = next(x for x in _query_targets() if x[0] == target)
    cent = np.asarray(j.centroid)
    emb = np.asarray(j.embed)
    for name, kw in _query_specs(cent[3], emb[3], tuple(range(8))):
        jspec = jq.Query(**{f: _to_j(v) if f not in
                            ("labels", "zones", "grid", "k") else v
                            for f, v in kw.items()})
        tspec = tq.Query(**{f: _to_t(v) if f not in
                            ("labels", "zones", "grid", "k") else v
                            for f, v in kw.items()})
        jr = jq.execute_query(j, jspec)
        tr = tq.execute_query(t, tspec)
        np.testing.assert_array_equal(_np(tr.oids), _np(jr.oids), name)
        np.testing.assert_array_equal(_np(tr.slots), _np(jr.slots), name)
        np.testing.assert_allclose(_np(tr.scores), _np(jr.scores),
                                   err_msg=name, **SCORE)


def test_batched_queries_match_reference():
    """16 stacked full_mix-style specs, one engine call each side."""
    from repro.core import query as jq
    from repro_torch.core import query as tq
    _, j, t = _query_targets()[0]
    cent, emb = np.asarray(j.centroid), np.asarray(j.embed)
    rows = np.arange(0, 160, 10)
    mk = lambda Q, cv: [Q(embed=cv(emb[i]), near=(cv(cent[i]),   # noqa
                                                 cv(np.float32(2.5))),
                          prox_weight=cv(np.float32(0.2)),
                          labels=tuple(range(10)),
                          min_obs=cv(np.int32(1)), k=5) for i in rows]
    jr = jq.execute_query(j, jq.stack_queries(mk(jq.Query, jnp.asarray)))
    tr = tq.execute_query(t, tq.stack_queries(mk(tq.Query, _t)))
    np.testing.assert_array_equal(_np(tr.oids), _np(jr.oids))
    np.testing.assert_array_equal(_np(tr.slots), _np(jr.slots))
    np.testing.assert_allclose(_np(tr.scores), _np(jr.scores), **SCORE)


# ----------------------------------------------------------------- runtime
def test_network_power_and_mode_models_match():
    from repro.core import runtime as jrt
    from repro_torch.core import runtime as trt
    out = ((1.0, 2.0), (2.5, 2.6))
    jn, tn = jrt.NetworkModel(outages=out), trt.NetworkModel(outages=out)
    for t in (0.0, 0.99, 1.5, 2.0, 2.45, 3.0):
        for nbytes in (0, 1e5, 5e7):
            assert tn.delivery_time(t, nbytes) == jn.delivery_time(t, nbytes)
        assert tn.measured_latency_ms(t) == jn.measured_latency_ms(t)
        assert trt.choose_mode(tn, t, Knobs()) == \
            jrt.choose_mode(jn, t, JKnobs())
    jp, tp = jrt.PowerModel(), trt.PowerModel()
    for kw in (dict(streaming=True), dict(streaming=False, local_qps=2.0,
                                          server_qps=5.0)):
        assert tp.average_power(**kw) == jp.average_power(**kw)


def test_cloud_outage_coalesces_into_one_flush_packet():
    """Tick, two ticks down while the map changes, then the reconnect
    flush: the same packets and outage bookkeeping in both packages."""
    from types import SimpleNamespace
    from repro.core import runtime as jrt
    from repro_torch.core import runtime as trt
    kn = dict(server_capacity=40, max_object_points_client=12,
              min_obs_before_sync=2)
    j, t = _synced_pair(6)
    jref, tref = SimpleNamespace(store=j), SimpleNamespace(store=t)
    jc = jrt.CloudService(knobs=JKnobs(**kn), store_ref=jref)
    tc = trt.CloudService(knobs=Knobs(**kn), store_ref=tref, device="cpu")
    for step in ("up", "down", "down", "flush", "up"):
        if step == "flush":
            jp, tp = jc.flush_buffer(), tc.flush_buffer()
        else:
            jp = jc.update_tick(network_up=step == "up")
            tp = tc.update_tick(network_up=step == "up")
        assert (jp is None) == (tp is None)
        if jp is not None:
            assert (tp.count, tp.nbytes, tp.tick) == (jp.count, jp.nbytes,
                                                      jp.tick)
            assert tp.compute_checksum() == jp.compute_checksum()
        assert (tc.tick, tc.buffered.since_tick, tc.buffered.ticks,
                len(tc.buffered)) == (jc.tick, jc.buffered.since_tick,
                                      jc.buffered.ticks, len(jc.buffered))
        jref.store = jstore.remove_objects(jref.store, [7])
        tref.store = tstore.remove_objects(tref.store, [7])
        jref.store = jref.store._replace(
            version=jref.store.version.at[11].add(1))
        tref.store.version[11] += 1
