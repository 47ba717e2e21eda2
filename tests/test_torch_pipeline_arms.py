"""The port's mapping arms and seed oracles against the JAX reference.

The four Fig. 3 arms of ``MappingServer`` — B (``mode="baseline"``), B+P
(``"parallel"``), B+P+SD instrumented and B+P+SD fused — each run 4
keyframes of a ``make_scene`` stream at 120x160 through both packages.  The
embedder noise is the reference's own draw for that arm: B draws each
detection's row from ``fold_in(key, i)``, the others one [D, E] draw from
``key``; row i of the tensor handed to the port serves detection i.  Then
the oracles: ``lift_depth`` (pixel selection exact), ``merge_clouds_argsort``,
``bbox_pixel_area``, ``associate_reference`` and
``DeviceClient.ingest_sequential``.  Ids, counts, versions and masks exact;
floats within 1e-4 (geometry) and 1e-5 (embeddings, priorities).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Knobs as JKnobs
from repro.core import MappingServer as JMappingServer
from repro.core import association as jassoc
from repro.core import geometry as jgeo
from repro.core import store as jstore
from repro.core import updates as jupd
from repro.core.runtime import DeviceClient as JDeviceClient
from repro.data.scenes import make_scene, scene_stream
from repro.perception.embedder import OracleEmbedder as JOracleEmbedder

from repro_torch import convert
from repro_torch.core import Knobs, MappingServer, Query
from repro_torch.core import association as tassoc
from repro_torch.core import geometry as tgeo
from repro_torch.core import store as tstore
from repro_torch.core import updates as tupd
from repro_torch.core.pipeline import StageTimes
from repro_torch.core.query import execute_query
from repro_torch.core.runtime import CloudService, DeviceClient
from repro_torch.data import scenes as tscenes
from repro_torch.index import rebuilt, summaries_equal
from repro_torch.perception.embedder import OracleEmbedder

E = 64
D = 16
KEYFRAMES = 4
GEOM = dict(rtol=1e-4, atol=1e-4)
EMB = dict(rtol=1e-5, atol=1e-5)
STORE_EXACT = ("ids", "active", "label", "n_points", "obs_count", "version",
               "last_seen", "next_id", "deleted")
# the mapping benchmark's knobs; B and B+P carry uncapped geometry
ARMS = {"B": ("baseline", False, 2048), "B+P": ("parallel", False, 2048),
        "B+P+SD": ("semanticxr", True, 512),
        "B+P+SD fused": ("semanticxr", False, 512)}


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _knobs(points):
    return dict(server_capacity=256, client_capacity=128,
                max_object_points_server=points, max_object_points_client=128,
                max_detections_per_frame=D, min_obs_before_sync=1)


def _assert_state(j, t, exact, close=(), tol=GEOM, what=""):
    for f in exact:
        np.testing.assert_array_equal(_np(getattr(t, f)), _np(getattr(j, f)),
                                      err_msg=f"{what}.{f}")
    for f in close:
        np.testing.assert_allclose(_np(getattr(t, f)), _np(getattr(j, f)),
                                   err_msg=f"{what}.{f}", **tol)


def _reference_noise(mode, key):
    """The [D, E] standard normals the reference's arm draws for one
    keyframe, row i for detection i."""
    if mode == "baseline":
        return np.stack([np.array(jax.random.normal(
            jax.random.fold_in(key, i), (1, E)))[0] for i in range(D)])
    return np.array(jax.random.normal(key, (D, E)))


# ------------------------------------------------------------------- arms
@pytest.mark.parametrize("arm", list(ARMS))
def test_arm_matches_reference(arm):
    mode, instrument, points = ARMS[arm]
    scene = make_scene(n_objects=20, seed=0)
    classes = {o.oid: o.class_id for o in scene.objects}
    jsrv = JMappingServer(knobs=JKnobs(**_knobs(points)),
                          embedder=JOracleEmbedder(embed_dim=E), mode=mode,
                          instrument=instrument)
    tsrv = MappingServer(knobs=Knobs(**_knobs(points)),
                         embedder=OracleEmbedder(embed_dim=E), mode=mode,
                         instrument=instrument, device="cpu")
    tframes = tscenes.scene_stream(tscenes.make_scene(20, seed=0),
                                   n_frames=5 * KEYFRAMES,
                                   keyframe_interval=5, h=120, w=160)
    key = jax.random.key(0)
    for i, fr in enumerate(scene_stream(scene, n_frames=5 * KEYFRAMES,
                                        keyframe_interval=5, h=120, w=160)):
        k = jax.random.fold_in(key, i)
        jsrv.process_frame(fr, classes, k)
        times = tsrv.process_frame(next(tframes), classes,
                                   _t(_reference_noise(mode, k)))
        staged = (times.embed_ms, times.lift_ms, times.associate_ms)
        if arm == "B+P+SD fused":
            assert times.ingest_ms > 0 and staged == (0.0, 0.0, 0.0)
        else:
            assert times.ingest_ms == 0.0 and min(staged) > 0
        _assert_state(jsrv.store, tsrv.store, STORE_EXACT,
                      ("points", "centroid", "bbox_min", "bbox_max"),
                      what=f"{arm}@{i}")
        _assert_state(jsrv.store, tsrv.store, (), ("embed",), EMB,
                      what=f"{arm}@{i}")
    assert int(_np(tsrv.store.active).sum()) > 0
    assert tsrv.frame_count == jsrv.frame_count == KEYFRAMES


@pytest.mark.parametrize("mode", ["baseline", "parallel"])
def test_generator_noise_serves_row_i_to_detection_i(mode):
    """A torch.Generator is one [D, E] draw, row i for detection i, in the
    one-at-a-time arm as in the batched ones."""
    kn = Knobs(**_knobs(2048))
    scene = tscenes.make_scene(n_objects=12, seed=1)
    classes = {o.oid: o.class_id for o in scene.objects}
    fr = next(iter(tscenes.scene_stream(scene, n_frames=5, h=120, w=160)))
    stores = []
    for noise in (torch.Generator().manual_seed(4),
                  torch.randn((D, E), generator=torch.Generator()
                              .manual_seed(4))):
        srv = MappingServer(knobs=kn, embedder=OracleEmbedder(embed_dim=E),
                            mode=mode, device="cpu")
        srv.process_frame(fr, classes, noise)
        stores.append(srv.store)
    for f, v in stores[0]._asdict().items():
        assert torch.equal(v, getattr(stores[1], f)), f


def test_modes_and_stage_record():
    kn = Knobs(**_knobs(512))
    with pytest.raises(ValueError):
        MappingServer(knobs=kn, embedder=OracleEmbedder(embed_dim=E),
                      mode="fused", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        StageTimes().record("semanticxr")


def test_mapping_server_index_serves_cloud_queries():
    """enable_index: every keyframe maintains the index, and
    CloudService.query_spec goes through it with the flat sweep's result."""
    kn = Knobs(**_knobs(512))
    scene = tscenes.make_scene(n_objects=20, seed=0)
    classes = {o.oid: o.class_id for o in scene.objects}
    emb = OracleEmbedder(embed_dim=E)
    srv = MappingServer(knobs=kn, embedder=emb, device="cpu")
    srv.enable_index(n_cells_target=4, min_flat_size=4)
    gen = torch.Generator().manual_seed(0)
    for fr in tscenes.scene_stream(scene, n_frames=20, h=120, w=160):
        srv.process_frame(fr, classes, gen)
        assert summaries_equal(srv.cluster_index.summaries,
                               rebuilt(srv.cluster_index, srv.store).summaries)
    assert srv.cluster_index.engaged()
    cloud = CloudService(knobs=kn, store_ref=srv, device="cpu")
    for c in sorted(set(_np(srv.store.label)[_np(srv.store.active)])):
        spec = Query(embed=emb.embed_text(c, "cpu"), k=5)
        got = cloud.query_spec(spec)
        flat = execute_query(srv.store, spec)
        assert torch.equal(got.oids, flat.oids)
        assert torch.equal(got.slots, flat.slots)


# ---------------------------------------------------------------- oracles
def _lift_inputs(seed, d, h, w, stride):
    rng = np.random.default_rng(seed)
    depth = np.where(rng.random((h, w)) > 0.2,
                     rng.uniform(0.5, 5.0, (h, w)), 0.0).astype(np.float32)
    masks = rng.random((d, h, w)) < rng.uniform(0.05, 0.9, (d, 1, 1))
    intr = np.array([0.9 * w * stride, 0.9 * w * stride, w * stride / 2,
                     h * stride / 2], np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3], pose[:3, 3] = q, rng.uniform(-2, 2, 3)
    return depth, masks, intr, pose


@pytest.mark.parametrize("max_points", [64, 4096])
def test_lift_depth_matches_reference(max_points):
    depth, masks, intr, pose = _lift_inputs(max_points, 5, 24, 32, 5)
    j = jax.vmap(lambda m: jgeo.lift_depth(
        jnp.asarray(depth), m, jnp.asarray(intr), jnp.asarray(pose),
        stride=5, max_points=max_points))(jnp.asarray(masks))
    t = tgeo.lift_depth(_t(depth), _t(masks), _t(intr), _t(pose), stride=5,
                        max_points=max_points)
    np.testing.assert_array_equal(_np(t[1]), _np(j[1]))
    np.testing.assert_array_equal(_np(t[2]), _np(j[2]))
    np.testing.assert_allclose(_np(t[0]), _np(j[0]), **GEOM)
    one = tgeo.lift_depth(_t(depth), _t(masks[2]), _t(intr), _t(pose),
                          stride=5, max_points=max_points)
    for a, b in zip(one, t):
        assert torch.equal(a, b[2])


def test_lift_depth_takes_the_first_valid_pixels_in_raster_order():
    """Unit intrinsics, identity pose, unit depth: each point is its
    pixel's centre, exactly, so equal points are equal pixel indices."""
    depth, masks, _, _ = _lift_inputs(9, 3, 20, 26, 2)
    depth = np.where(depth > 0, 1.0, 0.0).astype(np.float32)
    intr = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
    pose = np.eye(4, dtype=np.float32)
    for m in masks:
        j = jgeo.lift_depth(jnp.asarray(depth), jnp.asarray(m),
                            jnp.asarray(intr), jnp.asarray(pose), stride=2,
                            max_points=100)
        t = tgeo.lift_depth(_t(depth), _t(m), _t(intr), _t(pose), stride=2,
                            max_points=100)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(_np(a), _np(b))
        ys, xs = np.nonzero(m & (depth > 1e-4))
        n = min(len(ys), 100)
        np.testing.assert_array_equal(
            _np(t[0])[:n, :2],
            np.stack([(xs + 0.5) * 2, (ys + 0.5) * 2], 1)[:n])


@pytest.mark.parametrize("Pa,Pb,budget", [(16, 40, 16), (32, 24, 20),
                                          (64, 64, 64)])
def test_merge_clouds_argsort_matches_reference(Pa, Pb, budget):
    rng = np.random.default_rng(Pa + Pb + budget)
    B = 7
    pa = rng.normal(size=(B, Pa, 3)).astype(np.float32)
    pb = rng.normal(size=(B, Pb, 3)).astype(np.float32)
    na = rng.integers(0, min(Pa, budget) + 1, size=B).astype(np.int32)
    nb = rng.integers(0, Pb + 1, size=B).astype(np.int32)
    na[0] = nb[0] = 0
    j = jax.vmap(lambda a, m, b, n: jgeo.merge_clouds_argsort(
        a, m, b, n, budget))(*(jnp.asarray(x) for x in (pa, na, pb, nb)))
    t = tgeo.merge_clouds_argsort(_t(pa), _t(na), _t(pb), _t(nb), budget)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_bbox_pixel_area_matches_reference():
    rng = np.random.default_rng(0)
    masks = rng.random((6, 30, 40)) < 0.002
    masks[0] = False
    for stride in (1, 5):
        want = [int(jgeo.bbox_pixel_area(jnp.asarray(m), stride))
                for m in masks]
        got = tgeo.bbox_pixel_area(_t(masks), stride)
        np.testing.assert_array_equal(_np(got), want)
        assert int(tgeo.bbox_pixel_area(_t(masks[3]), stride)) == want[3]


def _conflict_free_frame(seed, st_n, E_, budget, P):
    """A store and a detection batch that half re-observes it at the
    stored centroids (no two detections on one object), half new."""
    rng = np.random.default_rng(seed)
    j = jstore.synthetic_store(st_n, st_n + 8, E_, budget, seed=seed)
    emb, cent = np.asarray(j.embed), np.asarray(j.centroid)
    det_emb = rng.normal(size=(D, E_)).astype(np.float32)
    hit = rng.choice(st_n, size=D // 2, replace=False)
    det_emb[:D // 2] = emb[hit] + 0.05 * det_emb[:D // 2]
    det_emb /= np.linalg.norm(det_emb, axis=1, keepdims=True)
    centre = rng.uniform(-4, 4, size=(D, 1, 3)).astype(np.float32)
    centre[:D // 2, 0] = cent[hit]
    pts = (centre + 0.05 * rng.normal(size=(D, P, 3))).astype(np.float32)
    n = rng.integers(1, P, size=D).astype(np.int32)
    valid = np.arange(D) < D - 2
    labels = rng.integers(0, 20, size=D).astype(np.int32)
    return j, (det_emb, labels, pts, n, valid)


@pytest.mark.parametrize("seed", [0, 1])
def test_associate_reference_matches_reference_and_batched(seed):
    j, det = _conflict_free_frame(seed, 20, 32, 24, 40)
    t = convert.store_from_numpy(j, device="cpu")
    jd = jassoc.Detections(*(jnp.asarray(a) for a in det))
    td = tassoc.Detections(*(_t(a) for a in det))
    want = jassoc.associate_reference(j, jd, frame=jnp.asarray(3),
                                      point_budget=24)
    got = tassoc.associate_reference(tstore.copy_store(t), td, frame=3,
                                     point_budget=24)
    batched = tassoc.associate(tstore.copy_store(t), td, frame=3,
                               point_budget=24)
    assert int(_np(got.obs_count).max()) == 4        # merges happened
    for other in (want, batched):
        _assert_state(other, got, STORE_EXACT,
                      ("points", "centroid", "bbox_min", "bbox_max"))
        _assert_state(other, got, (), ("embed",), EMB)
    # the copies left the original untouched
    _assert_state(j, t, STORE_EXACT, ("points", "centroid", "embed"))


def test_ingest_sequential_matches_reference_and_batched():
    """The seed per-object ingest: eviction order and admission as the
    reference's, and equal to the batched ingest."""
    kw = dict(server_capacity=64, client_capacity=12,
              max_object_points_server=16, max_object_points_client=8)
    jst = jstore.synthetic_store(40, 64, E, 16, seed=3)
    tst = convert.store_from_numpy(jst, device="cpu")
    jp, _ = jupd.collect_updates(jst, jupd.init_sync(64), JKnobs(**kw),
                                 tick=0, full_map=True)
    tp, _ = tupd.collect_updates(tst, tupd.init_sync(64), Knobs(**kw),
                                 tick=0, full_map=True)
    user = np.array([0.5, 1.0, -0.5], np.float32)
    jdev = JDeviceClient(knobs=JKnobs(**kw), embed_dim=E)
    jdev.ingest_sequential(jp, user_pos=jnp.asarray(user))
    tdev = DeviceClient(knobs=Knobs(**kw), embed_dim=E, device="cpu")
    tdev.ingest_sequential(tp, user_pos=_t(user))
    bdev = DeviceClient(knobs=Knobs(**kw), embed_dim=E, device="cpu")
    bdev.ingest(tp, user_pos=_t(user))
    exact = ("ids", "active", "label", "n_points", "version")
    for other in (jdev.local, bdev.local):
        _assert_state(other, tdev.local, exact, ("centroid",))
        _assert_state(other, tdev.local, (), ("embed", "priority"), EMB)
    assert int(_np(tdev.local.active).sum()) == 12
