"""The port's main path against the JAX reference, end to end on the CPU.

A ``make_scene`` stream (120x160, 6 keyframes) goes through both
packages' MappingServer -> CloudService.update_tick -> DeviceClient.ingest
-> SQ / LQ queries.  The embedder noise is the reference's own draw
(``jax.random.normal(fold_in(key(0), i), (D, E))``), handed to the port.
Ids, counts, versions, masks, wire bytes and crc must match exactly; floats
within 1e-4 (geometry), 1e-5 (embeddings, scores, priorities) and one f16
ulp for f16 points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Knobs as JKnobs
from repro.core import MappingServer as JMappingServer
from repro.core.query import Query as JQuery
from repro.core.query import execute_query as j_execute_query
from repro.core.runtime import CloudService as JCloudService
from repro.core.runtime import DeviceClient as JDeviceClient
from repro.data.scenes import make_scene, scene_stream
from repro.perception.embedder import OracleEmbedder as JOracleEmbedder

from repro_torch.core import Knobs, MappingServer, Query, execute_query
from repro_torch.core.runtime import CloudService, DeviceClient
from repro_torch.data import scenes as tscenes
from repro_torch.perception.embedder import OracleEmbedder

E = 64
KW = dict(server_capacity=128, max_object_points_server=256,
          client_capacity=32, max_object_points_client=64,
          max_detections_per_frame=16, min_obs_before_sync=1)
GEOM_TOL = dict(rtol=1e-4, atol=1e-4)
EMB_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_rows_equal(j, t, exact, close, tol, what):
    for f in exact:
        np.testing.assert_array_equal(_np(getattr(t, f)), _np(getattr(j, f)),
                                      err_msg=f"{what}.{f}")
    for f in close:
        np.testing.assert_allclose(_np(getattr(t, f)), _np(getattr(j, f)),
                                   err_msg=f"{what}.{f}", **tol)


def _assert_f16_within_ulp(got, want, what):
    g = _np(got).astype(np.float32)
    w = _np(want).astype(np.float32)
    ulp = np.spacing(np.abs(w).astype(np.float16)).astype(np.float32)
    assert np.all(np.abs(g - w) <= ulp), what


@pytest.fixture(scope="module")
def run():
    """Drive both packages through the same stream; record per-step state."""
    scene = make_scene(n_objects=30, seed=0)
    classes = {o.oid: o.class_id for o in scene.objects}
    jsrv = JMappingServer(knobs=JKnobs(**KW),
                          embedder=JOracleEmbedder(embed_dim=E))
    tsrv = MappingServer(knobs=Knobs(**KW),
                         embedder=OracleEmbedder(embed_dim=E), device="cpu")
    jcloud = JCloudService(knobs=jsrv.knobs, store_ref=jsrv)
    tcloud = CloudService(knobs=tsrv.knobs, store_ref=tsrv, device="cpu")
    jdev = JDeviceClient(knobs=jsrv.knobs, embed_dim=E)
    tdev = DeviceClient(knobs=tsrv.knobs, embed_dim=E, device="cpu")
    user_pos = np.array([0.5, 1.0, -0.5], np.float32)

    key = jax.random.key(0)
    D = KW["max_detections_per_frame"]
    steps = []
    tframes = list(tscenes.scene_stream(tscenes.make_scene(30, seed=0),
                                        n_frames=30, keyframe_interval=5,
                                        h=120, w=160))
    for i, fr in enumerate(scene_stream(scene, n_frames=30,
                                        keyframe_interval=5, h=120, w=160)):
        k = jax.random.fold_in(key, i)
        noise = np.array(jax.random.normal(k, (D, E)))
        jsrv.process_frame(fr, classes, k)
        tsrv.process_frame(tframes[i], classes, torch.from_numpy(noise))
        step = {"frame": fr.idx, "jstore": jsrv.store, "tstore":
                tuple(x.clone() if x is not None else None
                      for x in tsrv.store)}
        if i % 2 == 1:
            jp = jcloud.update_tick(network_up=True)
            tp = tcloud.update_tick(network_up=True)
            jdev.ingest(jp, user_pos=jnp.asarray(user_pos))
            tdev.ingest(tp, user_pos=torch.from_numpy(user_pos))
            step.update(jpkt=jp, tpkt=tp, jlocal=jdev.local,
                        tlocal=tuple(x.clone() for x in tdev.local))
        steps.append(step)
    return dict(steps=steps, jsrv=jsrv, tsrv=tsrv, jdev=jdev, tdev=tdev,
                jemb=jsrv.embedder, temb=tsrv.embedder)


def test_frames_render_identically():
    a = make_scene(n_objects=30, seed=0)
    b = tscenes.make_scene(n_objects=30, seed=0)
    fa = next(iter(scene_stream(a, n_frames=30, h=120, w=160)))
    fb = next(iter(tscenes.scene_stream(b, n_frames=30, h=120, w=160)))
    for f in ("depth", "inst", "pose", "intrinsics", "visible_ids"):
        np.testing.assert_array_equal(getattr(fb, f), getattr(fa, f))


def test_stores_match_after_every_keyframe(run):
    from repro_torch.core.store import ObjectStore
    exact = ("ids", "active", "label", "n_points", "obs_count", "version",
             "last_seen", "next_id", "deleted")
    for s in run["steps"]:
        t = ObjectStore(*s["tstore"])
        _assert_rows_equal(s["jstore"], t, exact,
                           ("points", "centroid", "bbox_min", "bbox_max"),
                           GEOM_TOL, f"store@frame{s['frame']}")
        _assert_rows_equal(s["jstore"], t, (), ("embed",), EMB_TOL,
                           f"store@frame{s['frame']}")
    assert int(_np(run["tsrv"].store.active).sum()) > 0


def test_downlink_packets_match(run):
    ticks = [s for s in run["steps"] if "jpkt" in s]
    assert ticks and any(s["tpkt"].count for s in ticks)
    for s in ticks:
        jp, tp = s["jpkt"], s["tpkt"]
        assert (tp.count, tp.nbytes, tp.tick) == (jp.count, jp.nbytes,
                                                  jp.tick)
        assert tp.compute_checksum() == jp.compute_checksum()
        if jp.count:
            _assert_rows_equal(jp.batch, tp.batch,
                               ("oid", "label", "n_points", "version",
                                "valid", "deleted"),
                               ("centroid",), GEOM_TOL, "packet")
            _assert_rows_equal(jp.batch, tp.batch, (), ("embed",), EMB_TOL,
                               "packet")
            _assert_f16_within_ulp(tp.batch.points, jp.batch.points,
                                   "packet points")


def test_local_maps_match(run):
    from repro_torch.core.local_map import LocalMap
    for s in run["steps"]:
        if "jlocal" not in s:
            continue
        t = LocalMap(*s["tlocal"])
        _assert_rows_equal(s["jlocal"], t,
                           ("ids", "active", "label", "n_points", "version"),
                           ("centroid",), GEOM_TOL, "local")
        _assert_rows_equal(s["jlocal"], t, (), ("embed", "priority"),
                           EMB_TOL, "local")
        _assert_f16_within_ulp(t.points, s["jlocal"].points, "local points")
    assert run["tdev"].memory_bytes() == \
        sum(x.size * x.dtype.itemsize for x in run["jdev"].local)


def test_sq_and_lq_topk_match(run):
    jst, tst = run["jsrv"].store, run["tsrv"].store
    mapped = sorted(set(_np(jst.label)[_np(jst.active)].tolist()))
    assert mapped
    for c in mapped:
        je = run["jemb"].embed_text(c)
        te = run["temb"].embed_text(c, "cpu")
        for jt, tt in ((jst, tst), (run["jdev"].local, run["tdev"].local)):
            jr = j_execute_query(jt, JQuery(embed=je, k=5))
            tr = execute_query(tt, Query(embed=te, k=5))
            np.testing.assert_array_equal(_np(tr.oids), _np(jr.oids))
            np.testing.assert_array_equal(_np(tr.slots), _np(jr.slots))
            np.testing.assert_allclose(_np(tr.scores), _np(jr.scores),
                                       **EMB_TOL)
