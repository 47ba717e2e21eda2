"""The port's zone-sharded query path (``core.query`` over a
``ZoneShardedStore``, zone-level ``cluster_query``, ``FleetServer.query``)
against the JAX reference, at small sizes on the CPU.

Flat and two-stage shards; zone, near and no zone predicate; batched and
not; a score tie across two shards (the earlier selected shard first, as
``lax.top_k`` orders the reference's merge); k past a shard's capacity.
Oids, global slots (``zone * zone_capacity + slot``), cells, zones and
counts exactly; scores within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import query as jquery
from repro.core import store as jstore
from repro.core.knobs import Knobs as JKnobs
from repro.index import search as jsearch
from repro import server as jserver

from repro_torch.core import query as tquery
from repro_torch.core import store as tstore
from repro_torch.core.knobs import Knobs
from repro_torch.index import search as tsearch
from repro_torch import server as tserver

E = 32
KW = dict(server_capacity=64, client_capacity=64,
          max_object_points_server=64, max_object_points_client=16,
          min_obs_before_sync=1)
KN, JKN = Knobs(**KW), JKnobs(**KW)
CLOSE = dict(rtol=1e-5, atol=1e-5)
CPU = dict(device="cpu")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def synth(n, *, cap=64, P=64, seed=0):
    kw = dict(seed=seed, n_labels=10)
    return (jstore.synthetic_store(n, cap, E, P, **kw),
            tstore.synthetic_store(n, cap, E, P, device="cpu", **kw))


def grids(*a, **kw):
    return jserver.ZoneGrid.for_room(*a, **kw), \
        tserver.ZoneGrid.for_room(*a, **kw)


def bump(pair, slots):
    """Version advance on both stores (the port writes in place)."""
    jst, tst = pair
    s = np.asarray(slots, np.int64)
    tst.version[torch.from_numpy(s)] += 1
    return jst._replace(version=jst.version.at[jnp.asarray(s)].add(1)), tst


def _zoned_pair(n=200, seed=0, cap=None, index=False, nx=2, nz=2,
                dup_embed=False):
    """The same store mirrored into each package's ZoneShardedStore."""
    jst, tst = synth(n, cap=max(64, n), seed=seed)
    if dup_embed:       # objects 1 and 2 identical but for their zone
        e = _np(tst.embed[0])
        c = np.array([-2.0, 1.0, -2.0], np.float32)
        c2 = np.array([2.0, 1.0, 2.0], np.float32)
        for s, cc in ((0, c), (1, c2)):
            jst = jst._replace(embed=jst.embed.at[s].set(e),
                               centroid=jst.centroid.at[s].set(cc),
                               label=jst.label.at[s].set(1))
            tst.embed[s] = torch.from_numpy(e)
            tst.centroid[s] = torch.from_numpy(cc)
            tst.label[s] = 1
    kw = dict(embed_dim=E, zone_capacity=cap or 0)
    za = jserver.ZoneShardedStore(knobs=JKnobs(**dict(
        KW, server_capacity=max(64, n))), grid=jserver.ZoneGrid.for_room(
            8.0, nx, nz), **kw)
    zb = tserver.ZoneShardedStore(knobs=Knobs(**dict(
        KW, server_capacity=max(64, n))), grid=tserver.ZoneGrid.for_room(
            8.0, nx, nz), device="cpu", **kw)
    za.refresh_from(jst)
    zb.refresh_from(tst)
    for a, b in zip(za.zones, zb.zones):
        for f in ("ids", "active", "version", "label", "n_points"):
            np.testing.assert_array_equal(_np(getattr(b, f)),
                                          _np(getattr(a, f)), err_msg=f)
    if index:
        for z in (za, zb):
            z.enable_index(min_flat_size=16)
    return (jst, za), (tst, zb)


def _same_result(a, b):
    for f in a._fields:
        x, y = _np(getattr(a, f)), _np(getattr(b, f))
        if np.issubdtype(x.dtype, np.floating):
            np.testing.assert_allclose(y, x, err_msg=f, **CLOSE)
        else:
            np.testing.assert_array_equal(y, x, err_msg=f)


@pytest.mark.parametrize("index", [False, True], ids=["flat", "two_stage"])
def test_sharded_execute_query_matches_reference(index):
    """Flat and two-stage shards, zone / near / no zone predicate, batched
    and not, a score tie across two shards, and k past a shard's
    capacity: equal oids, global slots and scores."""
    (jst, za), (tst, zb) = _zoned_pair(index=index, dup_embed=True,
                                       cap=96)
    q = _np(tst.embed[0])
    grid = tquery.Query.grid_of(zb.grid)
    specs = [dict(k=5), dict(k=5, zones=(0, 3), grid=grid),
             dict(k=7, near=(np.array([-2.0, 1.0, 0.0], np.float32),
                             np.float32(1.5))),
             dict(k=250),                 # past a shard's 96 slots and
             #                              the 200 objects
             dict(k=6, labels=(1,), prox_weight=np.float32(0.3),
                  near=(np.array([0.0, 1.0, 0.0], np.float32),
                        np.float32(9.0)))]
    for kw in specs:
        def build(mod, arr):
            kk = dict(kw)
            if "near" in kk:
                kk["near"] = tuple(arr(x) for x in kk["near"])
            if "prox_weight" in kk:
                kk["prox_weight"] = arr(kk["prox_weight"])
            return mod.Query(embed=arr(q), **kk)
        js = build(jquery, jnp.asarray)
        ts = build(tquery, lambda x: torch.from_numpy(np.array(x)))
        jr = jquery.compile_query(js, za)(za)
        plan = tquery.compile_query(ts, zb)
        assert plan.shards == jquery.compile_query(js, za).shards
        tr = plan(zb)
        _same_result(jr, tr)
        if kw == dict(k=5):           # the tie: the earlier zone first
            assert _np(tr.oids)[:2].tolist() == [1, 2]
            assert float(tr.scores[0]) == float(tr.scores[1])
        if kw["k"] == 250:
            assert int((tr.slots >= 0).sum()) == 200
            assert bool((tr.slots[200:] == -1).all())
    # batched
    qs = _np(tst.embed[:3])
    jr = jquery.execute_query(za, jquery.Query(embed=jnp.asarray(qs), k=4,
                                               batched=True))
    tr = tquery.execute_query(zb, tquery.Query(embed=torch.from_numpy(qs),
                                               k=4, batched=True))
    _same_result(jr, tr)


def test_sharded_query_edges_and_launch_count(monkeypatch):
    """No selected shard gives the padded result; every selected flat
    shard calls ``ops.query_topk_bias`` once."""
    from repro_torch.kernels import ops
    (_, za), (tst, zb) = _zoned_pair()
    q = torch.from_numpy(_np(tst.embed[3]))
    r = tquery.execute_query(zb, tquery.Query(embed=q, zones=(9,), grid=(
        -4.0, -4.0, 4.0, 2, 2), k=3))
    assert r.oids.tolist() == [0, 0, 0] and r.slots.tolist() == [-1] * 3
    assert bool(torch.isneginf(r.scores).all())
    calls = []
    real = ops.query_topk_bias
    monkeypatch.setattr(ops, "query_topk_bias",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    for zones, n in (((1,), 1), ((0, 2, 3), 3)):
        calls.clear()
        tquery.execute_query(zb, tquery.Query(
            embed=q, zones=zones, grid=tquery.Query.grid_of(zb.grid), k=3))
        assert len(calls) == n


def test_zone_level_cluster_query_matches_reference():
    (jst, za), (tst, zb) = _zoned_pair(n=300, index=True)
    q = _np(tst.embed[5])
    for k in (3, 12, 400):            # 400: past every zone's cells
        jr = jquery.execute_query(za, jquery.Query(
            embed=jnp.asarray(q), k=k, level="cluster"))
        tr = tquery.execute_query(zb, tquery.Query(
            embed=torch.from_numpy(q), k=k, level="cluster"))
        _same_result(jr, tr)
    # every zone's index twice over the same zone: exact ties across items
    items_j = [(0, za.indexes[0], za.zones[0]), (1, za.indexes[0],
                                                 za.zones[0])]
    items_t = [(0, zb.indexes[0], zb.zones[0]), (1, zb.indexes[0],
                                                 zb.zones[0])]
    _same_result(jsearch.cluster_query(jquery.Query(
        embed=jnp.asarray(q), k=9, level="cluster"), items_j),
        tsearch.cluster_query(tquery.Query(
            embed=torch.from_numpy(q), k=9, level="cluster"), items_t))


def test_fleet_server_query_and_index_maintenance():
    """FleetServer.query over its zone indexes equals the reference's; the
    zone indexes follow refresh (incremental = rebuilt)."""
    from repro_torch.index import rebuilt, summaries_equal
    gj, gt = grids(8.0, 2, 2)
    fa = jserver.FleetServer(knobs=JKN, embed_dim=E, n_clients=2, grid=gj)
    fb = tserver.FleetServer(knobs=KN, embed_dim=E, n_clients=2, grid=gt,
                             **CPU)
    jst, tst = synth(50, seed=8)
    fa.refresh(jst)
    fb.refresh(tst)
    jst, tst = bump((jst, tst), [1, 2, 3])
    jst = jstore.remove_objects(jst, [10])
    tstore.remove_objects(tst, [10])
    fa.refresh(jst)
    fb.refresh(tst)
    for z, idx in fb.zoned.indexes.items():
        assert summaries_equal(idx.summaries,
                               rebuilt(idx, fb.zoned.zones[z]).summaries)
    q = _np(tst.embed[7])
    _same_result(fa.query(jquery.Query(embed=jnp.asarray(q), k=6)),
                 fb.query(tquery.Query(embed=torch.from_numpy(q), k=6)))
