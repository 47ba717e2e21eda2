"""The port's cluster index (``repro_torch.index``) against ``repro.index``.

Same numpy-seeded clustered stores through both packages, at the
reference's own test size (4096 objects, E = 64, 48 hotspots,
``min_flat_size=1024``).  Member tables, counts, AABBs, class presence and
maxima exact; float summaries within rtol = atol = 1e-6; query results:
oids and slots exact, scores within 1e-5.  The port writes stores in
place, so every test that changes a store changes its own.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as j_obs
from repro.core import query as jquery
from repro.core import store as jstore
from repro.index import ClusterIndex as JClusterIndex
from repro.index import rebuilt as j_rebuilt
from repro.index import summaries_equal as j_summaries_equal

from repro_torch import convert
from repro_torch import obs as t_obs
from repro_torch.core import query as tquery
from repro_torch.core import store as tstore
from repro_torch.index import (ClusterIndex, ClusterResult, rebuilt, search,
                               summaries_equal)
from repro_torch.kernels import ops

E = 64
N = 4096
SCORE = dict(rtol=1e-5, atol=1e-5)
SUMM = dict(rtol=1e-6, atol=1e-6)
EXACT_FIELDS = ("count", "aabb_min", "aabb_max", "label_any", "n_points_max",
                "obs_max", "last_seen_max")
FLOAT_FIELDS = ("centroid", "embed_mean", "res_max")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _stores(n=N, seed=0, **kw):
    args = (n, n, E, 16)
    kw = dict(seed=seed, room=40.0, n_hotspots=48, **kw)
    return (jstore.clustered_synthetic_store(*args, **kw),
            tstore.clustered_synthetic_store(*args, device="cpu", **kw))


def _indexes(jst, tst, **kw):
    kw.setdefault("min_flat_size", 1024)
    return (JClusterIndex.for_target(jst, **kw),
            ClusterIndex.for_target(tst, **kw))


def _same_topk(want, got, *, tol=SCORE):
    np.testing.assert_array_equal(_np(got.oids), _np(want.oids))
    np.testing.assert_array_equal(_np(got.slots), _np(want.slots))
    np.testing.assert_allclose(_np(got.scores), _np(want.scores), **tol)


def _same_index(jidx, tidx):
    """Geometry, host member lists, device member table and summaries."""
    assert tidx.grid == type(tidx.grid)(**vars(jidx.grid))
    assert tidx.cell_cap == jidx.cell_cap
    np.testing.assert_array_equal(tidx._size, jidx._size)
    np.testing.assert_array_equal(tidx._members, jidx._members)
    np.testing.assert_array_equal(_np(tidx.members), _np(jidx.members))
    want = convert.cluster_summaries_from_numpy(jidx.summaries._asdict(),
                                                device="cpu")
    for f in EXACT_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tidx.summaries, f)),
                                      _np(getattr(want, f)), err_msg=f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(_np(getattr(tidx.summaries, f)),
                                   _np(getattr(want, f)), err_msg=f, **SUMM)


def _specs(n, st, mk):
    """The four specs of the reference's cluster index tests; ``mk`` turns
    a numpy value into the package's array type."""
    qe = mk(np.asarray(st.embed[n // 3]))
    center = mk(np.asarray(st.centroid[n // 3]))
    f32 = lambda v: mk(np.float32(v))                      # noqa: E731
    i32 = lambda v: mk(np.int32(v))                        # noqa: E731
    return {
        "embed_only": dict(embed=qe, k=8),
        "embed_spatial": dict(embed=qe, near=(center, f32(5.0)),
                              prox_weight=f32(0.3), k=8),
        "attrs": dict(embed=qe, labels=tuple(range(8)), min_points=i32(4),
                      min_obs=i32(1), k=8),
        "negated_sem": dict(embed=qe, sem_weight=f32(-1.0), k=8),
    }


@pytest.fixture(scope="module")
def built():
    jst, tst = _stores()
    jidx, tidx = _indexes(jst, tst)
    return jst, tst, jidx, tidx


# ------------------------------------------------------------------ store
@pytest.mark.parametrize("n,hotspots,seed", [(4096, 48, 0), (300, 128, 5),
                                              (1000, 7, 2)])
def test_clustered_synthetic_store_is_bit_equal(n, hotspots, seed):
    kw = dict(seed=seed, room=40.0, n_hotspots=hotspots)
    j = jstore.clustered_synthetic_store(n, n + 8, E, 16, **kw)
    t = tstore.clustered_synthetic_store(n, n + 8, E, 16, device="cpu", **kw)
    for f in ("ids", "active", "embed", "label", "n_points", "centroid",
              "obs_count", "version", "next_id", "points"):
        got, want = _np(getattr(t, f)), _np(getattr(j, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert int(tstore.n_active(t)) == int(jstore.n_active(j)) == n


# ------------------------------------------------------------------ build
def test_index_build_matches_reference(built):
    jst, tst, jidx, tidx = built
    assert tidx.engaged() and jidx.engaged()
    assert tidx.n_objects == jidx.n_objects == N
    _same_index(jidx, tidx)
    for c in (0, 5, tidx.grid.n_cells - 1):
        np.testing.assert_array_equal(tidx.member_slots(c),
                                      jidx.member_slots(c))


# ----------------------------------------------------- two-stage vs flat
@pytest.mark.parametrize("name", ["embed_only", "embed_spatial", "attrs",
                                  "negated_sem"])
def test_two_stage_matches_reference_and_flat(built, name):
    jst, tst, jidx, tidx = built
    jspec = jquery.Query(**_specs(N, jst, jnp.asarray)[name])
    tspec = tquery.Query(**_specs(N, jst, _t)[name])
    want = jquery.compile_query(jspec, jst, index=jidx)(jst)
    flat = tquery.compile_query(tspec, tst)(tst)
    got = tquery.compile_query(tspec, tst, index=tidx)(tst)
    _same_topk(want, got)
    _same_topk(flat, got)


def test_two_stage_matches_reference_and_flat_batched(built):
    jst, tst, jidx, tidx = built
    rows = np.array([1, 7, N // 2, N - 3])
    qs = np.array(jst.embed)[rows]
    want = jquery.execute_query(
        jst, jquery.Query(embed=jnp.asarray(qs), k=8, batched=True),
        index=jidx)
    spec = tquery.Query(embed=torch.from_numpy(qs), k=8, batched=True)
    got = tquery.execute_query(tst, spec, index=tidx)
    _same_topk(want, got)
    _same_topk(tquery.execute_query(tst, spec), got)


def test_stage1_takes_the_kernel_and_metrics_count(built):
    """Stage 1 and stage 2 are calls of ops.query_topk_bias (the kernel on
    the card); the index's metrics land in the port's registry as the
    reference's land in its own, and nothing is recorded without one."""
    jst, tst, jidx, tidx = built
    spec = tquery.Query(**_specs(N, jst, _t)["embed_spatial"])
    calls = []
    real = ops.query_topk_bias

    def spy(qs, embeds, bias, k):
        calls.append((embeds.shape[0], k))
        return real(qs, embeds, bias, k)

    reg = t_obs.MetricsRegistry()
    prev = t_obs.set_registry(reg)
    search.ops.query_topk_bias = spy
    try:
        tquery.execute_query(tst, spec, index=tidx)
    finally:
        search.ops.query_topk_bias = real
        t_obs.set_registry(prev)
    assert calls[0] == (tidx.grid.n_cells, min(64, tidx.grid.n_cells))
    assert any(n < N and k == 8 for n, k in calls[1:])

    jreg = j_obs.MetricsRegistry()
    jprev = j_obs.set_registry(jreg)
    try:
        jquery.execute_query(
            jst, jquery.Query(**_specs(N, jst, jnp.asarray)["embed_spatial"]),
            index=jidx)
    finally:
        j_obs.set_registry(jprev)
    got, want = reg.snapshot(), jreg.snapshot()
    assert got["counters"]["query_index_two_stage_total"] == {"_": 1}
    assert got["counters"] == want["counters"]
    frac = got["histograms"]["query_index_candidate_fraction"]["_"]
    assert frac["n"] == 1 and 0 < frac["mean"] <= 1
    assert frac == want["histograms"]["query_index_candidate_fraction"]["_"]

    reg.clear()
    tquery.execute_query(tst, spec, index=tidx)     # no registry installed
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


def test_stage1_hands_the_kernel_m_past_1024(built):
    """Stage 1 calls ops.query_topk_bias at every m: at m = 1100 (past the
    old 1024 limit, where it used to take the plain sort ``topk_stable``)
    the selection equals that sort's."""
    from repro_torch.kernels.query_topk import topk_stable
    jst, tst, _, _ = built
    idx = ClusterIndex.for_target(tst, n_cells_target=1600,
                                  min_flat_size=1024)
    M = idx.grid.n_cells
    assert M > 1100
    spec = tquery.Query(**_specs(N, jst, _t)["embed_spatial"])
    calls = []
    real = ops.query_topk_bias

    def spy(qs, embeds, bias, k):
        calls.append((embeds.shape[0], k))
        return real(qs, embeds, bias, k)
    search.ops.query_topk_bias = spy
    try:
        cells, excl = search._stage1(spec, idx.summaries, m=1100,
                                     has_obs=True, has_seen=True)
    finally:
        search.ops.query_topk_bias = real
    assert calls == [(M, 1100)]
    # the selection the plain sort made before
    p = tquery._promote(spec, "cpu")
    ok, slack = search._cluster_gate(p, idx.summaries, has_obs=True,
                                     has_seen=True)
    bias = torch.where(ok, slack, tquery.NEG)
    ub = torch.where(bias > tquery.NEG * 0.5, search._scaled_queries(p)
                     @ idx.summaries.embed_mean.T + bias, tquery.NEG)
    vals, picks = topk_stable(ub, 1100)
    want = np.unique(_np(picks)[_np(vals) > tquery.NEG * 0.5])
    got = _np(cells)
    np.testing.assert_array_equal(got[got >= 0], want)


@pytest.mark.parametrize("k", [2000, 2700])
def test_execute_query_past_k_1024_matches_reference(k):
    """k = 2000 over 2,600 slots, and k past the capacity: the port's CPU
    path equals the reference's.  Values are multiples of 1/16, so every
    score is exact in f32 and ties are exact: the tie order must agree."""
    rng = np.random.default_rng(k)
    jst = jstore.synthetic_store(2500, 2600, E, 16, seed=1)
    tst = tstore.synthetic_store(2500, 2600, E, 16, seed=1, device="cpu")
    emb = np.zeros((2600, E), np.float32)
    emb[:2500] = rng.integers(-4, 5, size=(2500, E)) / 16
    jst = jst._replace(embed=jnp.asarray(emb))
    tst.embed[:] = torch.from_numpy(emb)
    q = (rng.integers(-4, 5, size=(E,)) / 16).astype(np.float32)
    for kw in ({}, dict(labels=(1, 2, 3, 4, 5, 6, 7))):
        want = jquery.execute_query(jst, jquery.Query(embed=jnp.asarray(q),
                                                      k=k, **kw))
        got = tquery.execute_query(tst, tquery.Query(
            embed=torch.from_numpy(q), k=k, **kw))
        _same_topk(want, got)
        assert got.oids.shape == (k,)
        n_ok = int((got.slots >= 0).sum())
        assert n_ok == min(k, 2500 if not kw else int(
            np.isin(_np(tst.label)[:2500], kw["labels"]).sum()))


# ------------------------------------------------------------ cluster level
@pytest.mark.parametrize("batched", [False, True])
def test_cluster_level_query_matches_reference(built, batched):
    jst, tst, jidx, tidx = built
    rows = [N // 3, 11] if batched else N // 3
    qe = np.array(jst.embed)[rows]
    dw = np.full((2,), 0.5, np.float32) if batched else np.float32(0.5)
    kw = dict(k=4, level="cluster", batched=batched)
    want = jquery.compile_query(
        jquery.Query(embed=jnp.asarray(qe), density_weight=jnp.asarray(dw),
                     **kw), jst, index=jidx)(jst)
    got = tquery.compile_query(
        tquery.Query(embed=torch.from_numpy(qe),
                     density_weight=torch.from_numpy(np.asarray(dw)), **kw),
        tst, index=tidx)(tst)
    assert isinstance(got, ClusterResult)
    for f in ("zones", "cells", "counts"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(_np(got.scores), _np(want.scores), **SCORE)
    np.testing.assert_allclose(_np(got.centroids), _np(want.centroids),
                               **SUMM)


def test_cluster_level_requires_an_index():
    _, tst = _stores(256)
    spec = tquery.Query(embed=tst.embed[0], k=4, level="cluster")
    with pytest.raises(ValueError):
        tquery.compile_query(spec, tst)(tst)


# ---------------------------------------------------------- flat fallback
def test_index_below_min_flat_size_falls_back_to_the_flat_sweep():
    jst, tst = _stores(512)
    jidx, tidx = _indexes(jst, tst, min_flat_size=1024)
    assert not tidx.engaged() and not jidx.engaged()
    spec = tquery.Query(embed=tst.embed[3], k=5)
    reg = t_obs.MetricsRegistry()
    prev = t_obs.set_registry(reg)
    try:
        got = tquery.compile_query(spec, tst, index=tidx)(tst)
    finally:
        t_obs.set_registry(prev)
    assert reg.counter("query_index_flat_total").total() == 1
    assert reg.counter("query_index_two_stage_total").total() == 0
    _same_topk(tquery.execute_query(tst, spec), got, tol=dict(rtol=0, atol=0))
    _same_topk(jquery.execute_query(
        jst, jquery.Query(embed=jst.embed[3], k=5), index=jidx), got)


# ------------------------------------- incremental == rebuild after churn
def test_incremental_equals_rebuild_after_churn():
    n = 2048
    jst, tst = _stores(n)
    jidx, tidx = _indexes(jst, tst, min_flat_size=512)
    rng = np.random.default_rng(7)

    gone = rng.choice(np.arange(1, n + 1), 200, replace=False)
    jst = jstore.remove_objects(jst, gone)
    tst = tstore.remove_objects(tst, gone)          # in place
    jidx.refresh(jst)
    tidx.refresh(tst)
    assert summaries_equal(tidx.summaries, rebuilt(tidx, tst).summaries)
    _same_index(jidx, tidx)

    slots = rng.choice(n, 150, replace=False)
    cent = np.asarray(jst.centroid).copy()
    cent[slots] += rng.normal(scale=8.0, size=(150, 3)).astype(np.float32)
    jst = jst._replace(centroid=jnp.asarray(cent),
                       version=jst.version.at[jnp.asarray(slots)].add(1))
    tst.centroid.copy_(torch.from_numpy(cent))
    tst.version[torch.from_numpy(slots)] += 1
    jidx.refresh(jst)
    tidx.refresh(tst)
    assert summaries_equal(tidx.summaries, rebuilt(tidx, tst).summaries)
    _same_index(jidx, tidx)
    assert j_summaries_equal(jidx.summaries,
                             j_rebuilt(jidx, jst).summaries)

    tidx.update_slots(tst, np.arange(n))          # the delta path agrees
    assert summaries_equal(tidx.summaries, rebuilt(tidx, tst).summaries)


def test_tombstoned_members_are_evicted():
    n = 1024
    _, tst = _stores(n)
    tidx = ClusterIndex.for_target(tst, min_flat_size=256)
    tstore.remove_objects(tst, np.arange(1, n + 1, 3))
    tidx.refresh(tst)
    live = set(np.nonzero(_np(tst.active) & ~_np(tst.deleted))[0].tolist())
    members = set()
    for c in range(tidx.grid.n_cells):
        members |= set(tidx.member_slots(c).tolist())
    assert members == live and tidx.n_objects == len(live)


def test_cell_overflow_auto_grows():
    kw = dict(centroid_low=(-1, 0, -1), centroid_high=(1, 1, 1))
    jst = jstore.synthetic_store(512, 512, E, 16, **kw)
    tst = tstore.synthetic_store(512, 512, E, 16, device="cpu", **kw)
    ikw = dict(n_cells_target=4, cell_cap=8, min_flat_size=256)
    jidx, tidx = _indexes(jst, tst, **ikw)
    assert tidx.cell_cap > 8 and tidx.rebuilds > 0
    _same_index(jidx, tidx)
    assert summaries_equal(tidx.summaries, rebuilt(tidx, tst).summaries)
    spec = tquery.Query(embed=tst.embed[11], k=6)
    _same_topk(tquery.compile_query(spec, tst)(tst),
               tquery.compile_query(spec, tst, index=tidx)(tst))


# ----------------------------------------------------- deprecated wrappers
def test_wrappers_byte_compat():
    n = 2048
    jst, tst = _stores(n)
    jidx, tidx = _indexes(jst, tst, min_flat_size=512)
    qe, qs = tst.embed[5], tst.embed[torch.tensor([5, 9, 100])]
    carrier = SimpleNamespace(**tst._asdict(), cluster_index=tidx)
    exact = dict(tol=dict(rtol=0, atol=0))

    for target in (tst, carrier):
        with pytest.deprecated_call():
            w = tquery.query_server(target, qe, k=7)
        _same_topk(tquery.execute_query(target, tquery.Query(embed=qe, k=7)),
                   w, **exact)
        with pytest.deprecated_call():
            wb = tquery.batched_query_server(target, qs, k=7)
        _same_topk(tquery.execute_query(
            target, tquery.Query(embed=qs, k=7, batched=True)), wb, **exact)
    _same_topk(tquery.execute_query(tst, tquery.Query(embed=qe, k=7)),
               tquery.execute_query(carrier, tquery.Query(embed=qe, k=7)))

    # against the reference's wrappers, through its index
    jcarrier = SimpleNamespace(**jst._asdict(), cluster_index=jidx)
    with pytest.deprecated_call():
        want = jquery.query_server(jcarrier, jst.embed[5], k=7)
    with pytest.deprecated_call():
        _same_topk(want, tquery.query_server(carrier, qe, k=7))

    lm = SimpleNamespace(ids=tst.ids, active=tst.active, embed=tst.embed,
                         label=tst.label, n_points=tst.n_points,
                         centroid=tst.centroid)
    with pytest.deprecated_call():
        w = tquery.query_local(lm, qe, k=7)
    _same_topk(tquery.execute_query(lm, tquery.Query(embed=qe, k=7)), w,
               **exact)
    with pytest.deprecated_call():
        w = tquery.batched_query_local(lm, qs, k=7)
    _same_topk(tquery.execute_query(
        lm, tquery.Query(embed=qs, k=7, batched=True)), w, **exact)


def test_active_mask_wrappers_match_reference():
    from repro.kernels import ops as jops
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(300, E)).astype(np.float32)
    qs = rng.normal(size=(3, E)).astype(np.float32)
    active = rng.random(300) < 0.6
    jv, ji = jops.query_topk_multi(jnp.asarray(qs), jnp.asarray(emb),
                                   jnp.asarray(active), 6)
    tv, ti = ops.query_topk_multi(torch.from_numpy(qs), torch.from_numpy(emb),
                                  torch.from_numpy(active), 6)
    np.testing.assert_array_equal(_np(ti), _np(ji))
    np.testing.assert_allclose(_np(tv), _np(jv), **SCORE)
    jv, ji = jops.query_topk(jnp.asarray(qs[0]), jnp.asarray(emb),
                             jnp.asarray(active), 6)
    tv, ti = ops.query_topk(torch.from_numpy(qs[0]), torch.from_numpy(emb),
                            torch.from_numpy(active), 6)
    np.testing.assert_array_equal(_np(ti), _np(ji))
    np.testing.assert_allclose(_np(tv), _np(jv), **SCORE)


def test_sharded_cluster_query_is_not_ported():
    """The name predates the fleet tier: cluster_query over several zone
    items is ported now.  Two items over one index tie on every score, so
    the merge must order ties as the reference's ``lax.top_k`` does (the
    earlier item first, then the lower rank), zones, cells, counts and
    centroids included."""
    from repro.index import search as jsearch
    jst, tst = _stores(256)
    jidx, tidx = _indexes(jst, tst)
    q = _np(tst.embed[0])
    for k in (2, 9, 40):          # 40 > two items' non-empty cells
        jr = jsearch.cluster_query(
            jquery.Query(embed=jnp.asarray(q), k=k, level="cluster"),
            [(0, jidx, jst), (1, jidx, jst)])
        tr = search.cluster_query(
            tquery.Query(embed=torch.from_numpy(q), k=k, level="cluster"),
            [(0, tidx, tst), (1, tidx, tst)])
        for f in ("zones", "cells", "counts"):
            np.testing.assert_array_equal(_np(getattr(tr, f)),
                                          _np(getattr(jr, f)), err_msg=f)
        np.testing.assert_allclose(_np(tr.scores), _np(jr.scores), **SCORE)
        np.testing.assert_allclose(_np(tr.centroids), _np(jr.centroids),
                                   **SUMM)
