"""The port's serving front end against ``repro.serving.batching``, and the
double-buffered ``SnapshotStore`` against ``repro.core.store``.

The scheduler runs the same payload stream in both packages under one
patched clock (each ``perf_counter`` call advances it by a fixed step) with
a step function that leaves some requests unfinished, so stragglers are
hedged: completion order and hedge count must be equal.  The query step
function runs mixed legacy / ``Query`` payloads over the same
numpy-seeded store, flat and through a cluster index: oids and slots
exact, scores within 1e-5.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import query as jquery
from repro.core import store as jstore
from repro.index import ClusterIndex as JClusterIndex
from repro.serving import batching as jbatching

from repro_torch import convert
from repro_torch.core import query as tquery
from repro_torch.core import store as tstore
from repro_torch.core import updates as tupd
from repro_torch.core.knobs import Knobs
from repro_torch.core.runtime import DeviceClient
from repro_torch.index import ClusterIndex, rebuilt, summaries_equal
from repro_torch.serving import batching as tbatching

E = 64
SCORE = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


# -------------------------------------------------------------- scheduler
def _run_scheduler(mod, monkeypatch, *, batch_size, hedge_ms, tick_ms):
    now = [0.0]

    def clock():
        now[0] += tick_ms * 1e-3
        return now[0]

    monkeypatch.setattr(time, "perf_counter", clock)
    steps = [0]

    def step_fn(payloads):
        steps[0] += 1
        out = [p * 10 for p in payloads]
        return out[:-1] if steps[0] % 3 == 1 else out   # a straggler

    sched = mod.BatchScheduler(batch_size=batch_size, step_fn=step_fn,
                               hedge_after_ms=hedge_ms)
    rng = np.random.default_rng(batch_size)
    for p in range(23):
        sched.submit(p, priority=float(rng.integers(0, 4)),
                     deadline_ms=float(rng.integers(10, 200)))
        if p % 5 == 4:
            sched.step()
    done = sched.drain()
    return list(done.items()), sched.hedge_count, steps[0]


@pytest.mark.parametrize("batch_size,hedge_ms,tick_ms",
                         [(4, 50.0, 20.0), (3, 10.0, 7.0), (6, 30.0, 11.0)])
def test_scheduler_order_and_hedges_match_reference(monkeypatch, batch_size,
                                                    hedge_ms, tick_ms):
    kw = dict(batch_size=batch_size, hedge_ms=hedge_ms, tick_ms=tick_ms)
    want = _run_scheduler(jbatching, monkeypatch, **kw)
    got = _run_scheduler(tbatching, monkeypatch, **kw)
    assert got == want
    assert len(got[0]) == 23 and got[1] > 0


# ---------------------------------------------------------- query step_fn
def _stores(n=600):
    j = jstore.clustered_synthetic_store(n, n, E, 16, seed=2, room=20.0,
                                         n_hotspots=12)
    return j, convert.store_from_numpy(j, device="cpu")


def _payloads(st, mk):
    """Legacy embeddings and two Query plans, interleaved."""
    emb, cent = np.array(st.embed), np.array(st.centroid)
    out = []
    for i, r in enumerate((3, 50, 77, 120, 200, 301, 411, 599)):
        if i % 3 == 0:
            out.append(mk["emb"](emb[r]))
        elif i % 3 == 1:
            out.append(mk["Q"](embed=mk["emb"](emb[r]), k=6))
        else:
            out.append(mk["Q"](embed=mk["emb"](emb[r]),
                               near=(mk["emb"](cent[r]),
                                     mk["emb"](np.float32(3.0))),
                               prox_weight=mk["emb"](np.float32(0.2)),
                               labels=tuple(range(10)), k=6))
    return out


J = {"emb": jnp.asarray, "Q": jquery.Query}
T = {"emb": _t, "Q": tquery.Query}


def _same_results(want, got):
    assert len(got) == len(want)
    for w, g in zip(want, got):
        if not hasattr(w, "oids"):          # a legacy (oid, score)
            assert g[0] == w[0]
            np.testing.assert_allclose(g[1], w[1], **SCORE)
        else:
            np.testing.assert_array_equal(g.oids, np.asarray(w.oids))
            np.testing.assert_array_equal(g.slots, np.asarray(w.slots))
            np.testing.assert_allclose(g.scores, np.asarray(w.scores),
                                       **SCORE)


@pytest.mark.parametrize("indexed", [False, True])
def test_query_step_fn_matches_reference(indexed):
    jst, tst = _stores()
    jidx = tidx = None
    if indexed:
        jidx = JClusterIndex.for_target(jst, n_cells_target=16,
                                        min_flat_size=64)
        tidx = ClusterIndex.for_target(tst, n_cells_target=16,
                                       min_flat_size=64)
    jfn = jbatching.make_query_step_fn(lambda: jst, k=5, pad_to=4,
                                       get_index=lambda: jidx)
    tfn = tbatching.make_query_step_fn(lambda: tst, k=5, pad_to=4,
                                       get_index=lambda: tidx)
    _same_results(jfn(_payloads(jst, J)), tfn(_payloads(jst, T)))


def test_pending_results_resolve_to_the_blocking_results():
    _, tst = _stores()
    tidx = ClusterIndex.for_target(tst, n_cells_target=16, min_flat_size=64)
    out = {}
    for block in (True, False):
        sched = tbatching.BatchScheduler(
            batch_size=4, step_fn=tbatching.make_query_step_fn(
                lambda: tst, pad_to=4, block=block, get_index=lambda: tidx))
        for p in _payloads(tst, T):
            sched.submit(p)
        out[block] = sched.drain()
    pending = out[False]
    assert all(isinstance(r, tbatching.PendingResult)
               for r in pending.values())
    first = next(iter(pending.values()))
    assert first.resolve() is first.resolve()          # idempotent
    tbatching.resolve_results(pending)
    assert pending.keys() == out[True].keys()
    for rid, want in out[True].items():
        _same_results([want], [pending[rid]])
        got = pending[rid]
        if hasattr(want, "oids"):
            np.testing.assert_array_equal(got.scores, want.scores)


def test_device_client_index_maintained_by_ingest():
    """enable_index on the local map: every ingest's touched slots keep it
    equal to a rebuild, and query_spec plans through it."""
    kw = dict(server_capacity=256, client_capacity=128,
              max_object_points_server=16, max_object_points_client=8)
    kn = Knobs(**kw)
    st = tstore.synthetic_store(200, 256, E, 16, seed=1, device="cpu")
    dev = DeviceClient(knobs=kn, embed_dim=E, device="cpu")
    dev.enable_index(n_cells_target=4, min_flat_size=8)
    sync = tupd.init_sync(256)
    user = torch.tensor([0.5, 1.0, -0.5])
    for tick in range(3):
        tstore.remove_objects(st, [3 + tick, 40 + tick])
        pkt, sync = tupd.collect_updates(st, sync, kn, tick=tick)
        dev.ingest(pkt, user_pos=user)
        idx = dev.cluster_index
        assert summaries_equal(idx.summaries,
                               rebuilt(idx, dev.local).summaries)
    assert dev.cluster_index.engaged()
    spec = tquery.Query(embed=st.embed[10], k=5)
    got = dev.query_spec(spec)
    flat = tquery.execute_query(dev.local, spec)
    assert torch.equal(got.oids, flat.oids)
    assert torch.equal(got.slots, flat.slots)


# ---------------------------------------------------------- SnapshotStore
def test_snapshot_store_protocol_matches_reference():
    j = jstore.synthetic_store(20, 32, 8, 8, seed=0)
    t = convert.store_from_numpy(j, device="cpu")
    jsnap, tsnap = jstore.SnapshotStore.of(j), tstore.SnapshotStore.of(t)
    assert tsnap.back is not tsnap.front
    for f, v in tsnap.front._asdict().items():
        if v is not None:
            b = getattr(tsnap.back, f)
            assert torch.equal(v, b) and v.data_ptr() != b.data_ptr(), f
    for snap, mod in ((jsnap, jstore), (tsnap, tstore)):
        with pytest.raises(AssertionError):
            snap.publish(snap.front)               # publish without take_back
        back = snap.take_back()
        with pytest.raises(AssertionError):
            snap.take_back()                       # twice without publish
        front_before = snap.front
        snap.publish(back, pending="d1")
        assert snap.back is front_before and snap.front is back
        got, version = snap.snapshot()
        assert got is back and version == 1 and snap.pending == "d1"
    # the generation handed out by take_back is the one to write into
    scratch = tsnap.take_back()
    tstore.remove_objects(scratch, [1, 2])
    assert bool(tsnap.front.active[0]) and not bool(scratch.active[0])
    tsnap.publish(scratch, pending="d2")
    assert tsnap.version == 2 and not bool(tsnap.front.active[1])
    c = tstore.copy_store(t)
    c.ids.fill_(0)
    assert int(t.ids[0]) == 1
