"""The port's protocol layer (``core/updates``, ``core/runtime``'s
FaultModel and ClientSession, ``local_map.apply_update``, the depth gates,
``core/autotune``) against the JAX reference.

Same numpy-seeded stores and scripted deliveries through both packages:
wire bytes, sequence numbers, crc32, acks, resync requests, fault counters,
ids, versions and counts exactly; local-map points to one f16 ulp (they are
copied, never recomputed, so in practice exactly); centroids and
priorities within 1e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jautotune
from repro.core import depth as jdepth
from repro.core import local_map as jlm
from repro.core import runtime as jrt
from repro.core import store as jstore
from repro.core import updates as jupd
from repro.core.knobs import Knobs as JKnobs
from repro.server import session as jsession

from repro_torch.core import autotune as tautotune
from repro_torch.core import depth as tdepth
from repro_torch.core import local_map as tlm
from repro_torch.core import runtime as trt
from repro_torch.core import store as tstore
from repro_torch.core import updates as tupd
from repro_torch.core.knobs import Knobs
from repro_torch.server import session as tsession

E = 16
KW = dict(server_capacity=32, client_capacity=32,
          max_object_points_server=32, max_object_points_client=16,
          min_obs_before_sync=1)
CLOSE = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stores(n=12, seed=0):
    args = (n, KW["server_capacity"], E, KW["max_object_points_server"])
    return (jstore.synthetic_store(*args, seed=seed, n_labels=6),
            tstore.synthetic_store(*args, seed=seed, n_labels=6,
                                   device="cpu"))


def _bump(jst, tst, slots):
    """Version bump (a modified object) on both stores."""
    s = np.asarray(slots, np.int64)
    tst.version[torch.from_numpy(s)] += 1
    return jst._replace(version=jst.version.at[jnp.asarray(s)].add(1)), tst


def _framed_packets(n_ticks=6, C=2):
    """``n_ticks`` framed (proto) packets for client 0 from each package's
    SessionManager over the same store, a few objects bumped per tick."""
    jst, tst = _stores()
    kw = dict(n_clients=C, capacity=KW["server_capacity"], budget=4,
              proto=True)
    a = jsession.SessionManager(knobs=JKnobs(**KW), **kw)
    b = tsession.SessionManager(knobs=Knobs(**KW), device="cpu", **kw)
    out_j, out_t = [], []
    rng = np.random.default_rng(5)
    epoch = np.array([3] * C, np.int64)
    for t in range(n_ticks):
        pa = a.collect(jst, zone=1, epoch=epoch, now=t)
        pb = b.collect(tst, zone=1, epoch=epoch, now=t)
        out_j.append(pa.packet_for(0))
        out_t.append(pb.packet_for(0))
        jst, tst = _bump(jst, tst, rng.choice(12, 2, replace=False))
    return out_j, out_t


def _same_packet(pj, pt):
    assert (pt.count, pt.nbytes, pt.tick, pt.zone, pt.seq, pt.epoch,
            pt.fresh, pt.checksum) == (pj.count, pj.nbytes, pj.tick, pj.zone,
                                       pj.seq, pj.epoch, pj.fresh,
                                       pj.checksum)
    assert pt.compute_checksum() == pj.compute_checksum()


def _same_map(jm, tm):
    for f in ("ids", "active", "label", "n_points", "version"):
        np.testing.assert_array_equal(_np(getattr(tm, f)),
                                      _np(getattr(jm, f)), err_msg=f)
    np.testing.assert_array_equal(_np(tm.points).view(np.int16),
                                  _np(jm.points).view(np.int16))
    for f in ("embed", "centroid", "priority"):
        np.testing.assert_allclose(_np(getattr(tm, f)),
                                   _np(getattr(jm, f)), err_msg=f, **CLOSE)


def _same_session(sj, st):
    for f in ("down_bytes", "up_bytes", "delivered", "delayed", "lost",
              "dup_drops", "corrupt_drops", "stale_drops", "resyncs",
              "epoch"):
        assert getattr(st, f) == getattr(sj, f), f
    assert st._expect == sj._expect
    assert st._backoff == sj._backoff
    assert st._gap_since == sj._gap_since
    assert {z: sorted(b) for z, b in st._reorder.items()} \
        == {z: sorted(b) for z, b in sj._reorder.items()}
    assert [a for a, _ in st.pending] == [a for a, _ in sj.pending]
    _same_map(sj.dev.local, st.dev.local)


def _sessions(faults=None, **kw):
    j = jrt.ClientSession(dev=jrt.DeviceClient(knobs=JKnobs(**KW),
                                               embed_dim=E),
                          net=jrt.NetworkModel(), knobs=JKnobs(**KW),
                          faults=None if faults is None
                          else jrt.FaultModel(**faults), **kw)
    t = trt.ClientSession(dev=trt.DeviceClient(knobs=Knobs(**KW),
                                               embed_dim=E, device="cpu"),
                          net=trt.NetworkModel(), knobs=Knobs(**KW),
                          faults=None if faults is None
                          else trt.FaultModel(**faults), **kw)
    return j, t


# ------------------------------------------------------------ framing
def test_protocol_constants_checksum_and_aos_view():
    assert (tupd.PROTO_HEADER_NBYTES, tupd.ACK_NBYTES, tupd.RESYNC_NBYTES,
            tupd.TOMBSTONE_NBYTES) == (jupd.PROTO_HEADER_NBYTES,
                                       jupd.ACK_NBYTES, jupd.RESYNC_NBYTES,
                                       jupd.TOMBSTONE_NBYTES)
    pj, pt = _framed_packets(2)
    for a, b in zip(pj, pt):
        _same_packet(a, b)
        assert b.checksum is not None and b.checksum_ok()
        bad = dataclasses.replace(b, checksum=b.checksum ^ 0x5A5A5A5A)
        assert not bad.checksum_ok()
        assert dataclasses.replace(b, checksum=None).checksum_ok()
        assert len(b.updates) == len(a.updates) == b.count
        for uj, ut in zip(a.updates, b.updates):
            for f in ("oid", "label", "n_points", "version", "deleted"):
                assert int(_np(getattr(ut, f))) == int(
                    _np(getattr(uj, f))), f
            np.testing.assert_array_equal(_np(ut.points), _np(uj.points))
            np.testing.assert_allclose(_np(ut.centroid), _np(uj.centroid),
                                       **CLOSE)
    empty = tupd.UpdatePacket(batch=None, count=0, nbytes=0, tick=0)
    assert empty.updates == [] and empty.checksum_ok()


def test_fault_model_draws_bit_identical():
    jf = jrt.FaultModel(seed=7, loss_prob=0.3)
    tf = trt.FaultModel(seed=7, loss_prob=0.3)
    for cid, zone, epoch, seq in [(0, 0, 0, 0), (3, 1, -1, 5),
                                  (15, 3, 4, 1 << 20), (2, 0, 9, 77)]:
        np.testing.assert_array_equal(tf.packet_draws(cid, zone, epoch, seq),
                                      jf.packet_draws(cid, zone, epoch, seq))
    got = [tf.uplink_lost(t, c, k, a, b) for t in (0, 1) for c in range(3)
           for k in range(4) for a in range(2) for b in (0, 9)]
    want = [jf.uplink_lost(t, c, k, a, b) for t in (0, 1) for c in range(3)
            for k in range(4) for a in range(2) for b in (0, 9)]
    assert got == want and any(got) and not all(got)
    assert not trt.FaultModel(seed=7).uplink_lost(0, 0, 0, 0, 0)


# ------------------------------------------------------------ ClientSession
def test_client_session_clean_link_matches_reference():
    pj, pt = _framed_packets(6)
    sj, st = _sessions()
    for t, (a, b) in enumerate(zip(pj, pt)):
        _same_packet(a, b)
        assert st.step(float(t), b) == sj.step(float(t), a)
        assert st.drain_acks() == sj.drain_acks()
        assert st.drain_ctrl() == sj.drain_ctrl() == []
    _same_session(sj, st)
    assert st.delivered == 6 and st.up_bytes == 0


def test_client_session_scripted_faults_and_resync_backoff():
    """A scripted receive order: in order, a gap (reordered arrival), a
    duplicate held in the buffer, the gap filled (drain of the run), a
    corrupted copy, a stale duplicate (re-ack), then a loss that no later
    packet fills: resync requests at the doubled and capped timeouts."""
    pj, pt = _framed_packets(6)
    faults = dict(seed=1, resync_timeout_s=1.0, resync_backoff_cap_s=4.0)
    sj, st = _sessions(faults=faults, dt=1.0)

    def corrupt(p):
        return dataclasses.replace(p, checksum=p.checksum ^ 0x5A5A5A5A)
    script = [(0.0, 0), (1.0, 2), (1.5, 2), (2.0, 1), (3.0, "c3"), (3.5, 3),
              (3.7, 1), (4.0, 5)]
    for t, which in script:
        if which == "c3":
            a, b = corrupt(pj[3]), corrupt(pt[3])
        else:
            a, b = pj[which], pt[which]
        sj._receive(t, a)
        st._receive(t, b)
        assert st.drain_acks() == sj.drain_acks()
        _same_session(sj, st)
    assert st.corrupt_drops == 1 and st.dup_drops == 2
    assert st._expect == {1: 4} and sorted(st._reorder[1]) == [5]
    times = []
    for t in np.arange(4.0, 20.0, 0.5):
        sj._check_gaps(float(t))
        st._check_gaps(float(t))
        cj, ct = sj.drain_ctrl(), st.drain_ctrl()
        assert ct == cj
        if ct:
            times.append(float(t))
        _same_session(sj, st)
    # timeouts 1, 2, 4, then capped at 4
    assert times == [5.0, 7.0, 11.0, 15.0, 19.0], times
    assert st.resyncs == 5 and st.up_bytes == sj.up_bytes > 0


@pytest.mark.parametrize("faults", [
    dict(seed=3, loss_prob=0.35),
    dict(seed=2, dup_prob=0.6),
    dict(seed=3, reorder_prob=0.6, reorder_jitter_s=2.5),
    dict(seed=4, corrupt_prob=0.4),
    dict(seed=2, loss_prob=0.15, dup_prob=0.2, reorder_prob=0.25,
         corrupt_prob=0.1)], ids=["loss", "dup", "reorder", "corrupt",
                                  "everything"])
def test_client_session_fault_transport_matches_reference(faults):
    """The seeded fault transport through ``step``: the same packets lost,
    duplicated, delayed and corrupted, the same acks, resyncs, counters and
    local map at every tick."""
    pj, pt = _framed_packets(6)
    sj, st = _sessions(faults=faults, dt=1.0, cid=4)
    for t in range(12):
        a = pj[t] if t < 6 else None
        b = pt[t] if t < 6 else None
        assert st.step(float(t), b) == sj.step(float(t), a)
        assert st.drain_acks() == sj.drain_acks()
        assert st.drain_ctrl() == sj.drain_ctrl()
        _same_session(sj, st)
    assert st.lost + st.dup_drops + st.corrupt_drops + st.delayed > 0


def test_client_session_epoch_adoption_crash_and_prune():
    """A fresh epoch resets the map; a crash forgets the protocol position;
    prune_zones drops entries outside the subscription."""
    from repro.server.zones import ZoneGrid as JGrid
    from repro_torch.server.zones import ZoneGrid as TGrid
    pj, pt = _framed_packets(3)
    sj, st = _sessions()
    for a, b in zip(pj, pt):
        sj._receive(0.0, a)
        st._receive(0.0, b)
    _same_session(sj, st)
    sub = np.array([True, False])
    assert st.prune_zones(TGrid.for_room(8.0, 2, 1), sub) \
        == sj.prune_zones(JGrid.for_room(8.0, 2, 1), sub)
    _same_session(sj, st)
    fresh_j = dataclasses.replace(pj[0], epoch=9, fresh=True, seq=0)
    fresh_j.checksum = fresh_j.compute_checksum()
    fresh_t = dataclasses.replace(pt[0], epoch=9, fresh=True, seq=0)
    fresh_t.checksum = fresh_t.compute_checksum()
    sj._receive(1.0, fresh_j)
    st._receive(1.0, fresh_t)
    _same_session(sj, st)
    assert st.epoch == 9
    sj.crash()
    st.crash()
    _same_session(sj, st)
    assert st.epoch == -1 and not bool(st.dev.local.active.any())


# ------------------------------------- tests/test_network_model.py's cases
def _one_object_pair():
    """The reference test's one-object store as two v1 / v2 packets."""
    kn_j, kn_t = JKnobs(**KW), Knobs(**KW)
    js = jstore.init_store(32, 8, 32)
    js = js._replace(ids=js.ids.at[0].set(7),
                     active=js.active.at[0].set(True),
                     embed=js.embed.at[0].set(jnp.ones(8) / np.sqrt(8.0)),
                     n_points=js.n_points.at[0].set(4),
                     obs_count=js.obs_count.at[0].set(3),
                     version=js.version.at[0].set(1))
    ts = tstore.init_store(32, 8, 32, device="cpu")
    ts.ids[0], ts.active[0] = 7, True
    ts.embed[0] = torch.ones(8) / np.sqrt(8.0)
    ts.n_points[0], ts.obs_count[0], ts.version[0] = 4, 3, 1
    pj1, sync_j = jupd.collect_updates(js, jupd.init_sync(32), kn_j, tick=0)
    pt1, sync_t = tupd.collect_updates(ts, tupd.init_sync(32), kn_t, tick=0)
    js = js._replace(version=js.version.at[0].set(2))
    ts.version[0] = 2
    pj2, _ = jupd.collect_updates(js, sync_j, kn_j, tick=1)
    pt2, _ = tupd.collect_updates(ts, sync_t, kn_t, tick=1)
    return (pj1, pj2), (pt1, pt2)


def _net(pkg, nbytes, **kw):
    base = dict(rtt_ms=0.0, bandwidth_mbps=nbytes * 8 / 1e6,
                outages=((4.0, 8.0),))
    base.update(kw)
    return pkg.NetworkModel(**base)


def _dev_sessions(nbytes, **net_kw):
    j = jrt.ClientSession(dev=jrt.DeviceClient(knobs=JKnobs(**KW),
                                               embed_dim=8),
                          net=_net(jrt, nbytes, **net_kw),
                          knobs=JKnobs(**KW), dt=1.0)
    t = trt.ClientSession(dev=trt.DeviceClient(knobs=Knobs(**KW),
                                               embed_dim=8, device="cpu"),
                          net=_net(trt, nbytes, **net_kw),
                          knobs=Knobs(**KW), dt=1.0)
    return j, t


def test_client_session_delivery_is_fifo_per_link():
    (pj1, pj2), (pt1, pt2) = _one_object_pair()
    assert pt1.nbytes == pj1.nbytes and pt2.nbytes == pj2.nbytes
    sj, st = _dev_sessions(pj1.nbytes)
    for t, a, b in ((3.5, pj1, pt1), (8.0, pj2, pt2)):
        sj.step(t, a)
        st.step(t, b)
        _same_session(sj, st)
    assert st.delivered == 0 and len(st.pending) == 2
    sj.step(12.0)
    st.step(12.0)
    _same_session(sj, st)
    assert st.delivered == 2 and int(st.dev.local.version[0]) == 2


def test_client_session_defers_straddled_packet():
    (pj1, _), (pt1, _) = _one_object_pair()
    sj, st = _dev_sessions(pj1.nbytes)
    for t, a, b in ((3.5, pj1, pt1), (5.0, None, None), (9.0, None, None)):
        sj.step(t, a)
        st.step(t, b)
        _same_session(sj, st)
        if t == 3.5:
            assert st.delayed == 1 and st.down_bytes == 0
    assert st.down_bytes == pt1.nbytes
    assert int(st.dev.local.active.sum()) == 1


def test_client_session_retransmit_walks_adjacent_outages():
    sj, st = _dev_sessions(1000, rtt_ms=100.0, bandwidth_mbps=0.008,
                           outages=((4.0, 8.0), (8.0, 10.0)))

    class _Pkt:            # stand-in with the UpdatePacket delivery fields
        count, nbytes, batch, tick = 1, 100, None, 0
    sj.step(5.0, _Pkt())
    st.step(5.0, _Pkt())
    assert st.delayed == 1 and st.pending[0][0] >= 10.0
    assert [a for a, _ in st.pending] == [a for a, _ in sj.pending]


# ----------------------------------------- apply_update, depth, autotune
def test_apply_update_matches_reference():
    """The single-row apply through admission, update, eviction (map full)
    and a tombstone."""
    kn_j = JKnobs(**dict(KW, client_capacity=4))
    kn_t = Knobs(**dict(KW, client_capacity=4))
    jm, tm = jlm.init_local_map(kn_j, E), tlm.init_local_map(kn_t, E,
                                                             device="cpu")
    rng = np.random.default_rng(0)
    for i in range(9):
        oid = [1, 2, 3, 4, 2, 5, 6, 3, 1][i]
        pts = rng.normal(size=(16, 3)).astype(np.float16)
        emb = rng.normal(size=(E,)).astype(np.float32)
        cen = rng.normal(size=(3,)).astype(np.float32)
        dele = i == 7
        row = dict(oid=np.int32(oid), embed=emb, label=np.int32(i % 3),
                   points=pts, n_points=np.int32(5 + i),
                   centroid=cen, version=np.int32(1 + i // 4),
                   deleted=np.bool_(dele))
        pri = np.float32(rng.random())
        jm = jlm.apply_update(jm, jlm.ObjectUpdate(
            **{k: jnp.asarray(v) for k, v in row.items()}), jnp.asarray(pri))
        tm = tlm.apply_update(tm, tlm.ObjectUpdate(
            **{k: torch.from_numpy(np.array(v)) for k, v in row.items()}),
            torch.tensor(pri))
        _same_map(jm, tm)
    assert int(tm.active.sum()) == 4 - 1


@pytest.mark.parametrize("ratio", [1, 2, 5])
def test_downsample_mask_and_mapping_gate_mask(ratio):
    rng = np.random.default_rng(ratio)
    mask = np.zeros((60, 80), bool)
    y0, x0 = rng.integers(0, 40, 2)
    mask[y0:y0 + 9, x0:x0 + 17] = True
    np.testing.assert_array_equal(
        _np(tdepth.downsample_mask(torch.from_numpy(mask), ratio)),
        _np(jdepth.downsample_mask(jnp.asarray(mask), ratio)))
    for area in (10.0, 20000.0, 60000.0):
        kj = JKnobs(depth_downsampling_ratio=ratio,
                    min_mapping_bbox_area=area)
        kt = Knobs(depth_downsampling_ratio=ratio, min_mapping_bbox_area=area)
        for m in (mask, np.zeros_like(mask)):
            assert bool(tdepth.mapping_gate_mask(torch.from_numpy(m), kt)) \
                == bool(jdepth.mapping_gate_mask(jnp.asarray(m), kj))


def test_autotune_upstream_budget_met_quality_first():
    kn, kj = Knobs(), JKnobs()
    for budget in (30.0, 10.0, 5.0, 2.5):
        tuned = tautotune.tune_upstream(kn, budget_mbps=budget)
        assert tuned.depth_downsampling_ratio == jautotune.tune_upstream(
            kj, budget_mbps=budget).depth_downsampling_ratio
        assert tdepth.upstream_mbps(720, 1280, tuned) <= budget + 1e-6
        r = tuned.depth_downsampling_ratio
        if r > 1:
            finer = dataclasses.replace(tuned, depth_downsampling_ratio=r - 1)
            assert tdepth.upstream_mbps(720, 1280, finer) > budget


def test_autotune_upstream_monotone_in_budget():
    rs = [tautotune.tune_upstream(Knobs(), budget_mbps=b)
          .depth_downsampling_ratio for b in (30.0, 10.0, 5.0, 2.5)]
    assert rs == sorted(rs)


def test_autotune_downstream_backs_off_and_recovers():
    kn = Knobs(local_map_update_frequency=2)
    kj = JKnobs(local_map_update_frequency=2)
    t = tautotune.DownstreamTuner(budget_bytes_per_s=10_000)
    tj = jautotune.DownstreamTuner(budget_bytes_per_s=10_000)
    for nbytes in [50_000] * 4 + [100] * 10:
        kn = t.observe(kn, packet_bytes=nbytes)
        kj = tj.observe(kj, packet_bytes=nbytes)
        assert kn.local_map_update_frequency == kj.local_map_update_frequency
    assert kn.local_map_update_frequency <= 2
