"""The port's fleet tier (``repro_torch.server``: SessionManager, zones,
mesh tier, FleetServer; the zone-sharded query path) against the JAX
reference, at small sizes on the CPU.

The cases of ``tests/test_fleet.py`` and the fleet case of
``tests/test_tombstones.py`` run through both packages from the same
numpy-seeded stores, plus the traps of the port: top-k ties in the collect
(tied tombstones, equal-distance objects), ``ever_sent`` across a rollback,
a caller's reused sync tensor, the overlapped tick, mesh tiers of 3 and 4
parts, and the hardened protocol's clean / faulty twins.  The zone-sharded
query path is in tests/test_torch_fleet_query.py.

Packets: counts, bytes, sequence numbers, epochs, crc32, ids, labels,
versions, point counts and the f16 points exactly; centroids within 1e-5
(the port sums a row's points in another order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import runtime as jrt
from repro.core import store as jstore
from repro.core.knobs import Knobs as JKnobs
from repro.core.local_map import compute_priority as j_priority
from repro.distributed.sharding import client_shard_affinity as j_affinity
from repro import server as jserver

from repro_torch import convert
from repro_torch.core import runtime as trt
from repro_torch.core import store as tstore
from repro_torch.core import updates as tupd
from repro_torch.core.knobs import Knobs
from repro_torch.core.local_map import compute_priority as t_priority
from repro_torch.distributed.sharding import (client_shard_affinity,
                                              zone_shard_devices)
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


def synth(n, *, cap=64, P=64, seed=0, x_range=(-4, 4)):
    kw = dict(seed=seed, n_labels=10, centroid_low=(x_range[0], 0.0, -4.0),
              centroid_high=(x_range[1], 2.0, 4.0))
    return (jstore.synthetic_store(n, cap, E, P, **kw),
            tstore.synthetic_store(n, cap, E, P, device="cpu", **kw))


def bump(pair, slots):
    """Version advance on both stores (the port writes in place)."""
    jst, tst = pair
    s = np.asarray(slots, np.int64)
    tst.version[torch.from_numpy(s)] += 1
    return jst._replace(version=jst.version.at[jnp.asarray(s)].add(1)), tst


def same_batch(a, b):
    """A reference FleetBatch / UpdateBatch against the port's."""
    for f in ("oid", "label", "n_points", "version", "valid", "deleted",
              "embed"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None and y is None:
            continue
        np.testing.assert_array_equal(_np(y), _np(x), err_msg=f)
    np.testing.assert_array_equal(_np(b.points).view(np.int16),
                                  _np(a.points).view(np.int16))
    np.testing.assert_allclose(_np(b.centroid), _np(a.centroid), **CLOSE)


def same_fleet_packet(pa, pb):
    for f in ("counts", "nbytes", "seqs", "epoch", "fresh"):
        np.testing.assert_array_equal(getattr(pb, f), getattr(pa, f),
                                      err_msg=f)
    assert (pb.tick, pb.zone, pb.proto) == (pa.tick, pa.zone, pa.proto)
    np.testing.assert_array_equal(pb.tomb_counts(), pa.tomb_counts())
    for c in range(len(pa.counts)):
        ua, ub = pa.packet_for(c), pb.packet_for(c)
        assert (ub.count, ub.nbytes, ub.tick, ub.zone, ub.seq, ub.epoch,
                ub.fresh, ub.checksum) == (ua.count, ua.nbytes, ua.tick,
                                           ua.zone, ua.seq, ua.epoch,
                                           ua.fresh, ua.checksum)
        if ua.count:
            same_batch(ua.batch, ub.batch)


def same_ticks(pka, pkb):
    assert [z for z, _ in pkb] == [z for z, _ in pka]
    for (_, a), (_, b) in zip(pka, pkb):
        same_fleet_packet(a, b)


def sessions(C, **kw):
    return (jserver.SessionManager(knobs=JKN, n_clients=C, **kw),
            tserver.SessionManager(knobs=KN, n_clients=C, device="cpu",
                                   **kw))


def grids(*a, **kw):
    return jserver.ZoneGrid.for_room(*a, **kw), \
        tserver.ZoneGrid.for_room(*a, **kw)


def local_ids(m):
    a = _np(m.active)
    return dict(zip(_np(m.ids)[a].tolist(), _np(m.version)[a].tolist()))


# ---------------------------------------------------------------------------
def test_fleet_collect_matches_reference_and_single_client():
    """One batched collect for C clients equals the reference's, row for
    row, and each client's packet carries the objects (and bytes) of the
    port's own single-client collect_updates."""
    jst, tst = synth(30)
    C, budget = 5, 16
    poses = np.random.default_rng(1).uniform(-3, 3, (C, 3)).astype(
        np.float32)
    a, b = sessions(C, capacity=64, budget=budget, user_pos=poses.copy())
    synced = np.zeros((C, 64), np.int32)
    for c in range(C):
        synced[c, c:c + 5] = 1
    a.sync = a.sync._replace(synced_version=jnp.asarray(synced))
    convert.load_session_state(b, {"synced_version": synced})
    pa, pb = a.collect(jst), b.collect(tst)
    same_fleet_packet(pa, pb)
    for c in range(C):
        pri = t_priority(tst.embed, tst.label, tst.centroid,
                         user_pos=torch.from_numpy(poses[c]), knobs=KN)
        np.testing.assert_allclose(_np(pri), _np(j_priority(
            jst.embed, jst.label, jst.centroid,
            user_pos=jnp.asarray(poses[c]), knobs=JKN)), **CLOSE)
        single, _ = tupd.collect_updates(
            tst, tupd.init_sync(64)._replace(synced_version=synced[c].copy()),
            KN, tick=0, priorities=_np(pri), max_updates=budget)
        assert single.nbytes == int(pb.nbytes[c])
        assert single.count == int(pb.counts[c])
        assert {int(u.oid) for u in single.updates} == set(
            _np(pb.batch.oid[c])[:pb.counts[c]].tolist())
    # budget-limited catch-up drains, then the fleet quiesces
    for _ in range(5):
        same_fleet_packet(a.collect(jst), b.collect(tst))
    assert (b.collect(tst).nbytes == 0).all()


def test_fleet_collect_honors_class_point_overrides():
    kw = dict(KW, class_point_overrides=((0, 4), (1, 8), (2, 999)))
    jst, tst = synth(24, seed=13)
    poses = np.random.default_rng(2).uniform(-3, 3, (3, 3)).astype(
        np.float32)
    a = jserver.SessionManager(knobs=JKnobs(**kw), n_clients=3, capacity=64,
                               budget=64, user_pos=poses.copy())
    b = tserver.SessionManager(knobs=Knobs(**kw), n_clients=3, capacity=64,
                               budget=64, user_pos=poses.copy(), **CPU)
    pa, pb = a.collect(jst), b.collect(tst)
    same_fleet_packet(pa, pb)
    assert (pb.counts == 24).all()
    npts = _np(pb.batch.n_points)
    lab = _np(tst.label)[_np(pb.batch.oid) - 1]
    assert (npts[lab == 0] <= 4).all() and (npts[lab == 1] <= 8).all()


def test_fleet_sync_advances_only_when_deliverable():
    jst, tst = synth(10)
    a, b = sessions(2, capacity=64, budget=16)
    deliv = np.array([True, False])
    same_fleet_packet(a.collect(jst, deliverable=deliv),
                      b.collect(tst, deliverable=deliv))
    jst, tst = bump((jst, tst), [0, 1])
    pa = a.collect(jst, deliverable=np.array([True, True]))
    pb = b.collect(tst, deliverable=np.array([True, True]))
    same_fleet_packet(pa, pb)
    assert pb.counts.tolist() == [2, 10]


def test_collect_budget_cuts_through_tied_tombstones_and_equal_distances():
    """Ties are the normal case of the collect's top-k: every tombstone
    scores exactly 1e30, and objects at one distance from the pose tie on
    a proximity-only priority.  A budget that cuts through both runs must
    keep the lower slots first, as ``lax.top_k`` does."""
    jst, tst = synth(40)
    ring = np.zeros((40, 3), np.float32)
    ang = np.linspace(0, 2 * np.pi, 40, endpoint=False)
    ring[:, 0], ring[:, 2] = 2.0 * np.cos(ang), 2.0 * np.sin(ang)
    ring[:, 1] = 1.0
    ring[::2] = ring[0]               # half the objects on one point
    jst = jst._replace(centroid=jst.centroid.at[:40].set(jnp.asarray(ring)))
    tst.centroid[:40] = torch.from_numpy(ring)
    a, b = sessions(3, capacity=64, budget=6,
                    user_pos=np.zeros((3, 3), np.float32))
    for _ in range(3):                # ship part of the map
        same_fleet_packet(a.collect(jst), b.collect(tst))
    gone = list(range(1, 40, 3))      # 13 tombstones, all tied at 1e30
    jst = jstore.remove_objects(jst, gone)
    tstore.remove_objects(tst, gone)
    for _ in range(8):
        pa, pb = a.collect(jst), b.collect(tst)
        same_fleet_packet(pa, pb)
        # the ever-shipped tombstones lead, lowest slot first
        t = _np(pb.batch.deleted[0]) & _np(pb.batch.valid[0])
        oids = _np(pb.batch.oid[0])
        assert (np.diff(oids[t]) > 0).all()
    assert (pb.counts == 0).all()


def test_ever_sent_survives_rollback_and_gates_tombstones():
    """A rollback drops sync to the acked vector but keeps ever_sent: the
    un-acked rows re-ship, and a later deletion still reaches the client
    whose ack was lost; a client that never held the object gets no
    tombstone."""
    jst, tst = synth(8)
    a, b = sessions(2, capacity=64, budget=16,
                    subscribed=np.array([True, False]))
    same_fleet_packet(a.collect(jst), b.collect(tst))
    for s in (a, b):
        s.rollback(0)                 # the client's ack never arrived
        s.set_client(1, subscribed=True)
    np.testing.assert_array_equal(b.ever_sent, a.ever_sent)
    assert b.ever_sent[0, :8].all() and not b.ever_sent[1].any()
    jst = jstore.remove_objects(jst, [3])
    tstore.remove_objects(tst, [3])
    pa, pb = a.collect(jst), b.collect(tst)
    same_fleet_packet(pa, pb)
    assert pb.tomb_counts().tolist() == [1, 0]
    assert pb.counts.tolist() == [8, 7]   # re-ship + tombstone; catch-up
    np.testing.assert_array_equal(_np(b.sync.ever_sent),
                                  _np(a.sync.ever_sent))
    np.testing.assert_array_equal(_np(b.sync.synced_version),
                                  _np(a.sync.synced_version))


def test_collect_never_writes_the_callers_sync_tensor():
    """benchmarks/fleet_scale.py resets ``sm.sync`` from one saved
    ``fresh`` array every rep: a collect that advanced it in place would
    make every later rep an empty tick."""
    _, tst = synth(24)
    sm = tserver.SessionManager(knobs=KN, n_clients=4, capacity=64,
                                budget=8, **CPU)
    fresh = torch.zeros((4, 64), dtype=torch.int32)
    ever = torch.zeros((4, 64), dtype=torch.bool)
    got = []
    for _ in range(3):
        sm.sync = tserver.FleetSync(fresh, ever)
        got.append(sm.collect(tst).nbytes.tolist())
        sm.reset_slots([0])
        sm.rollback(1)
        sm.reset_client(2)
    assert got[0] == got[1] == got[2] and sum(got[0]) > 0
    assert not fresh.any() and not ever.any()


def test_zone_isolation_exact_bytes():
    gj, gt = grids(8.0, nx=2, nz=1)
    jst, tst = synth(20, seed=3)
    fa = jserver.FleetServer(knobs=JKN, embed_dim=E, n_clients=2, grid=gj,
                             budget=32)
    fb = tserver.FleetServer(knobs=KN, embed_dim=E, n_clients=2, grid=gt,
                             budget=32, **CPU)
    for fs, st in ((fa, jst), (fb, tst)):
        fs.refresh(st)
        fs.join(0, np.array([-2.0, 1.5, 0.0]), 1.0)
        fs.join(1, np.array([2.0, 1.5, 0.0]), 1.0)
    both = np.array([True, True])
    same_ticks(fa.tick(both), fb.tick(both))
    cents = _np(tst.centroid)
    z1 = np.nonzero(_np(tst.active) & (cents[:, 0] >= 0))[0]
    jst, tst = bump((jst, tst), z1)
    fa.refresh(jst)
    fb.refresh(tst)
    pka, pkb = fa.tick(both), fb.tick(both)
    same_ticks(pka, pkb)
    per = fb.per_client_nbytes(pkb)
    assert per[0] == 0
    n_pts = _np(tst.n_points)[z1]
    assert per[1] == sum(tupd.update_nbytes(E, min(int(n), 16))
                         for n in n_pts)


def test_zone_slot_reuse_resets_sync():
    g = dict(origin=(-4.0, -4.0), zone_size=8.0, nx=1, nz=1)
    jst, tst = synth(3, seed=5)
    za = jserver.ZoneShardedStore(knobs=JKN, embed_dim=E,
                                  grid=jserver.ZoneGrid(**g),
                                  zone_capacity=4)
    zb = tserver.ZoneShardedStore(knobs=KN, embed_dim=E,
                                  grid=tserver.ZoneGrid(**g),
                                  zone_capacity=4, **CPU)
    fa = jserver.FleetServer(knobs=JKN, embed_dim=E, n_clients=1,
                             grid=za.grid, budget=8, zoned=za)
    fb = tserver.FleetServer(knobs=KN, embed_dim=E, n_clients=1,
                             grid=zb.grid, budget=8, zoned=zb, **CPU)
    for fs, st in ((fa, jst), (fb, tst)):
        fs.refresh(st)
        fs.join(0, np.zeros(3), 1.0)
    same_ticks(fa.tick(np.array([True])), fb.tick(np.array([True])))
    jst = jst._replace(active=jst.active.at[0].set(False))
    tst.active[0] = False
    fa.refresh(jst)
    fb.refresh(tst)
    jst = jst._replace(active=jst.active.at[0].set(True),
                       ids=jst.ids.at[0].set(99),
                       version=jst.version.at[0].set(1))
    tst.active[0], tst.ids[0], tst.version[0] = True, 99, 1
    fa.refresh(jst)
    fb.refresh(tst)
    pka, pkb = fa.tick(np.array([True])), fb.tick(np.array([True]))
    same_ticks(pka, pkb)
    oids = {int(u.oid) for _, p in pkb for u in p.packet_for(0).updates}
    assert 99 in oids


def test_quiesced_zones_skip_collect():
    gj, gt = grids(8.0, nx=2, nz=1)
    jst, tst = synth(12, seed=9)
    fa = jserver.FleetServer(knobs=JKN, embed_dim=E, n_clients=2, grid=gj,
                             budget=32)
    fb = tserver.FleetServer(knobs=KN, embed_dim=E, n_clients=2, grid=gt,
                             budget=32, **CPU)
    for fs, st in ((fa, jst), (fb, tst)):
        fs.refresh(st)
        fs.join(0, np.array([-2.0, 1.5, 0.0]), 1.0)
        fs.join(1, np.array([2.0, 1.5, 0.0]), 1.0)
    both = np.array([True, True])
    seen = []
    for step in range(7):
        if step == 3:
            cents = _np(tst.centroid)
            z1 = np.nonzero(_np(tst.active) & (cents[:, 0] >= 0))[0]
            jst, tst = bump((jst, tst), z1[:1])
            fa.refresh(jst)
            fb.refresh(tst)
        deliv = np.array([True, False]) if step == 4 else both
        pka, pkb = fa.tick(deliv), fb.tick(deliv)
        same_ticks(pka, pkb)
        seen.append([z for z, _ in pkb])
    assert seen == [[0, 1], [0, 1], [], [1], [], [1], []]


def test_multi_client_convergence_under_interleaving():
    """Ticks, outages, joins and new objects interleaved at random: both
    packages ship the same packets, and every client ends holding the
    server store restricted to its zones."""
    kw = dict(KW, max_object_points_server=32)
    kn, jkn = Knobs(**kw), JKnobs(**kw)
    gj, gt = grids(8.0, nx=2, nz=1)
    C = 4
    jst, tst = synth(12, P=32, seed=7)
    fa = jserver.FleetServer(knobs=jkn, embed_dim=E, n_clients=C, grid=gj,
                             budget=16)
    fb = tserver.FleetServer(knobs=kn, embed_dim=E, n_clients=C, grid=gt,
                             budget=16, **CPU)
    poses = np.array([[-2.5, 1.5, 0.0], [2.5, 1.5, 0.0],
                      [-1.0, 1.5, 1.0], [1.5, 1.5, -1.0]], np.float32)
    sa = [jrt.ClientSession(dev=jrt.DeviceClient(knobs=jkn, embed_dim=E),
                            net=jrt.NetworkModel(), knobs=jkn,
                            user_pos=jnp.asarray(poses[c]))
          for c in range(C)]
    sb = [trt.ClientSession(dev=trt.DeviceClient(knobs=kn, embed_dim=E,
                                                 **CPU),
                            net=trt.NetworkModel(), knobs=kn,
                            user_pos=torch.from_numpy(poses[c]))
          for c in range(C)]
    joined = np.zeros(C, bool)
    rng = np.random.default_rng(11)

    def run_tick(t, deliverable):
        pka = fa.tick(deliverable & joined)
        pkb = fb.tick(deliverable & joined)
        same_ticks(pka, pkb)
        for c in np.nonzero(joined)[0]:
            for (_, pa), (_, pb) in zip(pka, pkb):
                sa[c].step(t, pa.packet_for(c))
                sb[c].step(t, pb.packet_for(c))
        return sum(p.total_nbytes for _, p in pkb)

    for fs, st in ((fa, jst), (fb, tst)):
        fs.refresh(st)
        fs.join(0, poses[0], 1.2)
    joined[0] = True
    n_next = 12
    for t in range(24):
        ev = rng.random()
        if ev < 0.3:
            slots = rng.choice(np.nonzero(_np(tst.active))[0], size=3,
                               replace=False)
            jst, tst = bump((jst, tst), slots)
        elif ev < 0.5 and n_next < 40:
            s, n_next = n_next, n_next + 1
            emb = rng.normal(size=(E,)).astype(np.float32)
            emb /= np.linalg.norm(emb)
            cen = rng.uniform(-3, 3, 3).astype(np.float32)
            jst = jst._replace(
                ids=jst.ids.at[s].set(s + 1),
                active=jst.active.at[s].set(True),
                embed=jst.embed.at[s].set(emb),
                centroid=jst.centroid.at[s].set(cen),
                n_points=jst.n_points.at[s].set(8),
                obs_count=jst.obs_count.at[s].set(2),
                version=jst.version.at[s].set(1))
            tst.ids[s], tst.active[s] = s + 1, True
            tst.embed[s] = torch.from_numpy(emb)
            tst.centroid[s] = torch.from_numpy(cen)
            tst.n_points[s], tst.obs_count[s], tst.version[s] = 8, 2, 1
        elif ev < 0.7:
            c = int(rng.integers(0, C))
            if not joined[c]:
                fa.join(c, poses[c], 1.2)
                fb.join(c, poses[c], 1.2)
                joined[c] = True
        fa.refresh(jst)
        fb.refresh(tst)
        run_tick(float(t), rng.random(C) > 0.35)
    for c in range(C):
        if not joined[c]:
            fa.join(c, poses[c], 1.2)
            fb.join(c, poses[c], 1.2)
            joined[c] = True
    t = 24.0
    for _ in range(10):
        if run_tick(t, np.ones(C, bool)) == 0:
            break
        t += 1.0
    assert run_tick(t + 1.0, np.ones(C, bool)) == 0
    for c in range(C):
        got = local_ids(sb[c].dev.local)
        assert got == local_ids(sa[c].dev.local) and got


def test_ack_tick_parity_with_per_client_acks():
    gj, gt = grids(8.0, 2, 1)

    def build(pkg, grid, kn, **kw):
        srv = pkg.FleetServer(knobs=kn, embed_dim=E, n_clients=4,
                              grid=grid, budget=8, **kw)
        rng = np.random.default_rng(3)
        for c in range(4):
            srv.join(c, rng.uniform(-3, 3, size=3).astype(np.float32), 6.0)
        return srv

    jst, tst = synth(24)
    a, b = build(tserver, gt, KN, **CPU), build(tserver, gt, KN, **CPU)
    r = build(jserver, gj, JKN)
    a.refresh(tst), b.refresh(tst), r.refresh(jst)
    deliverable = np.ones((4,), bool)
    for t in range(3):
        pk_a, pk_b = a.tick(deliverable, tick=t), b.tick(deliverable, tick=t)
        pk_r = r.tick(deliverable, tick=t)
        same_ticks(pk_r, pk_a)
        a.ack_tick(pk_a, tick=t)
        r.ack_tick(pk_r, tick=t)
        for z, pkt in pk_b:
            for c in np.nonzero(pkt.seqs >= 0)[0]:
                b.ack(int(c), int(z), int(pkt.epoch[c]), int(pkt.seqs[c]),
                      tick=t)
    for sa, sb, sr in zip(a.sessions, b.sessions, r.sessions):
        assert np.array_equal(sa.acked, sb.acked)
        assert np.array_equal(sa.acked, sr.acked)
        assert all(len(q) == 0 for q in sa.inflight + sb.inflight)
    assert np.array_equal(a.epoch_fresh, b.epoch_fresh)
    assert np.array_equal(a.last_ack_tick, b.last_ack_tick)
    assert np.array_equal(a.last_ack_tick, r.last_ack_tick)


# ---------------------------------------------------------------------------
# mesh-sharded session tier
def _tier_acked(tier):
    out = np.zeros((tier.n_clients, tier.capacity), np.int32)
    for s, part in enumerate(tier.parts):
        if part is not None:
            out[tier.roster.members[s]] = part.acked
    return out


@pytest.mark.parametrize("shards", [3, 4])
def test_mesh_tier_byte_identity_vs_unsharded(shards):
    """MeshSessionTier with the client axis split over S parts equals the
    port's unsharded SessionManager bit for bit (every packet tensor, seq
    streams, acked / in-flight / deletion debt) and the reference's mesh
    tier, through acks, a rollback, resets, slot reuse and mutations."""
    C, N = 12, 64
    jst, tst = synth(28, seed=5)
    rng = np.random.default_rng(2)
    poses = rng.uniform(-3, 3, (C, 3)).astype(np.float32)
    subs = rng.random(C) < 0.85
    ref = tserver.SessionManager(knobs=KN, n_clients=C, capacity=N,
                                 budget=8, subscribed=subs.copy(),
                                 user_pos=poses.copy(), **CPU)
    tier = tserver.MeshSessionTier(
        knobs=KN, capacity=N, budget=8,
        roster=tserver.ClientRoster.round_robin(C, shards), **CPU)
    jtier = jserver.MeshSessionTier(
        knobs=JKN, capacity=N, budget=8,
        roster=jserver.ClientRoster.round_robin(C, shards))
    tier.set_all(subscribed=subs, user_pos=poses)
    jtier.set_all(subscribed=subs, user_pos=poses)
    epoch = np.arange(C, dtype=np.int64)
    for t in range(5):
        deliv = rng.random(C) < 0.9
        kw = dict(deliverable=deliv, zone=1, epoch=epoch, now=t)
        pa, pb = ref.collect(tst, **kw), tier.collect(tst, **kw)
        same_fleet_packet(jtier.collect(jst, **kw), pb)
        for f in ("counts", "nbytes", "seqs"):
            np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f))
        for part, members in zip(pb.parts, tier.roster.members):
            m = torch.from_numpy(members)
            for x, y in zip(part.batch, pa.batch):
                assert torch.equal(x, y[m])     # bit for bit
        for c in range(C):
            if int(pa.seqs[c]) >= 0 and rng.random() < 0.6:
                ref.ack(c, int(pa.seqs[c]))
                tier.ack(c, int(pb.seqs[c]))
                jtier.ack(c, int(pb.seqs[c]))
        if t == 1:
            ref.rollback(3), tier.rollback(3), jtier.rollback(3)
        if t == 2:
            for s in (ref, tier, jtier):
                s.reset_client(5, keep_seq=True)
                s.reset_slots([0, 7])
        if t == 3:
            jst, tst = bump((jst, tst), [1, 4, 9])
        assert ref.dirty == tier.dirty == jtier.dirty
        np.testing.assert_array_equal(ref.acked, _tier_acked(tier))
        np.testing.assert_array_equal(_tier_acked(jtier), _tier_acked(tier))
        np.testing.assert_array_equal(ref.deletion_debt(tst),
                                      tier.deletion_debt(tst))
        for c in range(C):
            assert ref.oldest_unacked_tick(c) == tier.oldest_unacked_tick(c)


def test_mesh_fleet_server_end_to_end_byte_identity():
    gj, gt = grids(8.0, 2, 2)

    def build(pkg, grid, kn, shards, **kw):
        srv = pkg.FleetServer(knobs=kn, embed_dim=E, n_clients=6, grid=grid,
                              budget=8, n_session_shards=shards, **kw)
        rng = np.random.default_rng(4)
        for c in range(6):
            srv.join(c, rng.uniform(-3, 3, 3).astype(np.float32), 2.0)
        return srv

    a, b = build(tserver, gt, KN, 1, **CPU), build(tserver, gt, KN, 3, **CPU)
    r = build(jserver, gj, JKN, 3)
    jst, tst = synth(24, cap=a.zoned.zone_capacity)
    rng = np.random.default_rng(9)
    deliverable = np.ones((6,), bool)
    for t in range(4):
        a.refresh(tst), b.refresh(tst), r.refresh(jst)
        poses = rng.uniform(-3.5, 3.5, (6, 3)).astype(np.float32)
        for s in (a, b, r):
            s.set_poses(poses, 2.0)
        np.testing.assert_array_equal(a.subscribed, b.subscribed)
        pa, pb, pr = (s.tick(deliverable, tick=t) for s in (a, b, r))
        same_ticks(pr, pb)
        same_ticks(pa, pb)
        for s, p in ((a, pa), (b, pb), (r, pr)):
            s.ack_tick(p, tick=t)
        jst, tst = bump((jst, tst), [t, t + 3])
    np.testing.assert_array_equal(a.epoch, b.epoch)
    assert a.blocked_tombstone_oids(tick=5) \
        == b.blocked_tombstone_oids(tick=5) \
        == r.blocked_tombstone_oids(tick=5)


def test_overlapped_tick_is_byte_identical_to_sequential():
    gj, gt = grids(8.0, 2, 2)
    fs = [tserver.FleetServer(knobs=KN, embed_dim=E, n_clients=5, grid=gt,
                              budget=8, **CPU) for _ in range(2)]
    _, tst = synth(40)
    rng = np.random.default_rng(6)
    for s in fs:
        s.refresh(tst)
        for c in range(5):
            s.join(c, np.array([c - 2.0, 1.0, 2.0 - c], np.float32), 2.5)
    for t in range(4):
        deliv = rng.random(5) < 0.8
        seq = fs[0].tick(deliv, tick=t)
        ovl = fs[1].tick(deliv, tick=t, overlap=True)
        same_ticks(seq, ovl)
        fs[0].ack_tick(seq, tick=t), fs[1].ack_tick(ovl, tick=t)
        tst.version[t:t + 4] += 1
        for s in fs:
            s.refresh(tst)


def test_client_shard_affinity_and_zone_devices():
    subs = np.zeros((4, 8), bool)
    subs[0, [0, 2, 4]] = True
    subs[1, [1, 3]] = True
    subs[2, [0, 1, 3]] = True
    a = client_shard_affinity(subs, 2)
    assert a.tolist() == [0, 1, 1, 1] == j_affinity(subs, 2).tolist()
    a2 = client_shard_affinity(subs, 2, zone_shards=np.zeros(8, np.int64))
    assert a2.tolist() == [0, 0, 0, 1]
    rnd = np.random.default_rng(0).random((40, 6)) < 0.4
    for S in (2, 3, 4):
        np.testing.assert_array_equal(client_shard_affinity(rnd, S),
                                      j_affinity(rnd, S))
    devs = zone_shard_devices([torch.device("cpu")] * 2, 5)
    assert devs == [torch.device("cpu")] * 5
    roster = tserver.ClientRoster.from_affinity(rnd, 3)
    assert roster.assign.tolist() == jserver.ClientRoster.from_affinity(
        rnd, 3).assign.tolist()


# ---------------------------------------------------------------------------
# zone crossing mid-flight, tombstones across the zone mirror
def test_zone_crossing_midflight_never_applies_stale_row():
    gj, gt = grids(8.0, 2, 1)
    jst, tst = synth(20, x_range=(-4, -1))
    ra = jserver.FleetServer(knobs=JKN, embed_dim=E, n_clients=1, grid=gj,
                             budget=8)
    rb = tserver.FleetServer(knobs=KN, embed_dim=E, n_clients=1, grid=gt,
                             budget=8, **CPU)
    sa = jrt.ClientSession(dev=jrt.DeviceClient(knobs=JKN, embed_dim=E),
                           net=jrt.NetworkModel(bandwidth_mbps=100.0),
                           knobs=JKN, cid=0)
    sb = trt.ClientSession(dev=trt.DeviceClient(knobs=KN, embed_dim=E,
                                                **CPU),
                           net=trt.NetworkModel(bandwidth_mbps=100.0),
                           knobs=KN, cid=0)
    for srv, sess, st in ((ra, sa, jst), (rb, sb, tst)):
        srv.join(0, np.array([-2.0, 1.5, 0.0], np.float32), 1.0)
        srv.refresh(st)
        sess.zone_subs = srv.subscribed[0].copy()
    pka, pkb = ra.tick(np.ones(1, bool), tick=0), rb.tick(np.ones(1, bool),
                                                          tick=0)
    same_ticks(pka, pkb)
    in_air = [p[0][1].packet_for(0) for p in (pka, pkb)]
    for srv, sess, pkt in ((ra, sa, in_air[0]), (rb, sb, in_air[1])):
        srv.set_client_pose(0, np.array([2.0, 1.5, 0.0], np.float32), 1.0)
        sess.zone_subs = srv.subscribed[0].copy()
        sess._receive(0.0, pkt)
    assert sb.stale_drops == sa.stale_drops == 1
    assert sb.drain_acks() == sa.drain_acks() \
        == [(0, int(in_air[1].epoch), int(in_air[1].seq))]
    assert sb.delivered == 0 and sb._expect == sa._expect
    for srv, sess in ((ra, sa), (rb, sb)):
        srv.set_client_pose(0, np.array([-2.0, 1.5, 0.0], np.float32), 1.0)
        sess.zone_subs = srv.subscribed[0].copy()
    pka, pkb = ra.tick(np.ones(1, bool), tick=1), rb.tick(np.ones(1, bool),
                                                          tick=1)
    same_ticks(pka, pkb)
    for (_, pa), (_, pb) in zip(pka, pkb):
        sa._receive(1.0, pa.packet_for(0))
        sb._receive(1.0, pb.packet_for(0))
        assert pb.packet_for(0).seq == in_air[1].seq + 1
    assert sb.resyncs == 0 and not sb._gap_since
    assert local_ids(sb.dev.local) == local_ids(sa.dev.local)
    assert len(local_ids(sb.dev.local)) > 0


def test_zone_gate_off_by_default():
    _, gt = grids(8.0, 2, 1)
    _, tst = synth(12, x_range=(-4, -1))
    srv = tserver.FleetServer(knobs=KN, embed_dim=E, n_clients=1, grid=gt,
                              budget=8, **CPU)
    srv.join(0, np.array([-2.0, 1.5, 0.0], np.float32), 1.0)
    srv.refresh(tst)
    sess = trt.ClientSession(dev=trt.DeviceClient(knobs=KN, embed_dim=E,
                                                  **CPU),
                             net=trt.NetworkModel(), knobs=KN, cid=0)
    assert sess.zone_subs is None
    sess._receive(0.0, srv.tick(np.ones(1, bool), tick=0)[0][1].packet_for(0))
    assert sess.delivered == 1 and sess.stale_drops == 0


def test_fleet_zone_tombstone_propagation():
    """tests/test_tombstones.py's fleet case through both packages: the
    tombstones reach every subscriber at 9 bytes each, the shard slots
    free after the global release, and nothing re-ships."""
    jst, tst = synth(12, seed=3)
    gj, gt = grids(8.0, nx=2, nz=1)
    fa = jserver.FleetServer(knobs=JKN, embed_dim=E, n_clients=2, grid=gj,
                             budget=32)
    fb = tserver.FleetServer(knobs=KN, embed_dim=E, n_clients=2, grid=gt,
                             budget=32, **CPU)
    da = [jrt.DeviceClient(knobs=JKN, embed_dim=E) for _ in range(2)]
    db = [trt.DeviceClient(knobs=KN, embed_dim=E, **CPU) for _ in range(2)]
    for fs, st in ((fa, jst), (fb, tst)):
        fs.refresh(st)
        fs.join(0, np.array([-2.0, 1.5, 0.0]), 10.0)
        fs.join(1, np.array([2.0, 1.5, 0.0]), 10.0)
    both = np.array([True, True])

    def deliver():
        pka, pkb = fa.tick(both), fb.tick(both)
        same_ticks(pka, pkb)
        for (_, pa), (_, pb) in zip(pka, pkb):
            for c in range(2):
                if pb.packet_for(c).count:
                    da[c].ingest(pa.packet_for(c), user_pos=jnp.zeros(3))
                    db[c].ingest(pb.packet_for(c), user_pos=torch.zeros(3))
        return pkb
    for _ in range(3):
        deliver()
    for c in range(2):
        assert set(local_ids(db[c].local)) == set(range(1, 13))
    jst = jstore.remove_objects(jst, [1, 2, 3])
    tstore.remove_objects(tst, [1, 2, 3])
    fa.refresh(jst)
    fb.refresh(tst)
    pkb = deliver()
    assert (fb.per_client_nbytes(pkb) == 3 * tupd.TOMBSTONE_NBYTES).all()
    for c in range(2):
        assert local_ids(db[c].local) == local_ids(da[c].local)
        assert set(local_ids(db[c].local)) == set(range(4, 13))
    for _ in range(4):
        deliver()
    jst = jstore.release_tombstones(jst)
    tstore.release_tombstones(tst)
    fa.refresh(jst)
    fb.refresh(tst)
    pkb = deliver()
    assert all((p.nbytes == 0).all() for _, p in pkb)
    assert sum(int(tstore.deleted_mask(z).sum()) for z in fb.zoned.zones) \
        == 0


# ---------------------------------------------------------------------------
# the hardened protocol end to end: clean / faulty twins, both packages
def _twin_run(pkg, *, n_obj, client_cap, ticks, settle, seed):
    """FleetServer(proto=True) with 4 clean and 4 faulty pose twins, one
    subscribed zone each, through churn and a clean settle; returns the
    packet digests tick by tick, acks, resync requests, counters and maps.
    ``pkg`` is "ref" or "port"; every draw is numpy's, in the same order."""
    ref = pkg == "ref"
    S, R = (jserver, jrt) if ref else (tserver, trt)
    kw = dict(server_capacity=2 * n_obj, client_capacity=client_cap,
              max_object_points_server=16, max_object_points_client=8,
              min_obs_before_sync=2)
    kn = JKnobs(**kw) if ref else Knobs(**kw)
    args = (n_obj, 2 * n_obj, E, 16)
    st = jstore.synthetic_store(*args, seed=seed) if ref else \
        tstore.synthetic_store(*args, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    grid = S.ZoneGrid.for_room(8.0, 2, 2)
    C = 8
    fs = S.FleetServer(knobs=kn, embed_dim=E, n_clients=C, grid=grid,
                       proto=True, **({} if ref else CPU))
    fm = R.FaultModel(seed=seed, loss_prob=0.1, dup_prob=0.05,
                      reorder_prob=0.1, corrupt_prob=0.05)
    cz = np.array([[-2, 1.5, -2], [-2, 1.5, 2], [2, 1.5, -2], [2, 1.5, 2]],
                  np.float32)
    poses = np.concatenate([cz, cz])
    sess = [R.ClientSession(
        dev=R.DeviceClient(knobs=kn, embed_dim=E, **({} if ref else CPU)),
        net=R.NetworkModel(), knobs=kn, cid=c,
        user_pos=jnp.asarray(poses[c]) if ref else torch.from_numpy(
            poses[c]), faults=None if c < 4 else fm) for c in range(C)]
    fs.refresh(st)
    for c in range(C):
        fs.join(c, poses[c], 1.0, tick=0)
    up, clean = np.ones(C, bool), np.arange(C) < 4
    log = []
    for t in range(ticks + settle):
        if t < ticks:
            ids = _np(st.ids)
            gone = ids[rng.choice(np.nonzero(_np(st.active))[0], 3,
                                  replace=False)]
            cand = rng.choice(np.nonzero(_np(st.active))[0], 12,
                              replace=False)
            old = _np(st.centroid)[cand]
            new = old + rng.normal(scale=0.4, size=old.shape).astype(
                np.float32)
            same = grid.zone_of(new) == grid.zone_of(old)
            cand, new = cand[same][:4], new[same][:4]
            if ref:
                st = jstore.remove_objects(st, gone)
                st = st._replace(
                    version=st.version.at[cand].add(1),
                    centroid=st.centroid.at[cand].set(jnp.asarray(new)))
            else:
                tstore.remove_objects(st, gone)
                c_t = torch.from_numpy(cand)
                st.version[c_t] += 1
                st.centroid[c_t] = torch.from_numpy(new)
        elif t == ticks:
            for s in sess[4:]:
                s.faults = None
        fs.refresh(st)
        pk = fs.tick(up, tick=t)
        tick_log = []
        for z, p in pk:
            rows = []
            for c in range(C):
                u = p.packet_for(c)
                rows.append(None if not u.count else (
                    u.seq, u.epoch, u.fresh, u.checksum, u.nbytes,
                    _np(u.batch.oid)[:u.count].tolist(),
                    _np(u.batch.version)[:u.count].tolist(),
                    _np(u.batch.points)[:u.count].view(np.int16).tobytes()))
            tick_log.append((z, rows))
        for c, s in enumerate(sess):
            for _, p in pk or [(None, None)]:
                s.step(float(t), None if p is None else p.packet_for(c))
        fs.ack_tick([(z, dataclasses.replace(p, seqs=np.where(
            clean, p.seqs, -1))) for z, p in pk], tick=t)
        acks, ctrl = [], []
        for c in range(4, C):
            for z, ep, sq in sess[c].drain_acks():
                acks.append((c, z, ep, sq))
                if sess[c].faults is None or not fm.uplink_lost(0, c, t, z,
                                                                sq):
                    fs.ack(c, z, ep, sq, tick=t)
            for _, z in sess[c].drain_ctrl():
                ctrl.append((c, z))
                fs.request_resync(c)
        for s in sess[:4]:
            s.drain_acks()
        fs.maintain(tick=t, deliverable=up, retx_ticks=fm.retx_ticks)
        blocked = fs.blocked_tombstone_oids(tick=t)
        ids = _np(st.ids)
        rel = [s for s in np.nonzero(_np(jstore.deleted_mask(st)) if ref
                                     else _np(tstore.deleted_mask(st)))[0]
               if int(ids[s]) not in blocked]
        if rel:
            if ref:
                st = jstore.release_tombstones(st, np.asarray(rel))
            else:
                tstore.release_tombstones(st, np.asarray(rel))
        log.append((tick_log, acks, ctrl, fs.epoch.tolist()))
    counters = [(s.lost, s.dup_drops, s.corrupt_drops, s.resyncs,
                 s.delivered, s.up_bytes, s.down_bytes) for s in sess]
    return log, counters, [local_ids(s.dev.local) for s in sess]


@pytest.mark.parametrize("client_cap,seed,converges", [
    (256, 0, [True] * 4),
    # a subscribed zone past the client's capacity: eviction makes the map
    # depend on arrival order, and two of the reference's faulty twins end
    # with other objects than their clean twins
    (16, 2, [False, True, False, True])], ids=["fits", "capacity_pressure"])
def test_fault_twins_replay_the_reference(client_cap, seed, converges):
    """Both packages run the same chaos script: the same packets (seqs,
    epochs, crc32, ids, versions, points) tick by tick, the same acks and
    resync requests, counters and final maps — and the same convergence
    of each faulty twin to its clean twin, converged or not."""
    kw = dict(n_obj=160, client_cap=client_cap, ticks=10, settle=8,
              seed=seed)
    lj, cj, mj = _twin_run("ref", **kw)
    lt, ct, mt = _twin_run("port", **kw)
    assert len(lt) == len(lj)
    for t, (a, b) in enumerate(zip(lj, lt)):
        assert b == a, f"tick {t}"
    assert ct == cj and mt == mj
    assert [mt[c] == mt[c + 4] for c in range(4)] == converges
    assert sum(c[3] for c in ct) > 0          # a resync happened


def test_zone_move_leaves_a_ghost_in_both_packages():
    """A move across a zone boundary frees the old shard's slot without a
    tombstone: the old zone's client keeps the object it had received, in
    the reference and in the port alike."""
    gj, gt = grids(8.0, 2, 1)
    jst, tst = synth(10, x_range=(-4, -1))
    fa = jserver.FleetServer(knobs=JKN, embed_dim=E, n_clients=1, grid=gj,
                             budget=16)
    fb = tserver.FleetServer(knobs=KN, embed_dim=E, n_clients=1, grid=gt,
                             budget=16, **CPU)
    da = jrt.DeviceClient(knobs=JKN, embed_dim=E)
    db = trt.DeviceClient(knobs=KN, embed_dim=E, **CPU)
    for fs, st in ((fa, jst), (fb, tst)):
        fs.join(0, np.array([-2.0, 1.5, 0.0], np.float32), 1.0)
        fs.refresh(st)

    def deliver():
        pka, pkb = fa.tick(np.ones(1, bool)), fb.tick(np.ones(1, bool))
        same_ticks(pka, pkb)
        for (_, pa), (_, pb) in zip(pka, pkb):
            if pb.packet_for(0).count:
                da.ingest(pa.packet_for(0), user_pos=jnp.zeros(3))
                db.ingest(pb.packet_for(0), user_pos=torch.zeros(3))
    deliver()
    moved = np.array([3.0, 1.0, 0.0], np.float32)     # into zone 1
    jst = jst._replace(centroid=jst.centroid.at[4].set(moved),
                       version=jst.version.at[4].add(1))
    tst.centroid[4] = torch.from_numpy(moved)
    tst.version[4] += 1
    fa.refresh(jst)
    fb.refresh(tst)
    deliver()
    assert local_ids(db.local) == local_ids(da.local)
    assert local_ids(db.local)[5] == 1          # the ghost, old version
    assert 5 not in fb.zoned._slot[0]


def test_load_session_state_starts_both_sides_equal():
    jst, tst = synth(30, seed=2)
    rng = np.random.default_rng(0)
    state = {"synced_version": rng.integers(0, 2, (4, 64)).astype(np.int32),
             "ever_sent": rng.random((4, 64)) < 0.3,
             "min_obs": np.array([1, 2, 1, 3], np.int32),
             "user_pos": rng.uniform(-3, 3, (4, 3)).astype(np.float32)}
    a = jserver.SessionManager(knobs=JKN, n_clients=4, capacity=64,
                               budget=8, user_pos=state["user_pos"].copy(),
                               min_obs=state["min_obs"].copy(),
                               ever_sent=state["ever_sent"].copy())
    a.sync = jserver.FleetSync(jnp.asarray(state["synced_version"]),
                               jnp.asarray(state["ever_sent"]))
    b = tserver.SessionManager(knobs=KN, n_clients=4, capacity=64, budget=8,
                               **CPU)
    convert.load_session_state(b, state)
    jst = jstore.remove_objects(jst, [2, 5])
    tstore.remove_objects(tst, [2, 5])
    for _ in range(3):
        same_fleet_packet(a.collect(jst), b.collect(tst))
    fs = convert.fleet_sync_from_numpy(state, device="cpu")
    assert fs.synced_version.dtype == torch.int32
    assert fs.ever_sent.dtype == torch.bool
