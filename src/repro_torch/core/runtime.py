"""Device-cloud runtime: network channel, power model, client, session loop.

Port of ``repro.core.runtime``.  The device-cloud boundary is simulated
with explicit models; every byte that crosses it is accounted by the real
serialized sizes from updates.py.

NetworkModel  — RTT + bandwidth + scheduled outage windows (paper Sec. 4.3).
FaultModel    — seeded per-packet loss / duplication / reordering /
                corruption draws, the same numpy draws as the reference's,
                so a chaos run replays the reference's faults draw for draw.
PowerModel    — coefficients calibrated to the paper's own Jetson
                measurements (Fig. 7); a MODEL, not a measurement.
ClientSession — the per-tick client step of the fleet tier: delivery,
                the hardened protocol's receive path, ingest, byte
                accounting, SQ / LQ mode choice.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import query as query_mod
from repro_torch.core.knobs import Knobs
from repro_torch.core.local_map import (LocalMap, UpdateBatch,
                                        apply_updates_batch,
                                        apply_updates_batch_slots,
                                        compute_priority, init_local_map,
                                        local_map_nbytes, prune_slots)
from repro_torch.core.updates import (ACK_NBYTES, RESYNC_NBYTES, SyncState,
                                      collect_updates, init_sync)
from repro_torch.device import resolve_device, synchronize
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import traced as obs_traced


# ---------------------------------------------------------------------------
@dataclass
class NetworkModel:
    rtt_ms: float = 20.0
    bandwidth_mbps: float = 200.0
    outages: tuple = ()            # ((t_start, t_end) seconds, ...)

    def is_up(self, t: float) -> bool:
        return not any(a <= t < b for a, b in self.outages)

    def transfer_ms(self, nbytes: float) -> float:
        return self.rtt_ms + nbytes * 8 / (self.bandwidth_mbps * 1e6) * 1e3

    def delivery_time(self, t: float, nbytes: float) -> float | None:
        """Completion time of a transfer started at ``t``: progress stalls
        through each outage window it straddles.  None when the link is
        down at send time."""
        if not self.is_up(t):
            return None
        remaining = self.transfer_ms(nbytes) * 1e-3
        cur = t
        for a, b in sorted(self.outages):
            if b <= cur:
                continue
            gap = max(a - cur, 0.0)
            if gap >= remaining:
                return cur + remaining
            remaining -= gap
            cur = b
        return cur + remaining

    def measured_latency_ms(self, t: float) -> float:
        """What the client's RGB-D stream monitor observes (Sec. 3.2)."""
        return float("inf") if not self.is_up(t) else self.rtt_ms


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FaultModel:
    """Seeded hostile-network fault injection + hardened-protocol knobs.

    Outage windows (NetworkModel) model a clean link going away; this
    models the link misbehaving while nominally up: per-packet loss,
    duplication, reordering (bounded extra delay on a copy), and
    truncation / corruption (checksum mismatch at the receiver -> drop).
    Every draw is keyed on (seed, stream tag, client, zone, epoch, seq)
    through numpy's generator, exactly as in the reference, so a scenario
    replays its faults bit-identically on either package.

    The protocol knobs ride here too: the client's gap-detection resync
    timeout (exponential backoff, capped) and the server's retransmit
    timeout in ticks."""
    seed: int = 0
    loss_prob: float = 0.0
    dup_prob: float = 0.0
    reorder_prob: float = 0.0
    reorder_jitter_s: float = 2.0
    corrupt_prob: float = 0.0
    # hardened-protocol knobs
    resync_timeout_s: float = 2.0
    resync_backoff_cap_s: float = 16.0
    retx_ticks: int = 3

    def packet_draws(self, cid: int, zone: int, epoch: int,
                     seq: int) -> np.ndarray:
        """[9] uniform draws for one downlink packet, a fixed layout so
        branch-free replay holds: [dup?, loss c0, loss c1, reorder c0,
        reorder c1, jitter c0, jitter c1, corrupt c0, corrupt c1]."""
        rng = np.random.default_rng((self.seed, 3, cid, zone,
                                     max(epoch, 0), seq))
        return rng.random(9)

    def uplink_lost(self, tag: int, cid: int, tick: int, a: int,
                    b: int) -> bool:
        """Loss draw for one upstream control frame (ack/resync)."""
        if self.loss_prob <= 0.0:
            return False
        rng = np.random.default_rng((self.seed, 5, tag, cid, tick, a, b))
        return bool(rng.random() < self.loss_prob)


@dataclass
class PowerModel:
    idle_w: float = 8.6
    streaming_w: float = 0.17          # ~2% over idle (paper Sec. 5.6)
    joules_per_local_query: float = 0.315   # (13.23-8.6)/14.7
    sq_overhead_w: float = 0.02        # tx/rx of a text query is negligible

    def average_power(self, *, streaming: bool, local_qps: float = 0.0,
                      server_qps: float = 0.0) -> float:
        p = self.idle_w
        if streaming:
            p += self.streaming_w
        p += self.joules_per_local_query * local_qps
        p += self.sq_overhead_w * server_qps
        return p

    def on_device_mapping_power(self) -> float:
        """Full pipeline on device (paper: ~50 W in MAXN, seconds/frame)."""
        return 50.0


# ---------------------------------------------------------------------------
@dataclass
class DeviceClient:
    knobs: Knobs
    embed_dim: int
    device: str | torch.device = "cuda"
    local: LocalMap = None
    use_pallas: bool = False           # accepted for API parity, ignored
    cluster_index: object = None       # repro_torch.index.ClusterIndex | None
    # measured stats
    lq_count: int = 0
    sq_count: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.local is None:
            self.local = init_local_map(self.knobs, self.embed_dim,
                                        device=self.device)

    def enable_index(self, **kw) -> None:
        """Attach a cluster-summary index over the local map; from then on
        every ingest maintains it from the batch's touched slots and
        ``query_spec`` plans coarse-to-fine once the map is big enough."""
        from repro_torch.index import ClusterIndex
        self.cluster_index = ClusterIndex.for_target(self.local, **kw)

    def ingest(self, packet, *, user_pos, interest_embeds=None):
        """Apply a whole UpdatePacket: batched compute_priority, then the
        in-order row apply (the local map is written in place); the
        touched slots maintain the cluster index when one is enabled."""
        if packet is None or packet.count == 0:
            return
        b = packet.batch
        pri = compute_priority(b.embed, b.label, b.centroid,
                               user_pos=user_pos, knobs=self.knobs,
                               interest_embeds=interest_embeds)
        self.local, touched = apply_updates_batch_slots(self.local, b, pri)
        if self.cluster_index is not None:
            t = np.unique(touched.cpu().numpy())
            self.cluster_index.update_slots(self.local, t[t >= 0])

    def ingest_sequential(self, packet, *, user_pos, interest_embeds=None):
        """Seed per-object ingest — the equivalence oracle for ``ingest``:
        each live row's priority computed alone, then applied alone."""
        if packet is None or packet.count == 0:
            return
        b = packet.batch
        for i in range(packet.count):
            row = UpdateBatch(*(None if x is None else x[i:i + 1]
                                for x in b))
            row = row._replace(valid=torch.ones_like(row.valid))
            pri = compute_priority(row.embed, row.label, row.centroid,
                                   user_pos=user_pos, knobs=self.knobs,
                                   interest_embeds=interest_embeds)
            self.local = apply_updates_batch(self.local, row, pri)

    def memory_bytes(self) -> int:
        return local_map_nbytes(self.local)

    def query(self, embed):
        """Embedding-only LQ (top-5 cosine) — the paper's Fig. 4/5 path."""
        return self.query_spec(query_mod.Query(embed=embed, k=5))

    def query_spec(self, spec):
        """Declarative LQ: a full ``core.query.Query`` against the local map
        (coarse-to-fine through ``cluster_index`` when one is enabled and
        engaged)."""
        res = query_mod.execute_query(self.local, spec,
                                      index=self.cluster_index)
        synchronize(self.device)
        self.lq_count += 1
        return res


# ---------------------------------------------------------------------------
@dataclass
class OutageBuffer:
    """O(1) stand-in for the packets a client missed during an outage: the
    sync vector already encodes what the client is owed, and
    ``flush_buffer`` re-collects against the current store."""
    since_tick: int                 # first tick the client missed
    ticks: int = 0                  # how many update ticks were skipped

    def __len__(self) -> int:
        return 1 if self.ticks else 0


@dataclass
class CloudService:
    """Server side of the split: map store + per-client sync + SQ engine."""
    knobs: Knobs
    store_ref: object                      # MappingServer (owns the store)
    device: str | torch.device = "cuda"
    sync: SyncState = None
    buffered: OutageBuffer = None          # coalesced outage state (O(1))
    tick: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.sync is None:
            self.sync = init_sync(self.knobs.server_capacity)
        if self.buffered is None:
            self.buffered = OutageBuffer(since_tick=0)

    def update_tick(self, *, network_up: bool, full_map: bool = False,
                    priorities=None):
        """Run one update tick; returns the packet that reached the device
        (None during an outage — the tick coalesces into the OutageBuffer
        and the sync vector stays put)."""
        if not network_up:
            if self.buffered.ticks == 0:
                self.buffered.since_tick = self.tick
            self.buffered.ticks += 1
            self.tick += 1
            return None
        packet, new_sync = collect_updates(
            self.store_ref.store, self.sync, self.knobs, tick=self.tick,
            full_map=full_map, priorities=priorities)
        self.tick += 1
        self.sync = new_sync
        if self.buffered.ticks:
            self.buffered = OutageBuffer(since_tick=self.tick)
        return packet

    def flush_buffer(self):
        """Reconnection: pending updates apply at once (re-collected against
        the current store so intermediate versions coalesce)."""
        self.buffered = OutageBuffer(since_tick=self.tick)
        packet, self.sync = collect_updates(
            self.store_ref.store, self.sync, self.knobs, tick=self.tick)
        return packet

    def query(self, embed):
        """Embedding-only SQ (top-5 cosine) — the paper's Fig. 4 path."""
        return self.query_spec(query_mod.Query(embed=embed, k=5))

    def query_spec(self, spec):
        """Declarative SQ over the server store: two-stage through the
        mapping server's cluster index when it maintains one."""
        res = query_mod.execute_query(
            self.store_ref.store, spec,
            index=getattr(self.store_ref, "cluster_index", None))
        synchronize(self.device)
        return res


# ---------------------------------------------------------------------------
def choose_mode(net: NetworkModel, t: float, knobs: Knobs) -> str:
    """SemanticXR-SQ vs -LQ switching on observed latency (Sec. 3.2)."""
    lat = net.measured_latency_ms(t)
    return "SQ" if lat <= knobs.net_latency_switch_threshold_ms else "LQ"


# ---------------------------------------------------------------------------
@dataclass
class ClientSession:
    """The per-tick client step of the fleet tier: packet delivery
    (outage-aware: a transfer straddling an outage start is delayed, not
    delivered at pre-outage latency), ingest, byte accounting, and SQ / LQ
    mode choice.

    Two transports share the receive path:

    * ``faults is None`` (clean link) — FIFO delivery, ingest within the
      send tick when the link allows.  Packets that carry protocol framing
      (``seq`` / ``epoch`` from the fleet tier) still run the sequencing /
      ack bookkeeping, and the emitted cumulative acks drive the server's
      slot retirement.
    * ``faults`` set — the fault-injection transport: per-packet seeded
      loss / duplication / reordering / corruption draws, delivery strictly
      via the in-flight queue, checksum verification, a per-zone reorder
      buffer with in-order apply, and gap-detection resync requests with
      exponential backoff.
    """
    dev: DeviceClient
    net: NetworkModel
    knobs: Knobs
    user_pos: object = None            # [3] — priority/eviction anchor
    interest_embeds: object = None
    dt: float = 1.0                    # tick period (seconds)
    cid: int = 0                       # fault-draw key (fleet client id)
    faults: FaultModel | None = None   # None = clean transport
    down_bytes: int = 0
    up_bytes: int = 0                  # ack/resync control frames (hardened
    #                                    accounting only)
    delivered: int = 0                 # packets actually ingested
    delayed: int = 0                   # packets not ingested within their
    #                                    send tick
    # fault/protocol counters (cumulative)
    lost: int = 0                      # downlink packets the channel ate
    dup_drops: int = 0                 # duplicate deliveries discarded
    corrupt_drops: int = 0             # checksum-failed deliveries discarded
    stale_drops: int = 0               # out-of-subscription deliveries
    #                                    dropped at the device
    resyncs: int = 0                   # resync requests issued
    epoch: int = -1                    # adopted server sync epoch
    pending: list = field(default_factory=list)   # [(deliver_at, packet)]
    acks: list = field(default_factory=list)      # [(zone, epoch, seq)] out
    ctrl: list = field(default_factory=list)      # [("resync", zone)] out
    zone_subs: object = None           # [Z] bool — the device's CURRENT
    #                                    zone subscriptions: packets from
    #                                    zones outside it are dropped at
    #                                    delivery.  None = gate off.
    _expect: dict = field(default_factory=dict)   # zone -> next seq to apply
    _reorder: dict = field(default_factory=dict)  # zone -> {seq: packet}
    _gap_since: dict = field(default_factory=dict)   # zone -> gap open time
    _backoff: dict = field(default_factory=dict)  # zone -> current timeout

    def __post_init__(self):
        if self.user_pos is None:
            self.user_pos = torch.zeros(3, device=self.dev.device)

    def _ingest(self, packet):
        self.dev.ingest(packet, user_pos=self.user_pos,
                        interest_embeds=self.interest_embeds)
        self.down_bytes += packet.nbytes
        self.delivered += 1
        reg = obs_metrics.get_registry()
        if reg is not None:
            reg.counter("client_down_bytes_total",
                        "bytes ingested per client").inc(packet.nbytes,
                                                         client=self.cid)

    def _count_fault(self, kind: str) -> None:
        """Mirror a transport fault counter into the metrics registry."""
        reg = obs_metrics.get_registry()
        if reg is not None:
            reg.counter("client_faults_total",
                        "transport faults per client by kind").inc(
                            client=self.cid, kind=kind)

    def _fresh_map(self) -> None:
        self.dev.local = init_local_map(self.dev.knobs, self.dev.embed_dim,
                                        device=self.dev.device)
        self._resync_index()

    # -- hardened receive path ---------------------------------------------
    def _adopt_epoch(self, epoch: int, fresh: bool) -> None:
        """A packet from a newer epoch: the server rolled this client back
        (resync / retransmit timeout) or restarted it (join / crash
        recovery / lease expiry).  Sequence streams restart at 0; a fresh
        epoch also resets the device map."""
        self.epoch = epoch
        self._expect = {}
        self._reorder = {}
        self._gap_since = {}
        self._backoff = {}
        if fresh:
            self._fresh_map()

    def _resync_index(self) -> None:
        """Re-diff the client's cluster index after a map replacement that
        bypassed the ingest path (epoch reset, crash, zone prune)."""
        if self.dev.cluster_index is not None:
            self.dev.cluster_index.refresh(self.dev.local)

    def _zone_ok(self, zone: int) -> bool:
        """Is the device still subscribed to ``zone``?  ``zone_subs is
        None`` disables the gate."""
        if self.zone_subs is None:
            return True
        subs = np.asarray(self.zone_subs, bool)
        return bool(subs[zone]) if zone < len(subs) else False

    def _ack(self, zone: int, seq: int) -> None:
        self.acks.append((zone, self.epoch, seq))
        if self.faults is not None:
            self.up_bytes += ACK_NBYTES
            reg = obs_metrics.get_registry()
            if reg is not None:
                reg.counter("client_up_bytes_total",
                            "upstream control bytes per client").inc(
                                ACK_NBYTES, client=self.cid, kind="ack")

    def _receive(self, t: float, packet) -> None:
        """Apply one arrived packet through the protocol state machine.
        Unframed packets (``seq is None``) apply directly."""
        if getattr(packet, "seq", None) is None:
            self._ingest(packet)
            return
        if not packet.checksum_ok():
            self.corrupt_drops += 1
            self._count_fault("corrupt_drop")
            return
        if packet.epoch < self.epoch:
            return                         # pre-resync straggler: discard
        if packet.epoch > self.epoch:
            self._adopt_epoch(packet.epoch, packet.fresh)
        z = packet.zone
        exp = self._expect.get(z, 0)
        if packet.seq < exp:
            # duplicate of an applied packet; re-ack in case the original
            # cumulative ack was lost upstream
            self.dup_drops += 1
            self._count_fault("dup_drop")
            self._ack(z, exp - 1)
            return
        if packet.seq > exp:
            buf = self._reorder.setdefault(z, {})
            if packet.seq not in buf:
                buf[packet.seq] = packet
            else:
                self.dup_drops += 1
                self._count_fault("dup_drop")
            self._gap_since.setdefault(z, t)
            return
        # in order: apply, then drain whatever the gap was holding back.  A
        # packet from a zone the device no longer subscribes to is dropped
        # here, never ingested, but its seq still advances and the
        # cumulative ack still goes out, so the stream position survives a
        # zone round-trip.
        ok = self._zone_ok(z)
        buf = self._reorder.get(z, {})
        seq = packet.seq
        while True:
            if ok:
                self._ingest(packet)
            else:
                self.stale_drops += 1
                self._count_fault("stale_zone_drop")
            seq += 1
            if seq in buf:
                packet = buf.pop(seq)
            else:
                break
        self._expect[z] = seq
        self._ack(z, seq - 1)              # cumulative: covers the run
        if buf:
            self._gap_since[z] = t         # a later gap is still open
        else:
            self._gap_since.pop(z, None)
            self._backoff.pop(z, None)

    def _clean_delivery_at(self, t: float, nbytes: int) -> float:
        send = t
        while (at := self.net.delivery_time(send, nbytes)) is None:
            # sender raced an outage start: retransmit after it ends
            send = max(b for a, b in self.net.outages if a <= send < b)
        return at

    def _send_faulty(self, t: float, packet) -> None:
        """Fault-injection downlink: seeded per-packet draws decide loss,
        duplication, reordering jitter and corruption per copy; each copy
        matures at its own time (no FIFO clamp)."""
        fm = self.faults
        seq = packet.seq if packet.seq is not None else (1 << 20) + packet.tick
        r = fm.packet_draws(self.cid, packet.zone, packet.epoch, seq)
        copies = 2 if r[0] < fm.dup_prob else 1
        for k in range(copies):
            if r[1 + k] < fm.loss_prob:
                self.lost += 1
                self._count_fault("lost")
                continue
            at = self._clean_delivery_at(t, packet.nbytes)
            if r[3 + k] < fm.reorder_prob:
                at += float(r[5 + k]) * fm.reorder_jitter_s
            p = packet
            if r[7 + k] < fm.corrupt_prob and packet.checksum is not None:
                p = copy.copy(packet)
                p.checksum = packet.checksum ^ 0x5A5A5A5A
            if at > t + self.dt:
                self.delayed += 1
            self.pending.append((at, p))

    def _check_gaps(self, t: float) -> None:
        """Gap open past the (backed-off) timeout -> queue a resync request
        for the caller to carry upstream."""
        fm = self.faults
        for z, since in list(self._gap_since.items()):
            wait = self._backoff.get(z, fm.resync_timeout_s)
            if t - since >= wait:
                self.ctrl.append(("resync", z))
                self.resyncs += 1
                self.up_bytes += RESYNC_NBYTES
                self._count_fault("resync")
                reg = obs_metrics.get_registry()
                if reg is not None:
                    reg.counter("client_up_bytes_total",
                                "upstream control bytes per client").inc(
                                    RESYNC_NBYTES, client=self.cid,
                                    kind="resync")
                self._gap_since[z] = t
                self._backoff[z] = min(wait * 2, fm.resync_backoff_cap_s)

    # -- control-plane outboxes --------------------------------------------
    def drain_acks(self) -> list:
        out, self.acks = self.acks, []
        return out

    def drain_ctrl(self) -> list:
        out, self.ctrl = self.ctrl, []
        return out

    def prune_zones(self, grid, subscribed: np.ndarray) -> int:
        """Prune-on-unsubscribe: drop retained objects whose centroids
        route to zones the client no longer subscribes to.  Returns how
        many entries were pruned."""
        self.zone_subs = np.asarray(subscribed, bool).copy()
        m = self.dev.local
        act = m.active.cpu().numpy()
        if not act.any():
            return 0
        z = grid.zone_of(m.centroid.cpu().numpy())
        drop = act & ~np.asarray(subscribed, bool)[z]
        n = int(drop.sum())
        if n:
            self.dev.local = prune_slots(
                m, torch.from_numpy(drop).to(m.active.device))
            self._resync_index()
        return n

    def crash(self) -> None:
        """Device restart: the local map, every in-flight packet and the
        protocol position are gone; cumulative traffic counters survive.
        The rejoin bumps the epoch with fresh=True (full catch-up)."""
        self.pending.clear()
        self.acks.clear()
        self.ctrl.clear()
        self._fresh_map()
        self.epoch = -1
        self.zone_subs = None
        self._expect = {}
        self._reorder = {}
        self._gap_since = {}
        self._backoff = {}

    # -- the per-tick step -------------------------------------------------
    @obs_traced("client.step", cat="client")
    def step(self, t: float, packet=None) -> str:
        """Advance to time ``t``: deliver matured in-flight packets, send
        ``packet`` (ingesting within the tick unless an outage delays it),
        and return the query mode ("SQ"/"LQ") for this tick.

        Clean-link delivery is FIFO per link: a packet sent while older
        packets are still in flight queues behind them.  Under the
        fault-injection transport the FIFO clamp is off and the sequencing
        layer orders delivery instead."""
        matured = sorted((p for p in self.pending if p[0] <= t),
                         key=lambda p: p[0])
        self.pending = [p for p in self.pending if p[0] > t]
        for _, p in matured:
            self._receive(t, p)
        if packet is not None and packet.count > 0:
            if self.faults is not None:
                self._send_faulty(t, packet)
            else:
                at = self._clean_delivery_at(t, packet.nbytes)
                if self.pending:
                    at = max(at, self.pending[-1][0])  # FIFO behind in-flight
                if not self.pending and at <= t + self.dt:
                    self._receive(t, packet)
                else:
                    self.delayed += 1
                    self.pending.append((at, packet))
        if self.faults is not None:
            self._check_gaps(t)
        return choose_mode(self.net, t, self.knobs)
