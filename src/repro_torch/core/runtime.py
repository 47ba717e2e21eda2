"""Device-cloud runtime: network channel, power model, client, cloud service.

Port of the single-client part of ``repro.core.runtime``.  The
device-cloud boundary is simulated with explicit models; every byte that
crosses it is accounted by the real serialized sizes from updates.py.

NetworkModel — RTT + bandwidth + scheduled outage windows (paper Sec. 4.3).
PowerModel   — coefficients calibrated to the paper's own Jetson
               measurements (Fig. 7); a MODEL, not a measurement.

``ClientSession`` and ``FaultModel`` (the fleet / scenario transport) are
not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import query as query_mod
from repro_torch.core.knobs import Knobs
from repro_torch.core.local_map import (LocalMap, UpdateBatch,
                                        apply_updates_batch,
                                        apply_updates_batch_slots,
                                        compute_priority, init_local_map,
                                        local_map_nbytes)
from repro_torch.core.updates import SyncState, collect_updates, init_sync
from repro_torch.device import resolve_device, synchronize


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
