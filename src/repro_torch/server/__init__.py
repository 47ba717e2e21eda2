"""Multi-tenant fleet server (port of ``repro.server``): the paper's server
"multiplexes perception/caption/query work from many XR clients" (Sec. 3.2).

``session``  SessionManager — C clients' sync state as stacked tensors
             (``synced_version: [C, N]``, per-client pose / min-obs knobs),
             so one update tick for the whole fleet is one batched collect
             producing C packets.
``zones``    ZoneShardedStore — objects partitioned into spatial zones, each
             zone an independent ``core.store.ObjectStore`` shard, placeable
             on devices via ``distributed.sharding.zone_shard_devices``.
``mesh``     ClientRoster / MeshSessionTier / MeshFleetPacket — the client
             axis of a zone's session tier partitioned across S session
             shards; packets stay byte-identical to the single-device path.
``fleet``    FleetServer — zones x sessions, the hardened control plane
             (epochs, cumulative acks, ack-driven tombstone retirement) and
             the zone-sharded query plane.

The reference's FleetSimulator and SimClient come with the scenario
engine (ROADMAP.md section 2 item 2).
"""
from repro_torch.core.query import (Query, QueryResult, CompiledQuery,
                                    compile_query, execute_query,
                                    stack_queries)
from repro_torch.server.session import (FleetBatch, FleetPacket, FleetSync,
                                        SessionManager)
from repro_torch.server.zones import ZoneGrid, ZoneShardedStore
from repro_torch.server.mesh import (ClientRoster, MeshFleetPacket,
                                     MeshSessionTier)
from repro_torch.server.fleet import FleetServer

__all__ = ["Query", "QueryResult", "CompiledQuery", "compile_query",
           "execute_query", "stack_queries", "FleetBatch", "FleetPacket",
           "FleetSync", "SessionManager", "ZoneGrid", "ZoneShardedStore",
           "ClientRoster", "MeshFleetPacket", "MeshSessionTier",
           "FleetServer"]
