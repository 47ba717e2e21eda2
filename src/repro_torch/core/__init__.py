"""SemanticXR core, ported to PyTorch: objects as first-class units of
communication, execution and memory footprint across the device-cloud
boundary."""
from repro_torch.core.knobs import DEFAULT_KNOBS, Knobs
from repro_torch.core.local_map import LocalMap, ObjectUpdate, init_local_map
from repro_torch.core.pipeline import MappingServer, StageTimes
from repro_torch.core.query import (CompiledQuery, Query, QueryResult,
                                    compile_query, execute_query,
                                    stack_queries)
from repro_torch.core.runtime import (ClientSession, CloudService,
                                      DeviceClient, FaultModel, NetworkModel,
                                      PowerModel, choose_mode)
from repro_torch.core.store import ObjectStore, init_store, store_from_knobs

__all__ = ["DEFAULT_KNOBS", "Knobs", "LocalMap", "ObjectUpdate",
           "init_local_map", "MappingServer", "StageTimes", "CompiledQuery",
           "Query", "QueryResult", "compile_query", "execute_query",
           "stack_queries", "ClientSession", "CloudService", "DeviceClient",
           "FaultModel", "NetworkModel",
           "PowerModel", "choose_mode", "ObjectStore", "init_store",
           "store_from_knobs"]
