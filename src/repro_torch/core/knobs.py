"""Application-configurable resource-vs-quality knobs (paper Tab. 2).

A copy of ``repro.core.knobs``: the port imports nothing of ``repro``.
Every SemanticXR innovation is parameterized here; defaults are the paper's
defaults.  Applications tune these per object class / deployment without
touching the perception or mapping pipeline (Sec. 3.4).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Knobs:
    # Query latency vs. device power (Sec. 3.2, query-mode switching)
    net_latency_switch_threshold_ms: float = 100.0

    # Object class mapping policy (Sec. 3.4)
    skip_mapping_set: tuple = ()             # class ids never mapped
    max_object_points_server: int = 2000     # geometry downsampling (Sec. 3.1)

    # Local map geometric detail vs. memory (Sec. 3.2)
    max_object_points_client: int = 200
    # optional per-class overrides: {class_id: client_points}
    class_point_overrides: tuple = ()

    # Local map freshness vs. downstream bandwidth (Sec. 3.2)
    local_map_update_frequency: int = 2      # frames between update ticks
    min_obs_before_sync: int = 2             # transient filtering

    # Upstream bandwidth budget (Sec. 3.3)
    min_mapping_bbox_area: int = 2000        # px, full-res units
    depth_downsampling_ratio: int = 5        # per spatial dim

    # Update prioritization (Sec. 3.2)
    priority_classes: tuple = ()             # app-declared task-relevant ids
    priority_class_boost: float = 1.0
    proximity_weight: float = 0.5
    semantic_weight: float = 0.5

    # capacities (fixed shapes)
    server_capacity: int = 4096              # max objects in the server map
    client_capacity: int = 512               # local map object budget
    max_detections_per_frame: int = 32

    def client_points_for(self, class_id: int) -> int:
        for cid, pts in self.class_point_overrides:
            if cid == class_id:
                return pts
        return self.max_object_points_client


DEFAULT_KNOBS = Knobs()
