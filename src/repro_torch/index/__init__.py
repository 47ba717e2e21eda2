"""Hierarchical coarse-to-fine query index (the cluster-summary level).

``cluster`` — the incrementally-maintained per-cell summaries and member
              tables.
``search``  — the two-stage certified-exact query execution and the
              cluster-level result mode.

``core.query.compile_query(spec, target, index=...)`` is the front door;
this package is the machinery behind it.
"""
from repro_torch.index.cluster import (CellGrid, ClusterIndex,
                                       ClusterSummaries, DEFAULT_MIN_FLAT,
                                       rebuilt, summaries_equal)
from repro_torch.index.search import (ClusterResult, cluster_query,
                                      two_stage_query)

__all__ = ["CellGrid", "ClusterIndex", "ClusterSummaries",
           "DEFAULT_MIN_FLAT", "rebuilt", "summaries_equal",
           "ClusterResult", "cluster_query", "two_stage_query"]
