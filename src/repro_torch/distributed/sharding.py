"""Placement of the fleet tier's shards on devices.

Port of ``zone_shard_devices`` and ``client_shard_affinity`` from
``repro.distributed.sharding``.  A "mesh" in the port is a sequence of
``torch.device``s (``[torch.device("cuda", i) for i in range(n)]``); on one
H100 every shard maps to ``cuda:0``.
"""
from __future__ import annotations

import numpy as np
import torch


def zone_shard_devices(mesh, n_zones: int) -> list:
    """Round-robin device placement for the fleet server's spatial zone
    shards (server/zones.py): zone z lives on mesh device z % ndev, so
    per-zone sync collects and queries run where the shard's tensors live.
    ``mesh`` is a sequence of devices."""
    devs = [torch.device(d) for d in mesh]
    return [devs[z % len(devs)] for z in range(n_zones)]


def client_shard_affinity(subscribed: np.ndarray, n_shards: int,
                          zone_shards: np.ndarray | None = None) -> np.ndarray:
    """Assign each client to a session shard by subscribed-zone affinity.

    ``subscribed`` is the fleet's [C, Z] zone-subscription matrix and
    ``zone_shards`` [Z] maps each spatial zone to the session shard whose
    device holds that zone's store (defaults to z % n_shards).  A client is
    homed on the shard that owns the MOST of its subscribed zones —
    majority vote, lowest shard id on ties.  Clients with no subscriptions
    yet fall back to round-robin (c % n_shards).  Returns [C] int32.
    """
    subscribed = np.asarray(subscribed, bool)
    C, Z = subscribed.shape
    if zone_shards is None:
        zone_shards = np.arange(Z) % n_shards
    zone_shards = np.asarray(zone_shards)
    # [C, S] votes: how many of client c's zones live on shard s
    votes = np.zeros((C, n_shards), np.int64)
    for s in range(n_shards):
        votes[:, s] = subscribed[:, zone_shards == s].sum(axis=1)
    assign = votes.argmax(axis=1).astype(np.int32)   # argmax = lowest tie
    none = ~subscribed.any(axis=1)
    assign[none] = (np.arange(C)[none] % n_shards).astype(np.int32)
    return assign
