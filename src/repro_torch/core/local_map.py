"""Object-level sparse local map (device side, paper Sec. 3.2).

Port of ``repro.core.local_map``.  Fixed-capacity per-object entries: an
embedding for query matching + a point cloud downsampled to the client
budget (f16).  When the map is full, admitting a higher-priority update
evicts the lowest-priority retained object.

Priority = semantic relevance to app-declared interests
         + proximity to the user
         + app-declared class boosts.

``apply_updates_batch`` keeps the reference's sequential-scan semantics
(eviction order, stale-version drop, tombstone free-then-reuse within one
batch) as a Python loop over the rows that writes the map in place; the
reference's scan carried a functional copy.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.knobs import Knobs
from repro_torch.device import resolve_device


class LocalMap(NamedTuple):
    ids: torch.Tensor        # [cap] int32 (0 = empty)
    active: torch.Tensor     # [cap] bool
    embed: torch.Tensor      # [cap, E] f32
    label: torch.Tensor      # [cap] int32
    points: torch.Tensor     # [cap, Pc, 3] f16 — client point budget
    n_points: torch.Tensor   # [cap] int32
    centroid: torch.Tensor   # [cap, 3] f32
    version: torch.Tensor    # [cap] int32 — last synced server version
    priority: torch.Tensor   # [cap] f32


def init_local_map(knobs: Knobs, embed_dim: int, *,
                   device="cuda") -> LocalMap:
    dev = resolve_device(device)
    cap, Pc = knobs.client_capacity, knobs.max_object_points_client
    i32 = dict(dtype=torch.int32, device=dev)
    return LocalMap(
        ids=torch.zeros((cap,), **i32),
        active=torch.zeros((cap,), dtype=torch.bool, device=dev),
        embed=torch.zeros((cap, embed_dim), dtype=torch.float32, device=dev),
        label=torch.zeros((cap,), **i32),
        points=torch.zeros((cap, Pc, 3), dtype=torch.float16, device=dev),
        n_points=torch.zeros((cap,), **i32),
        centroid=torch.zeros((cap, 3), dtype=torch.float32, device=dev),
        version=torch.zeros((cap,), **i32),
        priority=torch.zeros((cap,), dtype=torch.float32, device=dev),
    )


def local_map_nbytes(m: LocalMap) -> int:
    return int(sum(x.numel() * x.element_size() for x in m))


def compute_priority(embed, label, centroid, *, user_pos, knobs: Knobs,
                     interest_embeds=None) -> torch.Tensor:
    """[U] priority score for update admission / eviction (Sec. 3.2)."""
    dev = centroid.device
    user_pos = torch.as_tensor(user_pos, dtype=torch.float32, device=dev)
    prox = 1.0 / (1.0 + torch.linalg.vector_norm(centroid - user_pos,
                                                 dim=-1))
    score = knobs.proximity_weight * prox
    if interest_embeds is not None and interest_embeds.shape[0] > 0:
        ie = torch.as_tensor(interest_embeds, dtype=torch.float32, device=dev)
        sem = (embed @ ie.T).amax(dim=-1)
        score = score + knobs.semantic_weight * torch.clamp(sem, min=0.0)
    if knobs.priority_classes:
        boost = torch.isin(label, torch.tensor(knobs.priority_classes,
                                               dtype=torch.int32,
                                               device=dev))
        score = score + knobs.priority_class_boost * boost
    return score.to(torch.float32)


class ObjectUpdate(NamedTuple):
    """One object's delta, as shipped over the downlink (see updates.py)."""
    oid: torch.Tensor        # [] int32
    embed: torch.Tensor      # [E] f32
    label: torch.Tensor      # [] int32
    points: torch.Tensor     # [Pc, 3] f16
    n_points: torch.Tensor   # [] int32
    centroid: torch.Tensor   # [3] f32
    version: torch.Tensor    # [] int32
    deleted: torch.Tensor = None   # [] bool — tombstone row (None = live)


class UpdateBatch(NamedTuple):
    """Struct-of-arrays update packet: U object deltas.  ``valid`` masks
    padding rows (U is bucketed to a power of two, as in the reference)."""
    oid: torch.Tensor        # [U] int32
    embed: torch.Tensor      # [U, E] f32
    label: torch.Tensor      # [U] int32
    points: torch.Tensor     # [U, Pc, 3] f16
    n_points: torch.Tensor   # [U] int32
    centroid: torch.Tensor   # [U, 3] f32
    version: torch.Tensor    # [U] int32
    valid: torch.Tensor      # [U] bool — padding mask
    deleted: torch.Tensor = None   # [U] bool — tombstone rows (None = live)


def _first(mask: torch.Tensor) -> torch.Tensor:
    """First True index (0 when none) — ``jnp.argmax`` on a bool vector."""
    ar = torch.arange(mask.shape[0], device=mask.device)
    return torch.where(mask, ar, mask.shape[0]).amin() % mask.shape[0]


def _first_min(x: torch.Tensor) -> torch.Tensor:
    """First index of the minimum — ``jnp.argmin``'s tie rule."""
    ar = torch.arange(x.shape[0], device=x.device)
    return torch.where(x == x.amin(), ar, x.shape[0]).amin() % x.shape[0]


def _admit_row(m: LocalMap, b: UpdateBatch, r: int, pri: torch.Tensor,
               host: tuple) -> int:
    """Admission/eviction for batch row ``r``, written into ``m`` in place.
    Returns the slot this row wrote or freed, or -1 for a no-op (stale,
    padding, unadmitted, or a tombstone for an unretained id).

    A tombstone row frees the matching slot (id retired, entry
    deactivated), reusable by later rows of the same batch.  A row whose
    version is below the retained entry's is stale and dropped."""
    oid, ver, enabled, is_del, p = (x[r] for x in host)
    hit = (m.ids == oid) & m.active
    slot_existing = _first(hit)
    free = ~m.active
    slot_free = _first(free)
    evict_pri = torch.where(m.active, m.priority, torch.inf)
    slot_evict = _first_min(evict_pri)
    # one host read per row for the scan's control flow
    has, has_free, s_ex, s_fr, s_ev, ev_pri, ex_ver = torch.stack([
        hit.any().double(), free.any().double(), slot_existing.double(),
        slot_free.double(), slot_evict.double(),
        evict_pri[slot_evict].double(),
        m.version[slot_existing].double()]).tolist()
    has, has_free = bool(has), bool(has_free)
    s_ex, s_fr, s_ev = int(s_ex), int(s_fr), int(s_ev)
    slot = s_ex if has else (s_fr if has_free else s_ev)
    stale = has and ver < ex_ver
    admit = (has or has_free or p > ev_pri) and enabled and not is_del \
        and not stale
    erase = is_del and has and enabled and not stale
    if erase:
        m.ids[s_ex] = 0
        m.active[s_ex] = False
        m.version[s_ex] = 0
        m.n_points[s_ex] = 0
        m.priority[s_ex] = 0.0
        return s_ex
    if admit:
        m.ids[slot] = b.oid[r]
        m.active[slot] = True
        m.embed[slot] = b.embed[r]
        m.label[slot] = b.label[r]
        m.points[slot] = b.points[r].to(m.points.dtype)
        m.n_points[slot] = b.n_points[r]
        m.centroid[slot] = b.centroid[r]
        m.version[slot] = b.version[r]
        m.priority[slot] = pri[r]
        return slot
    return -1


def apply_updates_batch_slots(m: LocalMap, batch: UpdateBatch,
                              priorities: torch.Tensor):
    """Apply a whole UpdateBatch row by row, in order — the reference's
    scan semantics, including eviction order.  Writes ``m`` in place.
    Returns (map, touched slots [U] int32; -1 for no-op rows)."""
    U = batch.oid.shape[0]
    deleted = batch.deleted if batch.deleted is not None \
        else torch.zeros_like(batch.valid)
    # the rows' control columns, read to the host once per batch
    host = (batch.oid.tolist(), batch.version.tolist(),
            batch.valid.tolist(), deleted.tolist(),
            priorities.to(torch.float32).tolist())
    touched = [_admit_row(m, batch, r, priorities, host) for r in range(U)]
    return m, torch.tensor(touched, dtype=torch.int32, device=m.ids.device)


def apply_updates_batch(m: LocalMap, batch: UpdateBatch,
                        priorities: torch.Tensor) -> LocalMap:
    """``apply_updates_batch_slots`` without the touched slots."""
    return apply_updates_batch_slots(m, batch, priorities)[0]


def prune_slots(m: LocalMap, drop: torch.Tensor) -> LocalMap:
    """Deactivate every entry where ``drop`` [cap] is True (id retired,
    version forgotten, slot reusable).  Writes ``m`` in place."""
    drop = drop.to(m.active.device)
    m.ids[drop] = 0
    m.active[drop] = False
    m.version[drop] = 0
    m.n_points[drop] = 0
    m.priority[drop] = 0.0
    return m
