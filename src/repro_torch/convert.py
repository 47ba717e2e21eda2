"""State carried between the JAX reference and the port.

Each ``*_from_numpy`` takes the reference's state — a dict or NamedTuple
whose fields convert with ``np.array`` (numpy arrays, or the reference's
own arrays) — and COPIES it into tensors on ``device``: ``np.asarray`` of a
reference array is read-only, and ``torch.from_numpy`` warns on read-only
memory.  Each ``*_to_numpy`` returns a dict of numpy arrays.  The port
imports nothing of the reference; the caller brings its state as data.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.local_map import LocalMap, UpdateBatch
from repro_torch.core.store import ObjectStore
from repro_torch.device import resolve_device
from repro_torch.perception.embedder import OracleEmbedder


def _fields(state) -> dict:
    return dict(state) if isinstance(state, dict) else state._asdict()


def _from_numpy(cls, state, device):
    dev = resolve_device(device)
    src = _fields(state)
    out = {}
    for f in cls._fields:
        v = src.get(f)
        out[f] = None if v is None else torch.from_numpy(np.array(v)).to(dev)
    return cls(**out)


def _to_numpy(state) -> dict:
    return {f: None if v is None else v.cpu().numpy().copy()
            for f, v in state._asdict().items()}


def store_from_numpy(state, *, device="cuda") -> ObjectStore:
    return _from_numpy(ObjectStore, state, device)


def local_map_from_numpy(state, *, device="cuda") -> LocalMap:
    return _from_numpy(LocalMap, state, device)


def update_batch_from_numpy(state, *, device="cuda") -> UpdateBatch:
    return _from_numpy(UpdateBatch, state, device)


def store_to_numpy(store: ObjectStore) -> dict:
    return _to_numpy(store)


def local_map_to_numpy(m: LocalMap) -> dict:
    return _to_numpy(m)


def update_batch_to_numpy(batch: UpdateBatch) -> dict:
    return _to_numpy(batch)


def embedder_basis_matches(np_basis, *, seed: int = 7) -> bool:
    """True when the port's OracleEmbedder class basis (same seed and
    width) is bit-identical to ``np_basis``, e.g. the reference
    embedder's basis as numpy."""
    np_basis = np.asarray(np_basis)
    emb = OracleEmbedder(embed_dim=np_basis.shape[1], seed=seed)
    return bool(np.array_equal(np_basis, emb.basis_np))
