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
from repro_torch.index.cluster import ClusterSummaries
from repro_torch.models import common as cm
from repro_torch.models.encdec import EncDec, encdec_param_specs
from repro_torch.models.lm import LM, lm_param_specs
from repro_torch.optim.adamw import OptState
from repro_torch.perception.embedder import OracleEmbedder
from repro_torch.server.session import FleetSync, SessionManager


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


def cluster_summaries_from_numpy(state, *,
                                 device="cuda") -> ClusterSummaries:
    return _from_numpy(ClusterSummaries, state, device)


def fleet_sync_from_numpy(state, *, device="cuda") -> FleetSync:
    """The reference's ``FleetSync`` (synced_version [C, N] int32,
    ever_sent [C, N] bool) as the port's, copied onto ``device``."""
    return _from_numpy(FleetSync, state, device)


def load_session_state(sm: SessionManager, state) -> SessionManager:
    """Start the port's SessionManager ``sm`` from the reference's fleet
    sync state: ``synced_version`` / ``ever_sent`` (the device sync state;
    ``ever_sent`` also seeds the host mirror) and whichever of the host
    arrays ``min_obs``, ``user_pos``, ``subscribed``, ``acked`` and
    ``next_seq`` ``state`` holds, all copied.  Returns ``sm``."""
    src = _fields(state)
    sm.sync = fleet_sync_from_numpy(
        {"synced_version": src["synced_version"],
         "ever_sent": src.get("ever_sent", np.zeros(
             np.shape(src["synced_version"]), bool))}, device=sm.device)
    sm.ever_sent = sm.sync.ever_sent.cpu().numpy().copy()
    for f, dt in (("min_obs", np.int32), ("user_pos", np.float32),
                  ("subscribed", bool), ("acked", np.int32),
                  ("next_seq", np.int64)):
        if src.get(f) is not None:
            setattr(sm, f, np.array(src[f], dtype=dt))
    sm.dirty = True
    return sm


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


def _leaf(x, dtype) -> torch.Tensor:
    """A reference leaf (numpy, the reference's array, or a tensor) as a
    new CPU tensor in ``dtype``; numpy leaves go via f32, since numpy has
    no bf16 that torch reads."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(dtype).clone()
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def _top_keys(cfg: cm.ArchConfig) -> list:
    """The leaves of ``lm_param_specs(cfg)`` outside the layer stack
    (``embed``, ``final_scale``, ``lm_head`` where untied, ``vis_proj``
    where the model has a vision frontend): the same names in both
    layouts."""
    return [k for k in lm_param_specs(cfg) if k != "layers"]


# the encoder-decoder's layer lists and the reference's stacked names
_ENCDEC_STACKS = (("enc_layers", "enc_body"), ("dec_layers", "dec_body"))


def _encdec_from_reference(tree, leaf) -> dict:
    """The reference's encoder-decoder layout (each side's layers stacked
    ``[n, ...]`` under ``enc_body`` / ``dec_body``) as the port's per-layer
    lists; ``leaf(path, x)`` converts each, ``path`` in the port's tree
    (``dec_layers/3/cross/wq``)."""
    out = {k: leaf(k, v) for k, v in tree.items()
           if k not in dict(_ENCDEC_STACKS).values()}
    for mine, ref in _ENCDEC_STACKS:
        n = next(x for _, x in cm.leaves(tree[ref])).shape[0]
        out[mine] = [cm.map_tree(
            lambda p, x, i=i: leaf(f"{mine}/{i}/{p}", x[i]), tree[ref])
            for i in range(n)]
    return out


def _encdec_to_reference(tree) -> dict:
    """The inverse of ``_encdec_from_reference`` over CPU tensors."""
    out = {k: v for k, v in tree.items() if k not in dict(_ENCDEC_STACKS)}
    for mine, ref in _ENCDEC_STACKS:
        layers = [dict(cm.leaves(t)) for t in tree[mine]]
        out[ref] = cm.map_tree(
            lambda p, _: torch.stack([t[p] for t in layers]), tree[mine][0])
    return out


def _from_reference(cfg: cm.ArchConfig, tree, leaf) -> dict:
    """The reference's LM layout (body leaves stacked ``[n_periods, ...]``
    per period slot, the dense prefix as a list) as the port's per-layer
    tree: prefix first, then period by period, and every top-level leaf of
    the config's specs; ``leaf(path, x)`` converts each, ``path`` the
    leaf's path in the port's tree (``layers/3/mlp/router``).  An
    encoder-decoder's tree goes through ``_encdec_from_reference``."""
    if cfg.encdec:
        return _encdec_from_reference(tree, leaf)
    npre = len(tree.get("prefix", []))
    layers = [cm.map_tree(lambda p, x, i=i: leaf(f"layers/{i}/{p}", x), t)
              for i, t in enumerate(tree.get("prefix", []))]
    for i in range(cfg.n_periods):
        for s in range(cfg.period):
            n = npre + i * cfg.period + s
            layers.append(cm.map_tree(
                lambda p, x, i=i, n=n: leaf(f"layers/{n}/{p}", x[i]),
                tree["body"][s]))
    out = {k: leaf(k, tree[k]) for k in _top_keys(cfg)}
    out["layers"] = layers
    return out


def _to_reference(cfg: cm.ArchConfig, tree) -> dict:
    """The inverse of ``_from_reference`` over CPU tensors: body layers
    stacked ``[n_periods, ...]`` per period slot."""
    if cfg.encdec:
        return _encdec_to_reference(tree)
    out = {k: tree[k] for k in _top_keys(cfg)}
    layers = tree["layers"]
    npre = cfg.n_dense_prefix
    if npre:
        out["prefix"] = list(layers[:npre])
    body = layers[npre:]
    out["body"] = []
    for s in range(cfg.period):
        slot = [dict(cm.leaves(body[i * cfg.period + s]))
                for i in range(cfg.n_periods)]
        out["body"].append(cm.map_tree(
            lambda p, _: torch.stack([t[p] for t in slot]),
            body[s]))
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a new numpy array; bf16 as f32 of the same values
    (numpy has no bf16)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def lm_params_from_numpy(cfg: cm.ArchConfig, tree, *, device="cuda") -> LM:
    """The reference's LM parameters (``repro.models.lm`` pytree; leaves
    numpy, the reference's arrays or tensors) as the port's ``LM`` on
    ``device``, frozen, each leaf in its spec's dtype (``cfg.dtype``, but
    an MoE router stays f32).

    The reference stacks each period slot's body leaves as
    ``[n_periods, ...]`` and keeps the dense prefix as a list; the port
    keeps one tree per layer, prefix first, then period by period.  A tied
    head stays tied: there is no ``lm_head`` and the head reads
    ``embed.T``."""
    dtypes = {p: s.dtype for p, s in cm.leaves(lm_param_specs(cfg))}
    return LM(cfg, _from_reference(cfg, tree,
                                   lambda p, x: _leaf(x, dtypes[p])),
              device=device)


def lm_params_to_tree(lm: LM) -> dict:
    """The port's ``LM`` in the reference's layout (the inverse of
    ``lm_params_from_numpy``), as new CPU tensors in their own dtype (never
    views of the parameters, which training writes in place): what a
    checkpoint of the parameters holds."""
    return _to_reference(lm.cfg, cm.map_tree(
        lambda _, p: p.detach().to("cpu", copy=True), lm.tree()))


def lm_params_to_numpy(lm: LM) -> dict:
    """``lm_params_to_tree`` as numpy: bf16 leaves come back as f32 arrays
    of the same values, which ``lm_params_from_numpy`` reads back
    exactly."""
    return cm.map_tree(lambda _, t: _numpy(t), lm_params_to_tree(lm))


def encdec_params_from_numpy(cfg: cm.ArchConfig, tree, *,
                             device="cuda") -> EncDec:
    """The reference's encoder-decoder parameters (``repro.models.encdec``
    pytree, each side's layers stacked ``[n, ...]``) as the port's
    ``EncDec`` on ``device``, one tree a layer, frozen, each leaf in
    ``cfg.dtype``."""
    dtypes = {p: s.dtype for p, s in cm.leaves(encdec_param_specs(cfg))}
    return EncDec(cfg, _encdec_from_reference(
        tree, lambda p, x: _leaf(x, dtypes[p])), device=device)


def encdec_params_to_numpy(model: EncDec) -> dict:
    """The inverse of ``encdec_params_from_numpy``: the reference's layout,
    numpy leaves (bf16 as f32 of the same values, which read back
    exactly)."""
    return cm.map_tree(lambda _, t: _numpy(t), _encdec_to_reference(
        cm.map_tree(lambda _, p: p.detach().to("cpu", copy=True),
                    model.tree())))


def opt_state_from_numpy(cfg: cm.ArchConfig, state, *,
                         device="cuda") -> OptState:
    """The reference's ``OptState`` (step, and master / m / v in its LM
    layout) as the port's, f32 trees in the port's per-layer layout on
    ``device``."""
    dev = resolve_device(device)
    src = _fields(state)

    def tree(t):
        return cm.map_tree(lambda _, x: x.to(dev), _from_reference(
            cfg, t, lambda _, x: _leaf(x, torch.float32)))

    step = src["step"]
    step = (step.detach().cpu() if isinstance(step, torch.Tensor)
            else torch.from_numpy(np.array(step, dtype=np.int32)))
    return OptState(step=step.to(torch.int32).to(dev),
                    master=tree(src["master"]), m=tree(src["m"]),
                    v=tree(src["v"]))


def opt_state_to_numpy(opt: OptState, cfg: cm.ArchConfig) -> OptState:
    """The port's ``OptState`` in the reference's layout, numpy leaves
    (step a 0-d int32): the names and bits a checkpoint of it holds."""
    def tree(t):
        return cm.map_tree(lambda _, x: _numpy(x), _to_reference(
            cfg, cm.map_tree(lambda _, x: x.detach().cpu(), t)))

    return OptState(step=_numpy(opt.step), master=tree(opt.master),
                    m=tree(opt.m), v=tree(opt.v))


def clip_params_from_numpy(tree, *, device="cuda") -> dict:
    """The reference's mini-CLIP parameters (a flat dict, f32) as the
    port's, copied onto ``device``."""
    dev = resolve_device(device)
    return {k: _leaf(v, torch.float32).to(dev) for k, v in tree.items()}


def clip_params_to_numpy(params: dict) -> dict:
    return {k: _numpy(v) for k, v in params.items()}
