"""Sharding rules of the mesh, and placement of the fleet tier's shards.

Port of ``repro.distributed.sharding``: parameters, optimizer state
(ZeRO-1), caches and inputs.  Axes: "model" is tensor / expert parallel,
"data" (and "pod" on the multi-pod mesh) data parallel.  The rules read
leaf names and the config: a dimension is sharded only where the semantic
unit (heads, kv heads, experts, d_ff) divides the axis, otherwise the leaf
is replicated (minitron's 24 heads on a 16-way model axis).

The rules work on spec trees in the reference's layout (``ModelAPI.
stacked_param_specs``, ``ModelAPI.cache_specs``, ``adamw.opt_state_specs``
over the former): stacked body periods under ``body`` / ``enc_body`` /
``dec_body`` / ``self_kv`` carry a leading period axis, which ZeRO may
shard.  A tree is dicts, lists and NamedTuples (a cache, ``OptState``)
with ``cm.Spec`` leaves, None for an absent field; a leaf's path name is
its keys, indices and field names joined by "/", as the reference's.

``P`` is a partition spec (one entry a dimension: None, an axis name or a
tuple of axis names), ``NamedSharding`` a spec on a mesh, with the shard
shape it gives a tensor.  The port's meshes are in ``launch/mesh.py``.

The fleet tier's placement (``zone_shard_devices``, ``client_shard_
affinity``) takes a ``Mesh`` or a sequence of ``torch.device``s; on one
H100 every shard maps to ``cuda:0``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.models import common as cm

DP_AXES = ("pod", "data")   # batch axes (pod present only on multi-pod mesh)


def _entry(e):
    """JAX's canonical entry: a tuple of one axis is that axis, an empty
    tuple is None."""
    if isinstance(e, tuple):
        return None if not e else e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """A partition spec: ``P("model", None)``, ``P(("data", "model"))``;
    entries canonical as in ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *names):
        return super().__new__(cls, (_entry(e) for e in names))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class NamedSharding:
    """``spec`` on ``mesh``: dimension i splits over the product of its
    entry's axis sizes."""
    mesh: Any
    spec: P

    def __post_init__(self):
        used = [a for e in self.spec for a in _axes(e)]
        unknown = set(used) - set(self.mesh.axis_names)
        if unknown or len(used) != len(set(used)):
            raise ValueError(f"spec {self.spec} on mesh axes "
                             f"{self.mesh.axis_names}")

    def shard_shape(self, shape) -> tuple:
        """The shape of one device's shard.  Raises on a dimension its axes
        do not divide, as JAX does: nothing is padded."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"shape {shape}")
        sizes = self.mesh.shape
        out = []
        for i, dim in enumerate(shape):
            e = self.spec[i] if i < len(self.spec) else None
            n = math.prod(sizes[a] for a in _axes(e))
            if dim % n:
                raise ValueError(f"dimension {i} of {shape} ({dim}) does "
                                 f"not divide over {e!r} ({n} ways) in "
                                 f"{self.spec}")
            out.append(dim // n)
        return tuple(out)


@dataclass(frozen=True)
class ShardedSpec:
    """A tensor's shape and dtype with its sharding: the counterpart of
    ``jax.ShapeDtypeStruct(shape, dtype, sharding=)``."""
    shape: tuple
    dtype: torch.dtype
    sharding: NamedSharding

    @property
    def bytes_per_device(self) -> int:
        return math.prod(self.sharding.shard_shape(self.shape)) * \
            self.dtype.itemsize


_LEAVES = (cm.Spec, P, NamedSharding, ShardedSpec, torch.Tensor)


def map_tree(fn, tree, *rest, path: tuple = ()):
    """``fn(path, leaf, *leaves of rest)`` over a spec tree (dicts, lists,
    tuples, NamedTuples; None stays None), ``rest`` trees of the same
    structure; ``path`` the names from the root."""
    if tree is None:
        return None
    if isinstance(tree, _LEAVES):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest),
                            path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest),
                                     path=path + (f,)) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest),
                                   path=path + (str(i),))
                          for i, v in enumerate(tree))
    raise TypeError(f"{'/'.join(path)}: not a spec tree node: {type(tree)}")


def leaves(tree) -> list:
    """``(path name, leaf)`` of every leaf of a spec tree."""
    out = []
    map_tree(lambda p, x: out.append(("/".join(p), x)), tree)
    return out


def dp_axes(mesh):
    return tuple(a for a in DP_AXES if a in mesh.axis_names)


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _dp(mesh) -> int:
    return int(np.prod([_axis_size(mesh, a) for a in dp_axes(mesh)])) or 1


def param_rule(name: str, shape: tuple, cfg: cm.ArchConfig, tp: int,
               dsz: int = 16) -> P:
    """PartitionSpec for one parameter leaf (shape excludes stacking dims)."""
    leaf = name.rsplit("/", 1)[-1]
    nd = len(shape)

    def pad(spec_tail: tuple) -> P:
        return P(*((None,) * (nd - len(spec_tail)) + spec_tail))

    heads_ok = cfg.n_heads % tp == 0
    kv_ok = cfg.n_kv_heads % tp == 0
    ff_ok = cfg.d_ff % tp == 0
    d_ok = cfg.d_model % tp == 0

    if leaf == "embed":
        # vocab-sharded; the shardings require exact divisibility
        return pad(("model", None)) if cfg.vocab_size % tp == 0 \
            else pad((None, "model")) if cfg.d_model % tp == 0 else pad((None, None))
    if leaf == "lm_head":
        return pad((None, "model")) if cfg.vocab_size % tp == 0 \
            else pad((None, None))
    if leaf in ("vis_proj",):
        return pad((None, None))

    # attention
    if leaf == "wq":
        return pad((None, "model")) if heads_ok else pad((None, None))
    rwkv = cfg.mixers[0] == cm.MIXER_RWKV6
    rwkv_rep = rwkv and cfg.rwkv_tm_shard == "replicated"
    if leaf in ("wk", "wv"):
        # rwkv wk/wv live under cmix/mixer too; those are d->d / d->ff
        if rwkv:
            if shape[-1] == cfg.d_ff or shape[-2] == cfg.d_ff:
                return pad((None, "model")) if ff_ok else pad((None, None))
            # time-mix d->d: the heads (40) don't divide the model axis, so
            # TP here only buys gathers around the per-head wkv recurrence;
            # serving replicates the small weights, training keeps them
            # sharded so the gradient reduction stays sharded
            if rwkv_rep:
                return pad((None, None))
            return pad((None, "model")) if d_ok else pad((None, None))
        return pad((None, "model")) if kv_ok else pad((None, None))
    if leaf == "wo":
        if rwkv:
            return pad((None, None)) if rwkv_rep else (
                pad(("model", None)) if d_ok else pad((None, None)))
        return pad(("model", None)) if heads_ok else pad((None, None))
    if leaf in ("wr", "wg"):                 # rwkv receptance/gate d->d
        if rwkv_rep and shape[-1] == cfg.d_model:
            return pad((None, None))
        return pad((None, "model")) if d_ok else pad((None, None))
    if leaf in ("q_scale", "k_scale"):
        return pad((None,))

    # MLA
    if leaf in ("wq_down", "wkv_down", "q_ln_scale", "kv_ln_scale"):
        return pad((None,) * nd)
    if leaf in ("wq_up", "wk_up", "wv_up"):
        return pad((None, "model")) if heads_ok else pad((None, None))

    # dense MLP (an RWKV wg was decided above)
    if leaf in ("wg", "wu"):
        return pad((None, "model")) if ff_ok else pad((None, None))
    if leaf == "wd":
        return pad(("model", None)) if ff_ok else pad((None, None))

    # MoE
    if leaf == "router":
        return pad((None, None))
    if leaf in ("we_g", "we_u", "we_d"):
        # Routed experts dominate MoE params (653B of deepseek-v3's 671B);
        # sharding them over "model" alone replicates them across the 16
        # data shards.  Preference order:
        #   1. full EP: experts over ("data","model") when E divides dp*tp
        #   2. 2D: experts over "model", expert-ff over "data"
        #   3. model-only (small expert counts)
        E = cfg.moe.n_experts
        f = cfg.moe.d_ff_expert
        if cfg.moe_weight_shard == "ep" and E % (tp * dsz) == 0:
            return pad((("data", "model"), None, None))
        fdim = 2 if leaf in ("we_g", "we_u") else 1
        if E % tp == 0 and f % dsz == 0:
            names = [None, None, None]
            names[0] = "model"
            names[fdim] = "data"
            return pad(tuple(names))
        return pad(("model", None, None)) if E % tp == 0 else pad((None,) * nd)
    if leaf in ("ws_g", "ws_u"):
        fs = cfg.moe.n_shared * cfg.moe.d_ff_expert
        return pad((None, "model")) if fs % tp == 0 else pad((None, None))
    if leaf == "ws_d":
        fs = cfg.moe.n_shared * cfg.moe.d_ff_expert
        return pad(("model", None)) if fs % tp == 0 else pad((None, None))

    # mamba (d_inner = expand * d_model, sharded over model)
    if leaf == "in_proj":
        return pad((None, "model")) if d_ok else pad((None, None))
    if leaf in ("conv_w", "x_proj", "out_proj", "A_log"):
        return pad(("model",) + (None,) * (nd - 1)) if d_ok else pad((None,) * nd)
    if leaf == "dt_proj":
        return pad((None, "model")) if d_ok else pad((None, None))
    if leaf in ("conv_bias", "dt_bias", "D"):
        return pad(("model",)) if d_ok else pad((None,))

    # rwkv misc — all feed the head-grouped recurrence (see wk/wv note)
    if leaf in ("decay_w1", "mix_w1", "bonus_u"):
        return pad((None,) * nd)
    if leaf == "decay_w2":
        return pad((None, None)) if rwkv_rep else (
            pad((None, "model")) if d_ok else pad((None, None)))
    if leaf == "mix_w2":
        return pad((None,) * nd) if rwkv_rep else (
            pad((None, None, "model")) if d_ok else pad((None,) * nd))

    # norms / scalars / token-shift mus
    return pad((None,) * nd)


def _stacked(name: str) -> int:
    """Number of leading stacking dims (a stacked period adds one).  Works
    for parameter paths and optimizer-state paths (master/body/...)."""
    parts = name.split("/")[:-1]
    return 1 if any(p in ("body", "enc_body", "dec_body", "self_kv")
                    for p in parts) else 0


def param_pspecs(cfg: cm.ArchConfig, specs, mesh):
    tp = _axis_size(mesh, "model")
    dsz = _axis_size(mesh, "data")

    def rule(path, leaf):
        name = "/".join(path)
        k = _stacked(name)
        inner = param_rule(name, leaf.shape[k:], cfg, tp, dsz)
        return P(*((None,) * k + tuple(inner)))

    return map_tree(rule, specs)


def zero_pspecs(cfg: cm.ArchConfig, specs, mesh):
    """Optimizer-state sharding: the parameter sharding plus ZeRO-1 over the
    data axis on the first unsharded dimension that divides."""
    base = param_pspecs(cfg, specs, mesh)
    dsize = _axis_size(mesh, "data")

    def add_zero(_, leaf, ps: P):
        ndim = len(leaf.shape)
        if ndim == 0:
            return P()
        names = list(ps) + [None] * (ndim - len(ps))
        used = set()
        for n in names:
            used.update(_axes(n))
        if "data" in used:
            return P(*names)
        for i, (n, dim) in enumerate(zip(names, leaf.shape)):
            if n is None and dim % dsize == 0 and dim >= dsize:
                names[i] = "data"
                break
        return P(*names)

    return map_tree(add_zero, specs, base)


def cache_pspecs(cfg: cm.ArchConfig, cache_specs, mesh, *,
                 global_batch: int):
    """KV / state cache sharding.  Batch over the data axes when it
    divides; otherwise (a long-context batch of 1) the sequence axis over
    "data", heads over "model"."""
    tp = _axis_size(mesh, "model")
    dp = _dp(mesh)
    batch_ok = global_batch % dp == 0 and global_batch >= dp
    kv_ok = cfg.n_kv_heads % tp == 0
    dpa = dp_axes(mesh)

    def rule(path, leaf):
        name = "/".join(path)
        k = _stacked(name)
        shape = leaf.shape[k:]
        nd = len(shape)
        leafname = name.rsplit("/", 1)[-1]
        names: list = [None] * nd
        if nd == 0:
            return P(*((None,) * k))
        if leafname in ("k", "v", "k_scale", "v_scale"):  # KVCache [B,T,Kv,*]
            if batch_ok:
                names[0] = dpa
            elif shape[1] % _axis_size(mesh, "data") == 0 and shape[1] > 1:
                names[1] = "data"
            if kv_ok:
                names[2] = "model"
            elif names[1] is None and shape[1] % tp == 0 and shape[1] > tp:
                # kv heads don't divide tp: a sequence-parallel cache on the
                # model axis (flash-decoding-style partial softmax combine)
                names[1] = "model"
        elif leafname in ("c_kv", "k_rope"):  # MLA [B,T,r]
            if batch_ok:
                names[0] = dpa
            elif shape[1] % _axis_size(mesh, "data") == 0:
                names[1] = "data"
        elif leafname == "conv":              # [B,K-1,d_in]
            if batch_ok:
                names[0] = dpa
            if cfg.d_model % tp == 0:
                names[2] = "model"
        elif leafname == "ssm":               # [B,d_in,N]
            if batch_ok:
                names[0] = dpa
            if cfg.d_model % tp == 0:
                names[1] = "model"
        elif leafname in ("tm_prev", "cm_prev"):
            if batch_ok:
                names[0] = dpa
        elif leafname == "state":             # rwkv [B,h,dk,dv]
            if batch_ok:
                names[0] = dpa
            if cfg.n_heads % tp == 0:
                names[1] = "model"
        elif leafname in ("cross_k", "cross_v"):  # [L,B,S,H,dh]
            if batch_ok:
                names[1] = dpa
            if cfg.n_heads % tp == 0:
                names[3] = "model"
            return P(*names)                  # L dim already included
        return P(*((None,) * k + tuple(names)))

    return map_tree(rule, cache_specs)


def input_pspecs(cfg: cm.ArchConfig, specs, mesh, *, global_batch: int):
    dp = _dp(mesh)
    batch_ok = global_batch % dp == 0 and global_batch >= dp
    dpa = dp_axes(mesh)

    def rule(path, leaf):
        names = [None] * len(leaf.shape)
        if names and batch_ok:
            names[0] = dpa
        return P(*names)

    return map_tree(rule, specs)


def shardings_of(pspecs, mesh):
    return map_tree(lambda _, ps: NamedSharding(mesh, ps), pspecs)


def zone_shard_devices(mesh, n_zones: int) -> list:
    """Round-robin device placement for the fleet server's spatial zone
    shards (server/zones.py): zone z lives on mesh device z % ndev, so
    per-zone sync collects and queries run where the shard's tensors live.
    ``mesh`` is a ``Mesh`` or a sequence of devices."""
    devs = mesh.devices.flat if hasattr(mesh, "devices") else mesh
    devs = [torch.device(d) for d in devs]
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
