"""Step functions, with and without the mesh's shardings.

Port of ``repro.launch.steps``.  ``build_train_step(cfg, ocfg)`` is the
train step without a mesh: loss and gradients of ``model_api(cfg).loss``,
optionally over ``cfg.grad_accum`` microbatches, then ``adamw_update``;
it runs eagerly on whatever device the parameters and the batch lie on,
and updates the parameters and the optimizer state in place.

``build_step(cfg, mesh, cell)`` builds the train, prefill or decode step
of a shape cell on a mesh (``launch/mesh.py``) and returns ``(step,
args)``.  ``args`` are trees of ``ShardedSpec`` in the reference's layout
(stacked body periods), each with the ``NamedSharding`` that the
parameter, ZeRO, cache and input rules give it: the counterpart of the
reference's ``ShapeDtypeStruct(..., sharding=)`` trees, which the dry run
reads.  ``step`` is a ``Step``: calling it runs the mesh-free function
(``build_train_step``, ``ModelAPI.prefill`` / ``decode``) eagerly on the
port's own trees (an ``LM`` or ``EncDec``, an ``OptState`` and caches one
a layer), after checking that every tensor lies on the mesh's one device.
A mesh of more than one device, or a planning mesh, can be planned but not
run: calling its step raises.  ``Step.out`` holds the outputs' sharded
specs and ``Step.donated`` the argument each output may reuse, as the
reference donates the parameters and optimizer state in train and the
caches in prefill and decode (the port writes those in place instead).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ShapeCell, input_specs
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P, NamedSharding, ShardedSpec
from repro_torch.launch.mesh import Mesh
from repro_torch.models import common as cm
from repro_torch.models.api import model_api
from repro_torch.optim import adamw


def loss_and_grads(loss_fn, params, batch: dict, accum: int = 1):
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch) -> (loss,
    metrics)``.  Grads are a tree like the parameters; a leaf the loss
    does not use (``vis_proj`` under a tokens-only batch) gets zeros of
    its own dtype, as ``jax.grad`` gives it.  With ``accum > 1`` every
    leaf of the batch (``tokens``, and ``extra_embeds`` or ``frames``
    where present) splits into ``accum`` microbatches along its leading
    axis: the grads are their f32
    sum divided by ``accum``, the loss is the mean, and the metrics are
    the last microbatch's."""
    tree = cm.as_tree(params)
    paths, leaves = zip(*cm.leaves(tree))

    def one(mb):
        loss, metrics = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    if accum <= 1:
        loss, metrics, grads = one(batch)
    else:
        micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                 for k, v in batch.items()}
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for a in range(accum):
            loss, metrics, g = one({k: v[a] for k, v in micro.items()})
            gsum = [s + gi.float() for s, gi in zip(gsum, g)]
            lsum = lsum + loss
        grads = [g / accum for g in gsum]
        loss = lsum / accum
    by_path = dict(zip(paths, grads))
    return loss, metrics, cm.map_tree(lambda p, _: by_path[p], tree)


def build_train_step(cfg: cm.ArchConfig,
                     ocfg: adamw.AdamWConfig = adamw.AdamWConfig()):
    """``step(params, opt, batch) -> (params, opt, metrics)``: one AdamW
    step on ``model_api(cfg).loss``, over ``cfg.grad_accum`` microbatches;
    metrics are the loss's (``ce``, ``aux``), ``grad_norm``, ``lr`` and
    ``loss``."""
    api = model_api(cfg)
    accum = max(cfg.grad_accum, 1)

    def train_step(params, opt, batch):
        loss, metrics, grads = loss_and_grads(api.loss, params, batch, accum)
        params, opt, om = adamw.adamw_update(grads, opt, params, ocfg)
        return params, opt, {**metrics, **om, "loss": loss}

    return train_step


# ---------------------------------------------------------------------------
# Steps on a mesh
# ---------------------------------------------------------------------------

METRICS = ("ce", "aux", "grad_norm", "lr", "loss")   # the train step's


def arg_tensors(tree):
    """Every tensor of a step argument: a tensor, an ``LM`` / ``EncDec``,
    dicts, lists and (Named)tuples of them; other leaves (``pos``) hold
    none."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, cm.ParamTree):
        yield from arg_tensors(tree.tree())
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from arg_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from arg_tensors(v)


class Step:
    """A step function built for ``mesh``; see the module docstring."""

    def __init__(self, fn, mesh, *, out: tuple, donated: tuple):
        self.fn, self.mesh, self.out, self.donated = fn, mesh, out, donated

    def __call__(self, *args):
        mesh = self.mesh
        if not isinstance(mesh, Mesh) or mesh.size != 1:
            raise RuntimeError(
                f"a step on the mesh {dict(mesh.shape)} can be planned but "
                "not run: the port runs steps on a one-device host mesh")
        dev = mesh.devices.flat[0]
        for t in arg_tensors(args):
            if t.device != dev:
                raise ValueError(f"a step argument lies on {t.device}, not "
                                 f"on the mesh's device {dev}")
        return self.fn(*args)


def _ns(mesh, pspecs):
    return sh.shardings_of(pspecs, mesh)


def _sharded(specs, shardings):
    return sh.map_tree(lambda _, s, ns: ShardedSpec(s.shape, s.dtype, ns),
                       specs, shardings)


def _logits_pspec(mesh, global_batch: int, vocab: int) -> P:
    dpa = sh.dp_axes(mesh)
    dp = int(np.prod([mesh.shape[a] for a in dpa])) or 1
    batch = dpa if (global_batch % dp == 0 and global_batch >= dp) else None
    v = "model" if vocab % mesh.shape["model"] == 0 else None
    return P(batch, v)


def _logits_spec(cfg: cm.ArchConfig, mesh, cell: ShapeCell) -> ShardedSpec:
    """Last-position logits [B, V]: the model dtype, f32 under a final
    softcap."""
    dt = torch.float32 if cfg.final_logit_softcap else cfg.dtype
    return ShardedSpec((cell.global_batch, cfg.vocab_size), dt, NamedSharding(
        mesh, _logits_pspec(mesh, cell.global_batch, cfg.vocab_size)))


def build_sharded_train_step(cfg: cm.ArchConfig, mesh, cell: ShapeCell,
                             ocfg: adamw.AdamWConfig = adamw.AdamWConfig()):
    """``(step, (params, opt, batch) specs)``: ``build_train_step`` with the
    parameter, ZeRO and input shardings."""
    api = model_api(cfg)
    pspecs = api.stacked_param_specs()
    ospecs = adamw.opt_state_specs(pspecs, ocfg)
    ispecs = input_specs(cfg, cell)

    p_sh = _ns(mesh, sh.param_pspecs(cfg, pspecs, mesh))
    o_sh = _ns(mesh, sh.zero_pspecs(cfg, ospecs, mesh))
    i_sh = _ns(mesh, sh.input_pspecs(cfg, ispecs, mesh,
                                     global_batch=cell.global_batch))
    args = (_sharded(pspecs, p_sh), _sharded(ospecs, o_sh),
            _sharded(ispecs, i_sh))
    rep = NamedSharding(mesh, P())
    metrics = {k: ShardedSpec((), torch.float32, rep) for k in METRICS}
    step = Step(build_train_step(cfg, ocfg), mesh,
                out=(args[0], args[1], metrics), donated=((0, 0), (1, 1)))
    return step, args


def _serving_specs(cfg: cm.ArchConfig, mesh, cell: ShapeCell):
    api = model_api(cfg)
    pspecs = api.stacked_param_specs()
    ispecs = input_specs(cfg, cell)
    cspecs = api.cache_specs(cell.global_batch, cell.seq_len)
    B = cell.global_batch
    p_sh = _ns(mesh, sh.param_pspecs(cfg, pspecs, mesh))
    i_sh = _ns(mesh, sh.input_pspecs(cfg, ispecs, mesh, global_batch=B))
    c_sh = _ns(mesh, sh.cache_pspecs(cfg, cspecs, mesh, global_batch=B))
    return (api, _sharded(pspecs, p_sh), _sharded(ispecs, i_sh),
            _sharded(cspecs, c_sh))


def build_prefill_step(cfg: cm.ArchConfig, mesh, cell: ShapeCell):
    """``(step, (params, batch, caches) specs)``; ``step(params, batch,
    caches) -> (logits [B, V], caches)``.  The encoder-decoder's cross k /
    v come back at the frames' length, not the cache's ``enc_seq``."""
    api, params, batch, caches = _serving_specs(cfg, mesh, cell)
    out_caches = caches
    if cfg.encdec:
        def at_frames(s):
            shape = s.shape[:2] + (cell.seq_len,) + s.shape[3:]
            return ShardedSpec(shape, s.dtype, s.sharding)
        out_caches = caches._replace(cross_k=at_frames(caches.cross_k),
                                     cross_v=at_frames(caches.cross_v))

    def prefill_step(params, batch, caches):
        return api.prefill(params, batch, caches)

    step = Step(prefill_step, mesh,
                out=(_logits_spec(cfg, mesh, cell), out_caches),
                donated=((2, 1),))
    return step, (params, batch, caches)


def build_decode_step(cfg: cm.ArchConfig, mesh, cell: ShapeCell):
    """``(step, (params, tokens, caches, pos) specs)``; ``step(params,
    tokens, caches, pos) -> (logits [B, V], caches)``."""
    api, params, batch, caches = _serving_specs(cfg, mesh, cell)

    def decode_step(params, tokens, caches, pos):
        return api.decode(params, tokens, caches, pos)

    pos = ShardedSpec((), torch.int32, NamedSharding(mesh, P()))
    step = Step(decode_step, mesh, out=(_logits_spec(cfg, mesh, cell), caches),
                donated=((2, 1),))
    return step, (params, batch["tokens"], caches, pos)


def build_step(cfg: cm.ArchConfig, mesh, cell: ShapeCell):
    if cell.kind == "train":
        return build_sharded_train_step(cfg, mesh, cell)
    if cell.kind == "prefill":
        return build_prefill_step(cfg, mesh, cell)
    return build_decode_step(cfg, mesh, cell)


def bytes_per_device(tree) -> int:
    """The bytes one device holds of a tree of ``ShardedSpec``."""
    return sum(s.bytes_per_device for _, s in sh.leaves(tree))
