"""The train step, without the mesh.

Port of the train step of ``repro.launch.steps.build_train_step``: loss
and gradients of ``model_api(cfg).loss``, optionally over ``cfg.grad_accum``
microbatches, then ``adamw_update``.  The reference also attaches the
mesh's parameter, ZeRO and input shardings and builds the prefill and
decode steps; those wait for a later slice (ROADMAP.md section 2 item 4).
The step runs eagerly on whatever device the parameters and the batch lie
on, and updates the parameters and the optimizer state in place.
"""
from __future__ import annotations

import torch

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
