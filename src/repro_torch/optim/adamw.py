"""AdamW with global-norm clipping and mixed-precision master parameters.

Port of ``repro.optim.adamw``.  Model parameters may live in bf16; the
optimizer keeps an f32 master copy and f32 moments.  Trees are the port's
parameter trees (nested dicts and lists of tensors, or an ``LM``), and
``OptState``'s ``master``, ``m`` and ``v`` have the parameters' layout
(``convert.opt_state_to_numpy`` maps them to the reference's).  Unlike
the reference's pure update, ``adamw_update`` writes the moments, the
master copy and the parameters IN PLACE under ``torch.no_grad()`` (one
copy of each in device memory); the per-leaf arithmetic is the
reference's, term by term, in f32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.models import common as cm


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor     # [] int32
    master: Any            # f32 copy of the parameters
    m: Any
    v: Any


def opt_state_specs(param_specs, ocfg: AdamWConfig) -> OptState:
    """``init_opt_state``'s shapes and dtypes as ``cm.Spec`` over a tree of
    parameter specs in either layout: f32 master and moments, an int32
    scalar step."""
    f32 = cm.map_tree(lambda _, s: cm.spec(s.shape, torch.float32),
                      param_specs)
    return OptState(step=cm.spec((), torch.int32), master=f32, m=f32, v=f32)


def init_opt_state(params, ocfg: AdamWConfig) -> OptState:
    """Master copy in f32 and zero moments, on the parameters' device."""
    tree = cm.as_tree(params)
    master = cm.map_tree(lambda _, p: p.detach().float().clone(), tree)
    zeros = lambda _, p: torch.zeros(p.shape, dtype=torch.float32,  # noqa
                                     device=p.device)
    dev = next(p for _, p in cm.leaves(tree)).device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    master=master, m=cm.map_tree(zeros, tree),
                    v=cm.map_tree(zeros, tree))


def lr_schedule(step: torch.Tensor, ocfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` of ``lr`` (f32)."""
    step = step.float()
    warm = torch.clamp(step / max(ocfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - ocfg.warmup_steps) /
                       max(ocfg.total_steps - ocfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return ocfg.lr * warm * (ocfg.min_lr_frac + (1 - ocfg.min_lr_frac) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in f32."""
    total = None
    for _, g in cm.leaves(cm.as_tree(tree)):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


_NO_DECAY_SUFFIXES = ("scale", "bias", "A_log", "D", "dt_bias", "mix_mu",
                      "decay_base", "bonus_u")


def _decay_mask(path: str) -> bool:
    """Whether the leaf at ``path`` ("layers/0/mixer/wq") takes weight
    decay: not when its name ends in one of ``_NO_DECAY_SUFFIXES``."""
    name = path.rsplit("/", 1)[-1]
    return not any(name.endswith(s) for s in _NO_DECAY_SUFFIXES)


@torch.no_grad()
def adamw_update(grads, opt: OptState, params, ocfg: AdamWConfig):
    """One step.  Writes ``opt.master`` / ``opt.m`` / ``opt.v`` and the
    parameters (cast to their own dtype) in place; returns
    ``(params, new_opt, {"grad_norm", "lr"})`` with ``new_opt.step`` the
    next step."""
    g_tree, p_tree = cm.as_tree(grads), cm.as_tree(params)
    gnorm = global_norm(g_tree)
    scale = torch.clamp(ocfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = opt.step + 1
    lr = lr_schedule(step, ocfg)
    b1, b2 = ocfg.b1, ocfg.b2
    stepf = step.float()
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    ms, vs = dict(cm.leaves(opt.m)), dict(cm.leaves(opt.v))
    mps, ps = dict(cm.leaves(opt.master)), dict(cm.leaves(p_tree))
    for path, g in cm.leaves(g_tree):
        m, v, mp = ms[path], vs[path], mps[path]
        # each term as the reference forms it, written into m, v and mp as
        # it is formed: at most three f32 temporaries of the leaf's size
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        del g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + ocfg.eps)
        if _decay_mask(path):
            upd = upd + ocfg.weight_decay * mp
        mp.sub_(lr * upd)
        del upd
        ps[path].copy_(mp.to(ps[path].dtype))
    return params, opt._replace(step=step), {"grad_norm": gnorm, "lr": lr}
