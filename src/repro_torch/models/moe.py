"""Mixture-of-Experts FFN: shared + routed top-k experts.

Port of ``repro.models.moe``.  Dispatch is sort-based and
capacity-bounded: each group ranks its token copies within their expert
(a stable sort by expert id and segment arithmetic), scatters them into an
``[E, C, d]`` buffer, runs the expert products as batched matmuls and
gathers back.  The reference computes those products with XLA outside any
Pallas kernel, so here they are library batched matmuls.

Where the frameworks part ways, the port follows the reference's rules:

  * the router is f32 (``x.float() @ router``; resolving a CUDA device
    turns TF32 off) and its top-k breaks ties to the lower expert, as
    ``jax.lax.top_k`` does: a stable descending sort, never
    ``torch.topk``, whose order of equal values CUDA does not promise;
  * the rank within an expert comes from a stable argsort, as
    ``jnp.argsort`` is stable, so the same copies go past capacity;
  * copies past capacity scatter into a padding row ``E * C`` of the
    buffer (the reference's ``mode="drop"``) and gather zeros from it;
  * the k contributions to a token are added in the model dtype in the
    order j = 0 .. k-1, as ``segment_sum`` adds them, with no
    ``index_add_`` (whose order on the card is not deterministic).

Training differentiates this dispatch with autograd, as the reference
differentiates its own with ``jax.grad``: x reaches the gradient through
the scatter into the buffer and the gather out of it, the experts through
the batched products, and the router through the renormalised top-k
weights and the aux loss's mean probabilities (the top-1 counts are
one-hot and carry none).  A dropped copy writes the padding row and reads
zeros, so it carries no gradient; every other slot is written and read
once, so the backward adds in a fixed order and two steps give the same
bits on the card.

Each call runs under three spans of ``repro_torch.obs`` (category
``model``): ``moe.dispatch`` (the route with its aux loss, then each
group's rank and scatter), ``moe.experts`` (each group's three batched
products) and ``moe.combine`` (each group's gather, weighting and k-sum,
then the concatenation of groups).  With a metrics registry installed it
counts, under ``phase`` "decode" (S == 1) or "prefill",
``moe_copies_total`` (T * k), ``moe_expert_rows_total`` (the E * C rows
each group's products compute) and ``moe_copies_kept_total`` (copies
within capacity, a device value: no host read).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import span


def moe_param_specs(cfg: cm.ArchConfig) -> dict:
    mo = cfg.moe
    d, E, f = cfg.d_model, mo.n_experts, mo.d_ff_expert
    p = {
        "router": cm.spec((d, E), mo.router_dtype),
        "we_g": cm.spec((E, d, f), cfg.dtype),
        "we_u": cm.spec((E, d, f), cfg.dtype),
        "we_d": cm.spec((E, f, d), cfg.dtype),
    }
    if mo.n_shared:
        fs = mo.n_shared * f
        p["ws_g"] = cm.spec((d, fs), cfg.dtype)
        p["ws_u"] = cm.spec((d, fs), cfg.dtype)
        p["ws_d"] = cm.spec((fs, d), cfg.dtype)
    return p


def expert_capacity(tokens_per_group: int, cfg: cm.ArchConfig) -> int:
    mo = cfg.moe
    c = math.ceil(tokens_per_group * mo.top_k * mo.capacity_factor
                  / mo.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to multiple of 8


class MoEStats(NamedTuple):
    aux_loss: torch.Tensor       # Switch-style load-balance loss, f32 0-d
    dropped_frac: torch.Tensor   # fraction of token copies over capacity


def _route(params, x2d: torch.Tensor, cfg: cm.ArchConfig):
    """x2d: [T, d] -> (weights [T, k] f32, experts [T, k] int64,
    probs [T, E] f32); equal probabilities go to the lower expert."""
    logits = x2d.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :cfg.moe.top_k], idx[:, :cfg.moe.top_k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx, probs


def _group_dispatch(xg: torch.Tensor, wg_: torch.Tensor, idxg: torch.Tensor,
                    params, cfg: cm.ArchConfig, C: int, *,
                    phase: str = "prefill"):
    """One group. xg: [Tg, d]; wg_ / idxg: [Tg, k] -> (y [Tg, d], the
    group's dropped fraction).  With a registry installed, its copies
    within capacity count under ``phase``."""
    mo = cfg.moe
    E, k = mo.n_experts, mo.top_k
    Tg, d = xg.shape
    Tk = Tg * k
    dev = xg.device
    with span("moe.dispatch", "model"):
        flat_e = idxg.reshape(Tk)
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        counts = torch.bincount(flat_e, minlength=E)
        starts = torch.cumsum(counts, 0) - counts
        rank_sorted = torch.arange(Tk, device=dev) - starts[sorted_e]
        rank = torch.empty_like(rank_sorted)
        rank[order] = rank_sorted
        keep = rank < C
        slot = torch.where(keep, flat_e * C + rank, E * C)  # padding row
        # each token's k copies as an expand (not xg[tok]): its gradient
        # sums the copies in a fixed order, where an indexed read's
        # accumulates through an index_put_ that CUDA does not keep in order
        buf = torch.zeros((E * C + 1, d), dtype=xg.dtype, device=dev)
        buf[slot] = xg[:, None].expand(Tg, k, d).reshape(Tk, d)
        buf = buf[:E * C].reshape(E, C, d)

    with span("moe.experts", "model"):
        act = cm.act_fn(cfg.act)
        h = act(torch.bmm(buf, params["we_g"])) * torch.bmm(buf,
                                                            params["we_u"])
        out_buf = F.pad(torch.bmm(h, params["we_d"]).reshape(E * C, d),
                        (0, 0, 0, 1))                     # row E*C reads 0

    with span("moe.combine", "model"):
        gathered = out_buf[slot]                          # [Tk, d]
        contrib = (gathered * (wg_.reshape(Tk, 1) * keep[:, None]).to(
            gathered.dtype)).reshape(Tg, k, d)
        y = contrib[:, 0]
        for j in range(1, k):
            y = y + contrib[:, j]
        dropped = 1.0 - keep.float().mean()
    reg = get_registry()
    if reg is not None:
        reg.counter("moe_copies_kept_total").inc(keep.sum(), phase=phase)
    return y, dropped


def moe_apply(params, x: torch.Tensor, cfg: cm.ArchConfig, *,
              n_groups: int = 1):
    """x: [B, S, d]. Returns (y, MoEStats).  Tokens are split into the
    largest number of groups up to ``n_groups`` that divides B * S; each
    group ranks and drops its copies on its own."""
    mo = cfg.moe
    B, S, d = x.shape
    T = B * S
    x2d = x.reshape(T, d)
    E = mo.n_experts
    with span("moe.dispatch", "model"):
        w, idx, probs = _route(params, x2d, cfg)
        # Switch load-balance aux loss over the full batch
        me = probs.mean(dim=0)                                   # [E]
        ce = F.one_hot(idx[:, 0], E).float().mean(dim=0)
        aux = E * torch.sum(me * ce)

    g = n_groups
    while T % g:
        g -= 1
    Tg = T // g
    C = expert_capacity(Tg, cfg)
    phase = "decode" if S == 1 else "prefill"
    reg = get_registry()
    if reg is not None:
        reg.counter("moe_copies_total").inc(T * mo.top_k, phase=phase)
        reg.counter("moe_expert_rows_total").inc(g * E * C, phase=phase)
    ys, dropped = [], []
    for i in range(g):
        sl = slice(i * Tg, (i + 1) * Tg)
        y_i, drop_i = _group_dispatch(x2d[sl], w[sl], idx[sl], params, cfg,
                                      C, phase=phase)
        ys.append(y_i)
        dropped.append(drop_i)
    with span("moe.combine", "model"):
        y = torch.cat(ys).reshape(B, S, d)

    if mo.n_shared:
        act = cm.act_fn(cfg.act)
        shared = act(x @ params["ws_g"]) * (x @ params["ws_u"])
        y = y + shared @ params["ws_d"]
    return y, MoEStats(aux_loss=aux,
                       dropped_frac=torch.stack(dropped).mean())
