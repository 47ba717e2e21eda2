"""Gradient compression with error feedback.

Port of ``repro.distributed.collectives``: per-tensor symmetric int8
quantization with an f32 residual that carries each step's quantization
error into the next (error feedback).  The dequantized values are what
enter the optimizer, so the wire format would be int8 plus one f32 scale
per tensor.  Trees are the port's parameter trees.  ``torch.round`` and
``jnp.round`` both round half to even, so on equal inputs q and the scale
are equal bit for bit.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import common as cm


class EFState(NamedTuple):
    residual: Any          # tree like the gradients (f32)


def init_ef(grads_like) -> EFState:
    return EFState(residual=cm.map_tree(
        lambda _, g: torch.zeros(g.shape, dtype=torch.float32,
                                 device=g.device), cm.as_tree(grads_like)))


def compress_int8(g: torch.Tensor):
    """Per-tensor symmetric int8 quantization. Returns (q, scale)."""
    amax = torch.amax(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads_ef(grads, ef: EFState):
    """Quantize grads + residual to int8; the new residual is what the
    quantization lost.  Returns (dequantized grads, new EFState)."""
    res = dict(cm.leaves(ef.residual))
    deq, new_res = {}, {}
    for path, g in cm.leaves(cm.as_tree(grads)):
        x = g.float() + res[path]
        q, s = compress_int8(x)
        deq[path] = decompress_int8(q, s)
        new_res[path] = x - deq[path]
    tree = cm.as_tree(grads)
    return (cm.map_tree(lambda p, _: deq[p], tree),
            EFState(residual=cm.map_tree(lambda p, _: new_res[p], tree)))


def compressed_bytes(grads) -> int:
    """Wire bytes if shipped as int8 plus one f32 scale per tensor."""
    gs = [g for _, g in cm.leaves(cm.as_tree(grads))]
    return sum(g.numel() for g in gs) + 4 * len(gs)
