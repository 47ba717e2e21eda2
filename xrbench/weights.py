"""Seeded model weights, drawn the same way for the program and the reference.

A model's layout is a tree (nested dicts) of ``Leaf`` specs, grouped: the
``top`` group (embedding, final norm, head) and one group a layer.  Each
group is drawn from its own generator, seeded from ``(seed, group index)``,
on the device, in at most three large calls: one ``randn`` in bf16 for the
bf16 normal leaves, one ``randn`` in f32 for the f32 normal leaves and one
``rand`` in f32 for the uniform-derived leaves.  Leaves are views into
those flat buffers (each starting at a 256-byte boundary), scaled in place.
So a group can be drawn again alone, bit for bit: the reference redraws
one layer at a time once the program's weights are freed.

The rules are the benchmark's own, chosen so that the residual stream
keeps a unit scale and the logits come out about N(0, 1) at any width:
normal leaves are N(0, 1) / sqrt(fan_in), and the matrices that write into
the residual stream (each mixer's and MLP's output projection) carry the
gain 1 / sqrt(2 n_layers) more, the GPT-2 and Mamba initialisations' rule.
Without it a deep random model is chaotic: a bf16 rounding in its first
layers changes most of its greedy tokens by the last.  Norm scales (used
as 1 + scale) and biases are zero; Mamba's ``A_log`` is log(1 .. d_state)
and ``D`` one;
``dt_bias`` is the inverse softplus of a step log-uniform on [1e-3, 0.1]
(Mamba's own rule); RWKV's ``decay_base`` is -6 + 5 (i / (d - 1)) ** 0.7,
its token-shift mixes uniform on [0.3, 0.7) and its bonus uniform on
[0, 1).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

ALIGN = 128          # elements: 256 bytes of bf16, 512 of f32


@dataclass(frozen=True)
class Leaf:
    shape: tuple
    dtype: str = "bf16"              # "bf16" | "f32"
    init: str = "normal"             # normal | zeros | ones | A_log | dt_bias
                                     # | uniform | decay_base
    fan_in: int | None = None        # normal: default shape[-2] (or shape[0])
    gain: float = 1.0                # normal: times gain / sqrt(fan_in)
    lo: float = 0.0                  # uniform
    hi: float = 1.0


DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def out_gain(n_layers: int) -> float:
    """The extra gain of a residual-stream output projection."""
    return 1.0 / math.sqrt(2 * n_layers)


def group_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for group ``index`` (-1 is ``top``) of a
    model drawn from ``seed``."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + (index + 2) * 0xBF58476D1CE4E5B9)
    x ^= x >> 31
    return x % (1 << 63)


def leaves(tree, path=()):
    """(path tuple, Leaf) in the layout's own order."""
    for k, v in tree.items():
        if isinstance(v, Leaf):
            yield path + (k,), v
        else:
            yield from leaves(v, path + (k,))


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _pool(leaf: Leaf) -> str | None:
    if leaf.init == "normal":
        return "normal_" + leaf.dtype
    if leaf.init in ("dt_bias", "uniform"):
        return "uniform"
    return None


def _round(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def draw_group(group: dict, seed: int, index: int, device) -> dict:
    """The tensors of one group (a nested dict shaped like ``group``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, index))
    items = list(leaves(group))
    sizes = {"normal_bf16": 0, "normal_f32": 0, "uniform": 0}
    offs = []
    for _, lf in items:
        pool = _pool(lf)
        offs.append(sizes[pool] if pool else None)
        if pool:
            sizes[pool] += _round(math.prod(lf.shape))
    flat = {}
    if sizes["normal_bf16"]:
        flat["normal_bf16"] = torch.randn(sizes["normal_bf16"],
                                          dtype=torch.bfloat16,
                                          device=device, generator=gen)
    if sizes["normal_f32"]:
        flat["normal_f32"] = torch.randn(sizes["normal_f32"],
                                         dtype=torch.float32, device=device,
                                         generator=gen)
    if sizes["uniform"]:
        flat["uniform"] = torch.rand(sizes["uniform"], dtype=torch.float32,
                                     device=device, generator=gen)
    out: dict = {}
    for (path, lf), off in zip(items, offs):
        dt = DTYPES[lf.dtype]
        n = math.prod(lf.shape)
        if lf.init == "normal":
            w = flat["normal_" + lf.dtype][off:off + n].view(lf.shape)
            fan = lf.fan_in or (lf.shape[-2] if len(lf.shape) >= 2
                                else lf.shape[0])
            w.mul_(lf.gain / math.sqrt(fan))
        elif lf.init == "zeros":
            w = torch.zeros(lf.shape, dtype=dt, device=device)
        elif lf.init == "ones":
            w = torch.ones(lf.shape, dtype=dt, device=device)
        elif lf.init == "A_log":
            n_state = lf.shape[-1]
            row = torch.log(torch.arange(1, n_state + 1, dtype=torch.float64))
            w = row.to(dt).to(device).expand(lf.shape).contiguous()
        elif lf.init == "decay_base":
            d = lf.shape[-1]
            f = torch.arange(d, dtype=torch.float64) / max(d - 1, 1)
            w = (-6.0 + 5.0 * f ** 0.7).to(dt).to(device).expand(
                lf.shape).contiguous()
        elif lf.init == "uniform":
            u = flat["uniform"][off:off + n].view(lf.shape)
            w = u.mul_(lf.hi - lf.lo).add_(lf.lo).to(dt)
        elif lf.init == "dt_bias":
            u = flat["uniform"][off:off + n].view(lf.shape)
            lo, hi = math.log(1e-3), math.log(1e-1)
            step = torch.exp(u * (hi - lo) + lo).clamp_(min=1e-4)
            w = (step + torch.log(-torch.expm1(-step))).to(dt)
        else:
            raise ValueError(f"unknown init {lf.init!r}")
        _set(out, path, w)
    return out


def draw_model(layout: dict, seed: int, device) -> dict:
    """Every group of ``layout`` ({"top": group, "layers": [group, ...]}):
    the top group's tensors with ``layers`` a list of the layers'."""
    tree = draw_group(layout["top"], seed, -1, device)
    tree["layers"] = [draw_group(g, seed, i, device)
                      for i, g in enumerate(layout["layers"])]
    return tree
