"""Public kernel entry points, picked by the tensors' device.

Where ``repro.kernels.ops`` picks the Pallas kernel or its XLA formulation
by JAX backend, the port picks by where the input lies: a CUDA tensor
launches the hand-written kernel (or raises — there is no fallback), a CPU
tensor runs the plain PyTorch version.  Each CUDA wrapper counts its
launches in a plain integer, so a run can show that the main path really
went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import lift_compact as _lc
from repro_torch.kernels import query_topk as _qt


def query_topk_bias(qs: torch.Tensor, embeds: torch.Tensor,
                    bias: torch.Tensor, k: int):
    """[Q, E] queries + [Q, N] score bias (<= NEG/2 = slot excluded) ->
    per-query top-k ([Q, k] f32 scores, [Q, k] i32 slots), NEG / -1 padded:
    the declarative query engine's fused predicate + score + top-k sweep."""
    if qs.device.type == "cpu":
        return _qt.query_topk_bias_plain(qs, embeds, bias, k)
    return _qt.query_topk_bias_cuda(qs, embeds, bias, k)


def lift_compact(depth: torch.Tensor, masks: torch.Tensor,
                 intrinsics: torch.Tensor, pose: torch.Tensor, *,
                 stride: int = 1, budget: int, lift_cap: int = 4096):
    """Fused frame-ingest geometry: lift -> compact -> downsample -> stats
    for all D detections in one pass.  Returns (points [D, budget, 3],
    n [D] i32, centroid [D, 3], bbox_min [D, 3], bbox_max [D, 3])."""
    kw = dict(stride=stride, budget=budget, lift_cap=lift_cap)
    if depth.device.type == "cpu":
        return _lc.lift_compact_plain(depth, masks, intrinsics, pose, **kw)
    return _lc.lift_compact_cuda(depth, masks, intrinsics, pose, **kw)


def launch_counts() -> dict:
    """{kernel name: CUDA launches since the last reset}."""
    return {"lift_compact": _lc.launches, "query_topk_bias": _qt.launches}


def reset_launch_counts() -> None:
    _lc.launches = 0
    _qt.launches = 0
