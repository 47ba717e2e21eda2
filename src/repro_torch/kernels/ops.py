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

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lift_compact as _lc
from repro_torch.kernels import pairwise as _pw
from repro_torch.kernels import query_topk as _qt
from repro_torch.kernels import wkv6 as _wkv


def query_topk_bias(qs: torch.Tensor, embeds: torch.Tensor,
                    bias: torch.Tensor, k: int):
    """[Q, E] queries + [Q, N] score bias (<= NEG/2 = slot excluded) ->
    per-query top-k ([Q, k] f32 scores, [Q, k] i32 slots), NEG / -1 padded:
    the declarative query engine's fused predicate + score + top-k sweep."""
    if qs.device.type == "cpu":
        return _qt.query_topk_bias_plain(qs, embeds, bias, k)
    return _qt.query_topk_bias_cuda(qs, embeds, bias, k)


def query_topk_multi(qs: torch.Tensor, embeds: torch.Tensor,
                     active: torch.Tensor, k: int):
    """[Q, E] queries over the slots where ``active`` [N] is set: the
    active-mask form of ``query_topk_bias`` (bias 0 where active, NEG
    elsewhere) -> ([Q, k] f32, [Q, k] i32)."""
    bias = torch.where(active, 0.0, _qt.NEG).to(torch.float32)
    return query_topk_bias(qs, embeds,
                           bias[None, :].expand(qs.shape[0], -1).contiguous(),
                           k)


def query_topk(q: torch.Tensor, embeds: torch.Tensor, active: torch.Tensor,
               k: int):
    """The Q = 1 case of ``query_topk_multi``: q [E] -> ([k], [k])."""
    vals, idx = query_topk_multi(q[None, :], embeds, active, k)
    return vals[0], idx[0]


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


def nearest_dist(a: torch.Tensor, b: torch.Tensor,
                 b_valid: torch.Tensor) -> torch.Tensor:
    """a [M, D]; b [N, D]; b_valid [N] bool -> [M] min squared distance
    from each row of a to a valid row of b (1e30 where none is valid)."""
    if a.device.type == "cpu":
        return _pw.nearest_dist_plain(a, b, b_valid)
    return _pw.nearest_dist_cuda(a, b, b_valid)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """Grouped-query attention in the model's layout: q [B, S, H, dh],
    k [B, T, Kv, dh], v [B, T, Kv, dv] (any strides with a contiguous head
    dim; T != S only with ``causal=False`` and no window, as a
    cross-attention has it) -> [B, S, H, dv]; query head h reads kv head
    h // (H / Kv).  On
    the card (dh, dv) is one of ``flash_attention.HEAD_PAIRS``: (64, 64),
    (128, 128), (192, 128), (120, 120) or (96, 96), for the forward and
    the gradient kernel alike.

    With grad enabled and an input that requires grad it goes through
    ``FlashAttention``, whose backward is the gradient kernel at the same
    (dh, dv) (its plain version on CPU tensors); otherwise it is the
    forward alone."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _fa.FlashAttention.apply(q, k, v, causal, window, softcap)
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, **kw)
    return _fa.flash_attention_cuda(q, k, v, **kw)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """The reference's layout: q, k, v [H, S, dh] -> [H, S, dh] (one batch
    slice, one kv head per query head)."""
    out = flash_attention_bshd(*(t.transpose(0, 1)[None] for t in (q, k, v)),
                               causal=causal, window=window, softcap=softcap)
    return out[0].transpose(0, 1).contiguous()


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         lw: torch.Tensor, u: torch.Tensor, state0: torch.Tensor,
         chunk: int):
    """RWKV-6's wkv over a sequence: r, k, v, lw (the log-decay) [B, S, h,
    dh] f32, u [h, dh], state0 [B, h, dh, dh] f32 -> (y [B, S, h, dh], the
    end state).  A CPU tensor runs the chunk loop in chunks of ``chunk``;
    a CUDA tensor launches the kernel (dh = 64), which has no backward:
    ``models/rwkv.py`` calls ``wkv6_plain`` itself under grad."""
    if r.device.type == "cpu":
        return _wkv.wkv6_plain(r, k, v, lw, u, state0, chunk)
    return _wkv.wkv6_cuda(r, k, v, lw, u, state0)


def launch_counts() -> dict:
    """{kernel name: CUDA launches since the last reset}."""
    return {"lift_compact": _lc.launches, "query_topk_bias": _qt.launches,
            "flash_attention": _fa.launches,
            "flash_attention_bwd": _fa.bwd_launches,
            "nearest_dist": _pw.launches, "wkv6": _wkv.launches}


def reset_launch_counts() -> None:
    _lc.launches = 0
    _qt.launches = 0
    _fa.launches = 0
    _fa.bwd_launches = 0
    _pw.launches = 0
    _wkv.launches = 0
