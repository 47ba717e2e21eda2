"""Fused query score + predicate bias + top-k.

Port of ``repro.kernels.query_topk.query_topk_bias_pallas``:
``score[q, n] = qs[q] . embeds[n] + bias[q, n]``, where a bias <= NEG/2
excludes slot n for query q.  Per query the top k come back ordered by
(score desc, slot asc) — ``lax.top_k``'s tie order — as ``[Q, k]`` f32
scores and i32 slots, padded with NEG / -1 past the included count.  The
declarative query engine (core/query.py) injects its predicates as NEG
bias and its proximity bonus as finite bias, so every query with an
embedding is one call of this function.

Two implementations of the same function:

  * ``query_topk_bias_cuda`` — the hand-written Hopper kernel
    (``csrc/query_topk.cu``): one launch per call, scores and per-block
    top-k in every block, the merge in the last blocks to finish.
  * ``query_topk_bias_plain`` — plain PyTorch: the reference's
    ``ref.query_topk_bias_ref`` with the kernel's tie order and padding,
    via a stable sort (``torch.topk`` promises no tie order on CUDA).

``kernels.ops.query_topk_bias`` picks by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG = -1e30
# the C interface takes 32-bit sizes; every offset inside is 64-bit
_INT_MAX = 2 ** 31 - 1

launches = 0          # kernel launches made by query_topk_bias_cuda
# two zeroed counters per (device, stream): the kernel's last blocks take
# the merge and set them back to 0, so calls on one stream share them
_tickets: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "query_topk_bias_scratch": ([_I, _I, _I, _I, _IP, _IP], _I),
    "query_topk_bias_launch": ([_P, _P, _P, _I, _I, _I, _I,
                                _P, _P, _P, _P, _P, _P, _P], _I),
}


def topk_stable(score: torch.Tensor, k: int):
    """[Q, N] scores (-inf = excluded) -> top-k ([Q, k] f32, [Q, k] i32)
    by (score desc, slot asc), excluded and missing ranks as NEG / -1."""
    Q, N = score.shape
    vals, idx = torch.sort(score, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k].to(torch.int32)
    if k > N:
        vals = torch.cat([vals, torch.full((Q, k - N), -torch.inf,
                                           device=score.device)], dim=1)
        idx = torch.cat([idx, torch.full((Q, k - N), -1, dtype=torch.int32,
                                         device=score.device)], dim=1)
    out = vals == -torch.inf
    return (torch.where(out, NEG, vals).to(torch.float32),
            torch.where(out, -1, idx))


def query_topk_bias_plain(qs: torch.Tensor, embeds: torch.Tensor,
                          bias: torch.Tensor, k: int):
    """qs [Q, E]; embeds [N, E]; bias [Q, N] -> ([Q, k] f32, [Q, k] i32)."""
    sim = qs @ embeds.T
    sim = torch.where(bias > NEG * 0.5, sim + bias, -torch.inf)
    return topk_stable(sim, k)


def query_topk_bias_cuda(qs: torch.Tensor, embeds: torch.Tensor,
                         bias: torch.Tensor, k: int):
    """The hand-written kernel (same contract as ``query_topk_bias_plain``);
    all inputs f32, contiguous, on one CUDA device; any k >= 1 (past the
    included count the ranks pad with NEG / -1)."""
    global launches
    dev = qs.device
    if dev.type != "cuda":
        raise ValueError(f"query_topk_bias_cuda needs CUDA tensors, got {dev}")
    Q, E = qs.shape
    N = embeds.shape[0]
    for name, t, shape in (("qs", qs, (Q, E)), ("embeds", embeds, (N, E)),
                           ("bias", bias, (Q, N))):
        build.check_arg("query_topk_bias", name, t, (torch.float32,), shape,
                        dev)
    if not (1 <= k <= _INT_MAX and 1 <= Q <= _INT_MAX and 1 <= N <= _INT_MAX
            and 1 <= E <= _INT_MAX):
        raise ValueError(f"query_topk_bias: unsupported Q={Q} N={N} E={E} "
                         f"k={k}")
    lib = build.load("query_topk", _SIGNATURES)
    with torch.cuda.device(dev):       # the C side plans for the current card
        nchunks, L = ctypes.c_int(), ctypes.c_int()
        err = lib.query_topk_bias_scratch(Q, N, E, int(k),
                                          ctypes.byref(nchunks),
                                          ctypes.byref(L))
        if err == -1:
            raise ValueError(f"query_topk_bias: E={E} does not fit in shared "
                             "memory")
        if err == -2:
            raise ValueError(f"query_topk_bias: Q={Q} needs more than 65535 "
                             "query tiles")
        if err != 0:
            raise RuntimeError(f"query_topk_bias plan failed: CUDA error "
                               f"{err}")
        scratch = (Q, nchunks.value, L.value)
        cand_s = torch.empty(scratch, dtype=torch.float32, device=dev)
        cand_i = torch.empty(scratch, dtype=torch.int32, device=dev)
        heads = torch.empty(scratch[:2], dtype=torch.int32, device=dev)
        vals = torch.empty((Q, k), dtype=torch.float32, device=dev)
        idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ticket = _tickets.get((dev.index, stream))
        if ticket is None:
            ticket = _tickets[(dev.index, stream)] = torch.zeros(
                2, dtype=torch.int32, device=dev)
        err = lib.query_topk_bias_launch(
            qs.data_ptr(), embeds.data_ptr(), bias.data_ptr(), Q, N, E, int(k),
            cand_s.data_ptr(), cand_i.data_ptr(), heads.data_ptr(),
            ticket.data_ptr(), vals.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"query_topk_bias kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return vals, idx
