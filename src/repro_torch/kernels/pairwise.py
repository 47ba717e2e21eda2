"""Nearest valid neighbour distance (the association / chamfer primitive).

Port of ``repro.kernels.pairwise.nearest_dist_pallas`` behind
``repro.kernels.ops.nearest_dist``: for a ``[M, D]`` and b ``[N, D]`` with
``b_valid [N]``, ``out[i] = min over valid j of |a_i|^2 + |b_j|^2 -
2 a_i . b_j`` in f32 (the kernel's expansion, which rounds differently from
``(a - b)^2``), and ``INF = 1e30`` for a row with no valid b: the Pallas
kernel's value, where ``ref.nearest_dist_ref`` gives ``inf``.  The
reference pads D to 8 lanes with zeros, which changes no sum; the port
takes D as it is (D <= 8 for the kernel).

No path of the system calls it: ``association_scores`` keeps its own
arithmetic, so the entry point is the whole path.

Two implementations of the same function:

  * ``nearest_dist_cuda`` — the hand-written Hopper kernel
    (``csrc/pairwise.cu``; it evaluates the expansion in another order,
    ``|a|^2 + min_j (|b_j|^2 - 2 a . b_j)``, within ``ND_TOL`` of this
    one).
  * ``nearest_dist_plain`` — plain PyTorch, the same expansion.

``kernels.ops.nearest_dist`` picks by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

INF = 1e30
MAX_D = 8
THREADS = 256         # threads per block (csrc/pairwise.cu kThreads)
MAX_SPLIT = 8         # blocks per row block: the portable cluster size
H100_SMS = 132

launches = 0          # kernel launches made by nearest_dist_cuda

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "nearest_dist_launch": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
                            _I),
}


def nd_split(M: int, N: int, sms: int = H100_SMS):
    """How the kernel cuts the work: (rows, split, share, ranges).  Each
    thread holds ``rows`` rows of a (4, or 1 where M is too small to fill
    the card with 4), so a block holds THREADS * rows; each row block's
    cluster has ``split`` blocks, each taking ``share`` consecutive rows of
    b (``ranges``, in rank order).  About one block an SM in all, at most
    MAX_SPLIT, and at least THREADS rows of b a block."""
    rows = 4 if M >= 16384 else 1
    row_blocks = -(-M // (THREADS * rows))
    split = max(1, min(sms // row_blocks, MAX_SPLIT, -(-N // THREADS)))
    share = -(-N // split)
    ranges = tuple((min(r * share, N), min((r + 1) * share, N))
                   for r in range(split))
    return rows, split, share, ranges


def nearest_dist_plain(a: torch.Tensor, b: torch.Tensor,
                       b_valid: torch.Tensor) -> torch.Tensor:
    """a [M, D]; b [N, D]; b_valid [N] bool -> [M] f32."""
    a2 = (a * a).sum(dim=1, keepdim=True)
    b2 = (b * b).sum(dim=1)[None, :]
    d2 = a2 + b2 - 2.0 * (a @ b.T)
    return torch.where(b_valid[None, :], d2, INF).amin(dim=1)


def nearest_dist_cuda(a: torch.Tensor, b: torch.Tensor,
                      b_valid: torch.Tensor) -> torch.Tensor:
    """The hand-written kernel (same contract as ``nearest_dist_plain``):
    a, b f32 and b_valid bool, contiguous, on one CUDA device; 1 <= D <= 8,
    M, N >= 1."""
    global launches
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"nearest_dist_cuda needs CUDA tensors, got {dev}")
    M, D = a.shape
    N = b.shape[0]
    build.check_arg("nearest_dist", "a", a, (torch.float32,), (M, D), dev)
    build.check_arg("nearest_dist", "b", b, (torch.float32,), (N, D), dev)
    build.check_arg("nearest_dist", "b_valid", b_valid, (torch.bool,), (N,),
                    dev)
    if not (1 <= D <= MAX_D and M >= 1 and N >= 1 and M * D < 2 ** 31
            and N * D < 2 ** 31):
        raise ValueError(f"nearest_dist: unsupported M={M} N={N} D={D}")
    out = torch.empty((M,), dtype=torch.float32, device=dev)
    lib = build.load("pairwise", _SIGNATURES)
    rows, split, share, _ = nd_split(M, N, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    with torch.cuda.device(dev):
        err = lib.nearest_dist_launch(
            a.data_ptr(), b.data_ptr(), b_valid.data_ptr(), M, N, D, rows,
            split, share, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nearest_dist kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
