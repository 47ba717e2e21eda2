"""RWKV-6's wkv recurrence over a sequence, from a given state.

Per row and head, with w_t = exp(lw_t) (lw the log-decay, < 0):

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t

Two implementations of the same function:

  * ``wkv6_cuda`` -- the hand-written Hopper kernel (``csrc/wkv6.cu``; it
    replaces no Pallas kernel, since the JAX package's wkv is plain jnp):
    one block per (row, head) keeps the head's f32 state in registers for
    the whole sequence and writes y once.  No backward: the serving path's
    wkv.
  * ``wkv6_plain`` -- plain PyTorch, the reference's chunked linear-attention
    (GLA) form: a loop over time chunks carries the [B, h, dk, dv] f32
    state, and inside a chunk every decay is exp(L_a - L_b) with a >= b (L
    the cumulative log-decay, which only falls), so every exponent is <= 0;
    the pairs j >= t are masked to -inf before the exponent.  Autograd
    differentiates it (the mask carries a zero gradient), so training runs
    it on every device.

``kernels.ops.wkv6`` picks by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

HEAD_DIM = 64         # csrc/wkv6.cu kD: one thread a value column

launches = 0          # kernel launches made by wkv6_cuda

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "wkv6_launch": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
                    _I),
}


def _wkv_chunk(S, r, k, v, lw, u):
    """One chunk of the wkv recurrence. S: [B,h,dk,dv] f32; r, k, v, lw:
    [B,C,h,dh] (lw the log-decay, <= 0); u: [h,dh].  Returns (S at the
    chunk's end, y [B,C,h,dv])."""
    C = r.shape[1]
    L = torch.cumsum(lw, dim=1)                            # [B,C,h,dk]
    Lm1 = L - lw                                           # L_{t-1}
    r_s = r * torch.exp(Lm1)
    # diff[t,j,i] = L_{t-1,i} - L_{j,i} (<= 0 for j < t); -inf elsewhere
    diff = Lm1[:, :, None] - L[:, None]                    # [B,C,C,h,dk]
    causal = torch.ones((C, C), dtype=torch.bool, device=r.device).tril(-1)
    diff = diff.masked_fill(~causal[None, :, :, None, None], float("-inf"))
    scores = (r[:, :, None] * k[:, None] * torch.exp(diff)).sum(dim=-1)
    y = torch.einsum("btjh,bjhd->bthd", scores, v)
    y = y + (r * u * k).sum(dim=-1, keepdim=True) * v     # current token
    y = y + torch.einsum("bthi,bhid->bthd", r_s, S)
    # S_C = exp(L_C) S_0 + sum_j (k_j exp(L_C - L_j)) v_j
    LC = L[:, -1]                                          # [B,h,dk]
    S_new = torch.exp(LC)[..., None] * S + torch.einsum(
        "bjhi,bjhd->bhid", k * torch.exp(LC[:, None] - L), v)
    return S_new, y


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lw: torch.Tensor, u: torch.Tensor, state0: torch.Tensor,
               chunk: int):
    """r, k, v, lw [B, S, h, dh] f32; u [h, dh]; state0 [B, h, dh, dh] f32.
    Returns (y [B, S, h, dh], the state after the last step), in chunks of
    ``min(chunk, S)`` steps; a ragged tail is padded with steps of k = 0 and
    decay 1, which leave the state alone."""
    S = r.shape[1]
    Cn = min(chunk, S)
    pad = (-S) % Cn
    if pad:
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
    state = state0
    ys = []
    for c0 in range(0, S + pad, Cn):
        c = slice(c0, c0 + Cn)
        state, yc = _wkv_chunk(state, r[:, c], k[:, c], v[:, c], lw[:, c], u)
        ys.append(yc)
    return torch.cat(ys, dim=1)[:, :S], state


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lw: torch.Tensor, u: torch.Tensor, state0: torch.Tensor):
    """The hand-written kernel (``wkv6_plain``'s contract, no chunk): every
    input f32 and contiguous on one CUDA device, the arrays it reads in
    16-byte pieces 16-byte aligned, dh = 64, S >= 1."""
    global launches
    dev = r.device
    if r.dim() != 4:
        raise ValueError(f"wkv6: r must be [B, S, h, dh], got "
                         f"{tuple(r.shape)}")
    B, S, H, dh = r.shape
    if dh != HEAD_DIM or S < 1 or B < 1 or H < 1:
        raise ValueError(f"wkv6: unsupported B={B} S={S} h={H} dh={dh} "
                         f"(the kernel takes dh = {HEAD_DIM}, S >= 1)")
    f32 = (torch.float32,)
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw)):
        build.check_arg("wkv6", name, t, f32, (B, S, H, dh), dev)
    build.check_arg("wkv6", "u", u, f32, (H, dh), dev)
    build.check_arg("wkv6", "state0", state0, f32, (B, H, dh, dh), dev)
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw),
                    ("state0", state0)):
        if t.data_ptr() % 16:
            raise ValueError(f"wkv6: {name} is not 16-byte aligned")
    if dev.type != "cuda":
        raise ValueError(f"wkv6_cuda needs CUDA tensors, got {dev}")
    y = torch.empty_like(r)
    end_state = torch.empty_like(state0)
    lib = build.load("wkv6", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), state0.data_ptr(), B, S, H, dh, y.data_ptr(),
            end_state.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    launches += 1
    return y, end_state
