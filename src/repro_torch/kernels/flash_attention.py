"""Blocked (flash) attention with an online softmax.

Port of ``repro.kernels.flash_attention.flash_attention_pallas``, which is
also the kernel form of the model's prefill attention
(``repro.models.attention.blocked_attention``):
``o = softmax(mask(softcap(q . k^T * dh^-0.5))) . v`` for q ``[B, S, H, dh]``,
k ``[B, T, Kv, dh]`` and v ``[B, T, Kv, dv]`` -> ``[B, S, H, dv]``, query
head h reading kv head ``h // (H / Kv)`` (grouped-query attention).  The
keys may be of another length T than the queries only without the causal
mask and the window, as whisper's cross-attention has them (448 or 1
decoder queries against 1500 encoder keys); a causal or windowed call
with T != S raises ``ValueError``: no caller makes one.  v may
have its own head width, as DeepSeek's MLA prefill has (q / k 192, v 128);
the scale stays ``dh ** -0.5`` of q's width, as the reference's
``blocked_attention`` has it.  Scores and the running (m, l, acc) state are
f32, masked scores are ``NEG``, p is rounded to v's dtype before the PV
product, and the output is ``acc / max(l, 1e-30)`` in q's dtype.

Masks: causal ``kpos <= qpos``, window ``qpos - kpos < window``, and keys
past T never count.  The TPU kernel pads S to its tile with zeros and,
without the causal mask, lets those padded keys into the softmax; the port
masks them, as ``ref.flash_attention_ref`` and ``blocked_attention`` do.
With ``return_lse=True`` both implementations also return each row's
log-sum-exp ``lse = log(sum_kept exp(s))`` (f32 ``[B, H, S]``, the natural
log of the scaled, softcapped score), which the gradient reads instead of
recomputing the softmax statistics.

Two implementations of the same function:

  * ``flash_attention_cuda`` — the hand-written Hopper kernel
    (``csrc/flash_attention.cu``): for bf16, warp-specialised wgmma fed by
    a TMA ring (tensor maps laid out by ``tma_layout``); for f32, fp32 FMA.
  * ``flash_attention_plain`` — plain PyTorch with the kernel's tiling of
    the online softmax (``BLOCK_K`` keys per step) and its rounding points.

``kernels.ops.flash_attention`` (the reference's ``[H, S, dh]`` layout) and
``kernels.ops.flash_attention_bshd`` (the model's layout) pick by device.

The gradient (the reference trains through the jnp ``blocked_attention``
under ``jax.grad``; its Pallas kernel has no backward) is two more
implementations of one function, ``(q, k, v, o, do, lse) -> (dq, dk, dv)``:

  * ``flash_attention_bwd_cuda`` — the hand-written Hopper kernel
    (``csrc/flash_attention_bwd.cu``): dq per query tile and dk, dv per key
    tile, no atomics; bf16 on the tensor cores (wgmma), f32 in fp32 FMA;
  * ``flash_attention_bwd_plain`` — plain PyTorch with the gradient written
    out (not autograd), at the kernel's rounding points.

The gradient takes v, o and do at v's own width, as the forward does:
dq and dk come back at q's width and dv at v's.

``FlashAttention`` is the ``torch.autograd.Function`` over the pair: its
forward runs ``flash_attention_cuda`` or ``flash_attention_plain`` with
``return_lse=True`` and its backward ``flash_attention_bwd_cuda`` or
``flash_attention_bwd_plain``, each picked by the tensors' device.  Both
kernels take the same head-width pairs, ``HEAD_PAIRS``: MLA's 192 / 128,
and h2o-danube-3's 120 and phi-3's 96, run on the 128-wide tiles,
included.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG = -1e30
BLOCK_K = 128                # keys per online-softmax step (kernel, plain)
TILE = 128                   # the bf16 kernel's query and key tile
PANEL = 64                   # bf16 columns of one 128-byte TMA box row
# (q / k, v) head widths the forward and gradient kernels are built for
# (120: h2o-danube-3's head, 96: phi-3's, both run on the 128-wide tiles)
HEAD_PAIRS = ((64, 64), (128, 128), (192, 128), (120, 120), (96, 96))
DTYPES = (torch.bfloat16, torch.float32)

launches = 0                 # kernel launches made by flash_attention_cuda
bwd_launches = 0             # calls of flash_attention_bwd_cuda (2 kernels)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "flash_attention_launch": ([_P] * 7 + [_I] * 10 + [ctypes.c_float, _P],
                               _I),
}
_BWD_SIGNATURES = {
    "flash_attention_bwd_launch": ([_P] * 11 + [_I] * 10
                                   + [ctypes.c_float, _P], _I),
}


def _shapes(q, k, v, causal, window):
    """(B, S, T, H, Kv, dh, dv) of q [B, S, H, dh], k [B, T, Kv, dh] and v
    [B, T, Kv, dv]; T != S only for a call without the causal mask and
    the window."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D "
                         "([B, S, H, dh], [B, T, Kv, dh], [B, T, Kv, dv])")
    B, S, H, dh = q.shape
    T, Kv, dv = k.shape[1], k.shape[2], v.shape[3]
    if (tuple(k.shape) != (B, T, Kv, dh) or tuple(v.shape) != (B, T, Kv, dv)
            or T < 1):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be [B, T, Kv, dh] and "
                         f"[B, T, Kv, dv], T >= 1, for q {tuple(q.shape)}")
    if T != S and (causal or window):
        raise ValueError(f"flash_attention: {T} keys for {S} queries must be "
                         "attended without the causal mask and the window")
    if Kv < 1 or H % Kv:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {Kv} kv heads")
    return B, S, T, H, Kv, dh, dv


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, return_lse: bool = False):
    """q [B, S, H, dh]; k [B, T, Kv, dh]; v [B, T, Kv, dv] -> [B, S, H, dv]
    (q's dtype); with ``return_lse``, ``(o, lse)``, lse = m + log(l) of
    the online state, f32 [B, H, S]."""
    B, S, T, H, Kv, dh, dv = _shapes(q, k, v, causal, window)
    G = H // Kv
    scale = dh ** -0.5
    qg = q.reshape(B, S, Kv, G, dh).float()
    m = torch.full((B, Kv, G, S), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Kv, G, S, dv), dtype=torch.float32,
                      device=q.device)
    qpos = torch.arange(S, device=q.device)[:, None]
    for k0 in range(0, T, BLOCK_K):
        kt, vt = k[:, k0:k0 + BLOCK_K], v[:, k0:k0 + BLOCK_K]
        s = torch.einsum("bqkgd,btkd->bkgqt", qg, kt.float()) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        kpos = torch.arange(k0, k0 + kt.shape[1], device=q.device)[None, :]
        mask = kpos < T
        if causal:
            mask = mask & (kpos <= qpos)
        if window:
            mask = mask & (qpos - kpos < window)
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqt,btkd->bkgqd", p.to(v.dtype).float(), vt.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dv).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).reshape(B, H, S)
    return out


def _check_layout(name: str, t: torch.Tensor, dev: torch.device,
                  dtype: torch.dtype) -> None:
    """The kernel reads ``t`` through its strides with 16-byte loads: the
    head dim must be contiguous and every other stride and the base
    address 16-byte aligned."""
    if t.device != dev:
        raise ValueError(f"flash_attention: {name} is on {t.device}, "
                         f"expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"flash_attention: {name} dtype {t.dtype}, "
                         f"expected {dtype}")
    per16 = 16 // t.element_size()
    if (t.stride(3) != 1 or any(s % per16 for s in t.stride()[:3])
            or t.data_ptr() % 16):
        raise ValueError(f"flash_attention: {name} strides {t.stride()} "
                         "need a contiguous head dim and 16-byte aligned "
                         "rows")


def tma_layout(t: torch.Tensor):
    """The 4-D TMA tensor map of a bf16 ``[B, S, heads, dh]`` operand, as
    ``csrc/flash_attention.cu`` encodes it: dims innermost first
    ``(dh, S, heads, B)``, the byte strides of S, heads and B, and the box,
    one 128-row by 64-column panel (128 bytes, the swizzle's span).  The
    true dh goes into the map: a head narrower than its last panel (120 or
    96 in two panels of 64) arrives with zeros in the columns past dh, as
    rows past S do.  TMA needs a contiguous head dim and 16-byte aligned
    strides and base; dh must be a multiple of 8, and at most 128 when it
    is not a multiple of 64; anything else raises ``ValueError``."""
    if t.dim() != 4:
        raise ValueError(f"tma_layout: {tuple(t.shape)} is not 4-D")
    B, S, heads, dh = t.shape
    es = t.element_size()
    strides = tuple(t.stride(i) * es for i in (1, 2, 0))
    if (t.stride(3) != 1 or dh % 8 or (dh % PANEL and dh > 2 * PANEL)
            or any(s % 16 or s >= 2 ** 40 for s in strides)
            or t.data_ptr() % 16):
        raise ValueError(f"tma_layout: strides {t.stride()} (element size "
                         f"{es}) need a contiguous head dim (a multiple of "
                         f"{PANEL}, or of 8 up to {2 * PANEL}) and 16-byte "
                         "aligned rows")
    return (dh, S, heads, B), strides, (PANEL, TILE, 1, 1)


def tile_schedule(B: int, S: int, H: int, n_blocks: int):
    """The bf16 kernel's work split (``block_tile`` and ``snake_tile`` in
    ``csrc/flash_attention.cu``): tiles of ``TILE`` query rows
    numbered heaviest first (every (b, h) of the last query tile, then of
    the one before, ...), dealt to ``n_blocks`` persistent blocks back and
    forth.  Returns each block's (query tile, b, h) in the order it runs
    them."""
    n_q = -(-S // TILE)
    n_tiles = n_q * B * H
    out = [[] for _ in range(n_blocks)]
    for r in range(-(-n_tiles // n_blocks)):
        for blk in range(n_blocks):
            i = r * n_blocks + (n_blocks - 1 - blk if r % 2 else blk)
            if i < n_tiles:
                out[blk].append((n_q - 1 - i // (B * H), (i % (B * H)) // H,
                                 i % H))
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, return_lse: bool = False):
    """The hand-written kernel (same contract as ``flash_attention_plain``):
    q, k, v on one CUDA device, all bf16 or all f32, (dh, dv) one of
    ``HEAD_PAIRS``.  The kernel writes lse only when ``return_lse`` asks
    for it."""
    global launches
    dev = q.device
    B, S, T, H, Kv, dh, dv = _shapes(q, k, v, causal, window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    if q.dtype not in DTYPES or (dh, dv) not in HEAD_PAIRS:
        raise ValueError(f"flash_attention: unsupported dtype {q.dtype} or "
                         f"head widths (q/k {dh}, v {dv}) (kernel takes "
                         f"{DTYPES}, {HEAD_PAIRS})")
    if B * max(S, T) * H * dh >= 2 ** 31 or int(window) < 0:
        raise ValueError(f"flash_attention: unsupported B={B} S={S} H={H} "
                         f"window={window}")
    out = torch.empty((B, S, H, dv), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
           if return_lse else None)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_layout(name, t, dev, q.dtype)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    tma = None
    if q.dtype == torch.bfloat16:
        tma = (ctypes.c_longlong * 33)(*(x for t in (q, k, v)
                                         for part in tma_layout(t)
                                         for x in part))
    lib = build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), strides, tma, B, S, T,
            H, Kv, dh, dv, int(q.dtype == torch.bfloat16), int(causal),
            int(window), float(softcap),
            torch.cuda.current_stream(dev).cuda_stream)
    if err in (-2, -3):
        raise RuntimeError("flash_attention: cuTensorMapEncodeTiled "
                           + ("refused a tensor map" if err == -2 else
                              "is not available from the CUDA driver"))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------- gradient
def _bwd_masks(S: int, causal: bool, window: int, device,
               T: int | None = None) -> torch.Tensor:
    """[S, T] bool (T = S by default): query row i keeps key j (keys past
    T never exist here: the plain gradient works on the unpadded [S, T]
    block)."""
    T = S if T is None else T
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    keep = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        keep = keep & (kpos <= qpos)
    if window:
        keep = keep & (qpos - kpos < window)
    return keep


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, lse: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              softcap: float = 0.0):
    """The gradient of ``flash_attention_plain`` written out: q [B, S, H,
    dh], k [B, T, Kv, dh], v [B, T, Kv, dv], o and do [B, S, H, dv] and the
    forward's lse [B, H, S] -> (dq, dk, dv) in q's dtype, dq [B, S, H, dh],
    dk [B, T, Kv, dh] and dv [B, T, Kv, dv]; the scale is ``dh ** -0.5``,
    as the forward's.

    With ``s = softcap(q . k^T * scale)``, ``p = exp(s - lse)`` on the kept
    keys (0 elsewhere) and ``D = rowsum(do * o)``: ``dv = round(p)^T . do``
    (p rounded to v's dtype, as the forward rounds it before ``p . v``),
    ``dp = do . v^T``, ``ds = p * (dp - D) * (1 - (s / softcap)^2) *
    scale``, rounded to v's dtype (the kernel's tensor cores take bf16
    operands; a no-op in f32), ``dq = ds . k`` and ``dk = ds^T . q``; dk
    and dv of kv head j sum over its G query heads.  Every product
    accumulates in f32 from the operands' own values."""
    B, S, T, H, Kv, dh, dv_ = _shapes(q, k, v, causal, window)
    G = H // Kv
    scale = dh ** -0.5
    qf = q.float().reshape(B, S, Kv, G, dh)
    kf, vf = k.float(), v.float()
    gf = do.float().reshape(B, S, Kv, G, dv_)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, kf) * scale
    capfac = None
    if softcap:
        t = torch.tanh(s / softcap)
        s = t * softcap
        capfac = 1.0 - t * t
    keep = _bwd_masks(S, causal, window, q.device, T)
    lse = lse.float().reshape(B, Kv, G, S)[..., None]
    p = torch.where(keep, torch.exp(s - lse), 0.0)
    dv = torch.einsum("bkgqt,bqkgd->btkd", p.to(v.dtype).float(), gf)
    dp = torch.einsum("bqkgd,btkd->bkgqt", gf, vf)
    dsum = (do.float() * o.float()).sum(dim=-1)            # [B, S, H]
    dsum = dsum.reshape(B, S, Kv, G).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - dsum)
    if capfac is not None:
        ds = ds * capfac
    ds = (ds * scale).to(v.dtype).float()
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds, kf).reshape(B, S, H, dh)
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds, qf)
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             softcap: float = 0.0):
    """The hand-written gradient kernel (same contract as
    ``flash_attention_bwd_plain``): every tensor on one CUDA device, all
    bf16 or all f32 (lse f32, contiguous), (dh, dv) one of ``HEAD_PAIRS``;
    dq, dk, dv come back contiguous."""
    global bwd_launches
    dev = q.device
    B, S, T, H, Kv, dh, dv_ = _shapes(q, k, v, causal, window)
    if q.dtype not in DTYPES or (dh, dv_) not in HEAD_PAIRS:
        raise ValueError(f"flash_attention_bwd: unsupported dtype {q.dtype} "
                         f"or head widths (q/k {dh}, v {dv_}) (kernel takes "
                         f"{DTYPES}, {HEAD_PAIRS})")
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd_cuda needs CUDA tensors, got "
                         f"{dev}")
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != (B, S, H, dv_):
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(t.shape)} != {(B, S, H, dv_)}")
    if B * max(S, T) * H * dh >= 2 ** 31 or int(window) < 0:
        raise ValueError(f"flash_attention_bwd: unsupported B={B} S={S} "
                         f"T={T} H={H} window={window}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _check_layout(name, t, dev, q.dtype)
    build.check_arg("flash_attention_bwd", "lse", lse, (torch.float32,),
                    (B, H, S), dev)
    dq = torch.empty((B, S, H, dh), dtype=q.dtype, device=dev)
    dk = torch.empty((B, T, Kv, dh), dtype=q.dtype, device=dev)
    dv = torch.empty((B, T, Kv, dv_), dtype=q.dtype, device=dev)
    dsum = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 15)(*(s for t in (q, k, v, o, do)
                                         for s in t.stride()[:3]))
    lib = build.load("flash_attention_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dsum.data_ptr(), strides, B, S, T, H, Kv, dh, dv_,
            int(q.dtype == torch.bfloat16), int(causal), int(window),
            float(softcap),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"{'shape refused' if err == -1 else 'CUDA error'}"
                           f" {err}")
    bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: forward and backward each run
    the hand-written kernel on CUDA tensors and the plain version on CPU
    tensors.  It saves q, k, v, o and the forward's lse (f32 [B, H, S]);
    the backward forms p from the lse.  v may have its own head width (MLA's
    192 / 128): dv comes back at it; k and v may have T keys (non-causal):
    dk and dv come back at T."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, softcap: float):
        kw = dict(causal=causal, window=window, softcap=softcap)
        fwd = (flash_attention_plain if q.device.type == "cpu"
               else flash_attention_cuda)
        o, lse = fwd(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = (flash_attention_bwd_plain if q.device.type == "cpu"
               else flash_attention_bwd_cuda)
        dq, dk, dv = bwd(q, k, v, o, do.contiguous(), lse, **ctx.kw)
        return dq, dk, dv, None, None, None
