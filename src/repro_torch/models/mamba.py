"""Mamba-1 selective SSM mixer (jamba's attention-free layers).

Port of ``repro.models.mamba``.  The reference re-blocks the recurrence
as a scan over time chunks that carries the [B, d_inner, d_state] f32
state, with an associative scan inside each chunk.  The port keeps that
shape: a Python loop over chunks carries h, and inside a chunk a log-step
(Hillis-Steele) scan over the chunk axis combines ``(a1, b1), (a2, b2) ->
(a1 a2, a2 b1 + b2)``, the reference's combine, in ceil(log2(chunk))
steps (5 at jamba's chunk of 32).  It rounds in another order than JAX's
tree, so f32 parity is held at 1e-5, not bit for bit.

The reference adds ``u * D`` with ``u`` still padded to the chunk multiple,
so it raises at a length past the chunk that is no multiple of it; the
port adds it with the unpadded ``u``, which is what the reference computes
wherever it runs.  A ``MambaCache`` is written IN PLACE: the conv inputs
and the scan state of the call are copied into the cache's buffers, and
the same cache is returned, as ``attention_mixer`` does with a
``KVCache``.

Training differentiates the chunk loop with autograd.  The log-step scan
keeps its ``torch.cat`` form under grad: an in-place add gives the same
bits but its backward raises (the product saves the slice it overwrites).
Each chunk's scan saves about 11 f32 ``[d_inner, d_state]`` arrays a token
for its backward, so under ``cfg.remat`` (grad on, no cache) each chunk
runs under ``torch.utils.checkpoint``: the backward recomputes it from
its inputs and the carried state, the same forward with the same bits,
and the scan keeps about 0.2 such arrays a token.

The chunked scan (a prefill, a prefill-fill or training; not a decode
step) runs under the ``repro_torch.obs`` span ``mamba.scan``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common as cm
from repro_torch.obs.trace import span


def _dims(cfg: cm.ArchConfig):
    mb = cfg.mamba
    d_inner = mb.expand * cfg.d_model
    dt_rank = mb.dt_rank or math.ceil(cfg.d_model / 16)
    return d_inner, dt_rank, mb.d_state, mb.d_conv


def mamba_param_specs(cfg: cm.ArchConfig) -> dict:
    d = cfg.d_model
    d_in, dt_rank, d_state, d_conv = _dims(cfg)
    return {
        "in_proj": cm.spec((d, 2 * d_in), cfg.dtype),
        "conv_w": cm.spec((d_in, d_conv), cfg.dtype),
        "conv_bias": cm.spec((d_in,), cfg.dtype),
        "x_proj": cm.spec((d_in, dt_rank + 2 * d_state), cfg.dtype),
        "dt_proj": cm.spec((dt_rank, d_in), cfg.dtype),
        "dt_bias": cm.spec((d_in,), torch.float32),
        "A_log": cm.spec((d_in, d_state), torch.float32),
        "D": cm.spec((d_in,), torch.float32),
        "out_proj": cm.spec((d_in, d), cfg.dtype),
    }


class MambaCache(NamedTuple):
    conv: torch.Tensor   # [B, d_conv-1, d_inner] model dtype: last conv inputs
    ssm: torch.Tensor    # [B, d_inner, d_state] f32


def mamba_cache_specs(cfg: cm.ArchConfig, batch: int) -> MambaCache:
    d_in, _, d_state, d_conv = _dims(cfg)
    return MambaCache(conv=cm.spec((batch, d_conv - 1, d_in), cfg.dtype),
                      ssm=cm.spec((batch, d_in, d_state), torch.float32))


def init_mamba_cache(cfg: cm.ArchConfig, batch: int, *,
                     device) -> MambaCache:
    d_in, _, d_state, d_conv = _dims(cfg)
    return MambaCache(
        conv=torch.zeros((batch, d_conv - 1, d_in), dtype=cfg.dtype,
                         device=device),
        ssm=torch.zeros((batch, d_in, d_state), dtype=torch.float32,
                        device=device))


def _causal_conv(x, w, b, prev):
    """x: [B,S,d_in]; w: [d_in,K]; prev: [B,K-1,d_in] carried inputs.
    The K taps summed in order from 0, in x's dtype, then the bias.
    Returns (y, the last K-1 inputs)."""
    K = w.shape[1]
    xp = torch.cat([prev, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[:, i] for i in range(K))
    return y + b, xp[:, -(K - 1):]


def _chunk_scan(lam, drive):
    """Inclusive scan over axis 1 of h_t = lam_t h_{t-1} + drive_t (h_0
    folded into drive's first step): log2 steps, each combining position t
    with t - s.  Returns h at every position."""
    C, s = lam.shape[1], 1
    while s < C:
        drive = torch.cat([drive[:, :s],
                           lam[:, s:] * drive[:, :-s] + drive[:, s:]], dim=1)
        if 2 * s < C:
            lam = torch.cat([lam[:, :s], lam[:, :-s] * lam[:, s:]], dim=1)
        s *= 2
    return drive


def _ssm_chunk(h0, u, B_, C_, dt, A):
    """One time chunk. h0: [B,d_in,N] f32; u, dt: [B,C,d_in]; B_, C_:
    [B,C,N].  Returns (h at the chunk's end, y [B,C,d_in]).  The end state
    is a copy: a view would keep the whole chunk's h alive for as long as
    the next chunk's checkpoint holds its input."""
    lam = torch.exp(dt[..., None] * A)                      # decay factors
    drive = (dt * u)[..., None] * B_[:, :, None, :]         # [B,C,d_in,N]
    drive = torch.cat([drive[:, :1] + lam[:, :1] * h0[:, None], drive[:, 1:]],
                      dim=1)
    h_all = _chunk_scan(lam, drive)
    y = torch.einsum("bcdn,bcn->bcd", h_all, C_)
    return h_all[:, -1].clone(), y


def _scan(h, u, B_, C_, dt, A, Cn: int, *, recompute: bool = False):
    """The selective scan over S steps in chunks of ``Cn``, from the state
    h [B,d_in,N] f32: returns (h after step S, y [B,S,d_in] f32).  With
    ``recompute`` each chunk runs under ``checkpoint``, which saves only
    its inputs (the carried h and views of u, B_, C_, dt) for the
    backward."""
    S = u.shape[1]
    pad = (-S) % Cn
    # padded steps have dt = 0: decay 1 and drive 0 carry h unchanged
    up, Bp, Cp, dtp = (F.pad(t, (0, 0, 0, pad)) if pad else t
                       for t in (u, B_, C_, dt))
    ys = []
    for c0 in range(0, S + pad, Cn):
        c = slice(c0, c0 + Cn)
        args = (h, up[:, c], Bp[:, c], Cp[:, c], dtp[:, c], A)
        h, yc = (checkpoint(_ssm_chunk, *args, use_reentrant=False)
                 if recompute else _ssm_chunk(*args))
        ys.append(yc)
    return h, torch.cat(ys, dim=1)[:, :S]


def mamba_mixer(params, x: torch.Tensor, cfg: cm.ArchConfig, *,
                cache: MambaCache | None = None):
    """x: [B,S,D]. Prefill / train when cache is None; with a cache, S > 1
    continues from its state (prefill-fill) and S == 1 decodes; the cache
    is written in place.  Returns (y [B,S,D], the cache or None)."""
    d_in, dt_rank, d_state, d_conv = _dims(cfg)
    B, S, _ = x.shape
    xin, z = (x @ params["in_proj"]).chunk(2, dim=-1)

    prev = (torch.zeros((B, d_conv - 1, d_in), dtype=xin.dtype,
                        device=x.device) if cache is None else cache.conv)
    xc, conv_state = _causal_conv(xin, params["conv_w"], params["conv_bias"],
                                  prev)
    xc = F.silu(xc)

    dbc = xc @ params["x_proj"]
    dt_low = dbc[..., :dt_rank]
    B_ = dbc[..., dt_rank:dt_rank + d_state].float()
    C_ = dbc[..., dt_rank + d_state:].float()
    dt = F.softplus((dt_low @ params["dt_proj"]).float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])                         # [d_in, N]
    u = xc.float()

    if cache is None or S > 1:
        h = (torch.zeros((B, d_in, d_state), dtype=torch.float32,
                         device=x.device) if cache is None else cache.ssm)
        with span("mamba.scan", "model"):
            h, y = _scan(h, u, B_, C_, dt, A, min(cfg.mamba.chunk, S),
                         recompute=(cfg.remat and cache is None
                                    and torch.is_grad_enabled()))
    else:
        lam = torch.exp(dt[:, 0, :, None] * A)
        h = lam * cache.ssm + (dt * u)[:, 0, :, None] * B_[:, 0, None, :]
        y = torch.einsum("bdn,bn->bd", h, C_[:, 0])[:, None]
    if cache is not None:
        cache.conv.copy_(conv_state)
        cache.ssm.copy_(h)

    y = y + u * params["D"]
    y = y.to(x.dtype) * F.silu(z)
    return y @ params["out_proj"], cache
