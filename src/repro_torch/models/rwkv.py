"""RWKV-6 "Finch" time mixing + channel mixing (attention-free).

Port of ``repro.models.rwkv``.  The per-head recurrence
   S_t = diag(w_t) S_{t-1} + k_t^T v_t,   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
runs over a whole sequence (every call but a decode step) in
``kernels/wkv6.py``: where no input needs a gradient, through
``kernels.ops.wkv6`` (on the card the ``wkv6`` kernel, which keeps each
head's f32 state on chip; on the CPU the chunk loop); under grad, through
``wkv6_plain``, the reference's chunked linear-attention form, whose loop
autograd differentiates (the kernel has no backward).  The choice reads
only the inputs' ``requires_grad``: serving qualifies, since ``LM`` freezes
its parameters.

Under ``cfg.remat`` the period (one layer) is recomputed whole: the chunk
loop's scores keep about two f32 [chunk, d_model] arrays a token for the
backward, which one layer at a time can afford (rwkv6-3b at 1 x 4096), so
unlike Mamba's scan the chunks are not recomputed one by one.

Parameter names keep the reference's slash (``mix_base/mix_mu``,
``cmix_k/mix_mu``): each is one key, one leaf.  ``rwkv_time_mix`` returns
the new (state, last input) and ``rwkv_channel_mix`` its last input; the
block writes the three into its ``RWKVCache`` in place.  The sequence wkv
runs under the ``repro_torch.obs`` span ``rwkv.wkv`` whichever path takes
it, and with a metrics registry installed each call counts one
``rwkv_wkv_calls_total`` under ``path`` "kernel" (the kernel launched) or
"chunks".
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels import wkv6 as wkv
from repro_torch.models import common as cm
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import span

# token-shift targets for time mixing
_TM_SLOTS = 5   # r, k, v, w, g


def _dims(cfg: cm.ArchConfig):
    rw = cfg.rwkv
    return cfg.d_model // rw.head_dim, rw.head_dim


def rwkv_tm_param_specs(cfg: cm.ArchConfig) -> dict:
    d = cfg.d_model
    rw = cfg.rwkv
    h, dh = _dims(cfg)
    f32 = torch.float32
    return {
        "mix_base/mix_mu": cm.spec((d,), f32),
        "mix/mix_mu": cm.spec((_TM_SLOTS, d), f32),
        "mix_w1": cm.spec((d, _TM_SLOTS * rw.mix_lora), cfg.dtype),
        "mix_w2": cm.spec((_TM_SLOTS, rw.mix_lora, d), cfg.dtype),
        "wr": cm.spec((d, d), cfg.dtype),
        "wk": cm.spec((d, d), cfg.dtype),
        "wv": cm.spec((d, d), cfg.dtype),
        "wg": cm.spec((d, d), cfg.dtype),
        "decay_base": cm.spec((d,), f32),
        "decay_w1": cm.spec((d, rw.decay_lora), cfg.dtype),
        "decay_w2": cm.spec((rw.decay_lora, d), cfg.dtype),
        "bonus_u": cm.spec((h, dh), f32),
        "ln_x_scale": cm.spec((d,), cfg.dtype),
        "wo": cm.spec((d, d), cfg.dtype),
    }


def rwkv_cm_param_specs(cfg: cm.ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "cmix_k/mix_mu": cm.spec((d,), torch.float32),
        "cmix_r/mix_mu": cm.spec((d,), torch.float32),
        "wk": cm.spec((d, f), cfg.dtype),
        "wv": cm.spec((f, d), cfg.dtype),
        "wr": cm.spec((d, d), cfg.dtype),
    }


class RWKVCache(NamedTuple):
    tm_prev: torch.Tensor    # [B, d] last input to time mixing
    cm_prev: torch.Tensor    # [B, d] last input to channel mixing
    state: torch.Tensor      # [B, h, dk, dv] f32 wkv state


def rwkv_cache_specs(cfg: cm.ArchConfig, batch: int) -> RWKVCache:
    d = cfg.d_model
    h, dh = _dims(cfg)
    return RWKVCache(tm_prev=cm.spec((batch, d), cfg.dtype),
                     cm_prev=cm.spec((batch, d), cfg.dtype),
                     state=cm.spec((batch, h, dh, dh), torch.float32))


def init_rwkv_cache(cfg: cm.ArchConfig, batch: int, *,
                    device) -> RWKVCache:
    d = cfg.d_model
    h, dh = _dims(cfg)
    return RWKVCache(
        tm_prev=torch.zeros((batch, d), dtype=cfg.dtype, device=device),
        cm_prev=torch.zeros((batch, d), dtype=cfg.dtype, device=device),
        state=torch.zeros((batch, h, dh, dh), dtype=torch.float32,
                          device=device))


def _token_shift(x, prev):
    """x_{t-1} over the sequence, given the carried ``prev``: [B,S,d],
    [B,d]."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _ddlerp(params, x, x_prev):
    """Data-dependent token-shift interpolation -> per-slot mixed inputs
    [B,S,5,d].  The LoRA's 5 * mix_lora outputs are slot-major."""
    xx = x_prev - x
    base = x + xx * params["mix_base/mix_mu"].to(x.dtype)
    lora = torch.tanh(base @ params["mix_w1"])
    B, S, _ = x.shape
    lora = lora.reshape(B, S, _TM_SLOTS, -1)
    offs = torch.einsum("bsli,lid->bsld", lora, params["mix_w2"])
    mus = params["mix/mix_mu"].to(x.dtype)[None, None] + offs
    return x[:, :, None] + xx[:, :, None] * mus


def _bonus(r, u, k, v):
    """The current token's term (sum_i r_i u_i k_i) v over [..., h, dh]."""
    return (r * u * k).sum(dim=-1, keepdim=True) * v


def rwkv_time_mix(params, x: torch.Tensor, cfg: cm.ArchConfig, *,
                  cache: RWKVCache | None = None):
    """x: [B,S,d].  Returns (out [B,S,d], (the new wkv state, the last
    input)): chunked from the cache's state (zeros without one) unless the
    call decodes (a cache and S == 1)."""
    B, S, d = x.shape
    h, dh = _dims(cfg)
    prev = (cache.tm_prev if cache is not None
            else torch.zeros((B, d), dtype=x.dtype, device=x.device))
    xm = _ddlerp(params, x, _token_shift(x, prev))         # [B,S,5,d]
    xr, xk, xv, xw, xg = xm.unbind(dim=2)
    r = (xr @ params["wr"]).reshape(B, S, h, dh).float()
    k = (xk @ params["wk"]).reshape(B, S, h, dh).float()
    v = (xv @ params["wv"]).reshape(B, S, h, dh).float()
    g = F.silu(xg @ params["wg"])
    dec = params["decay_base"] + (
        torch.tanh(xw @ params["decay_w1"]) @ params["decay_w2"]).float()
    lw = -torch.exp(dec).reshape(B, S, h, dh)              # log-decay, < 0
    u = params["bonus_u"]

    if cache is None or S > 1:
        with span("rwkv.wkv", "model"):
            state0 = (torch.zeros((B, h, dh, dh), dtype=torch.float32,
                                  device=x.device) if cache is None
                      else cache.state)
            if torch.is_grad_enabled() and any(
                    t.requires_grad for t in (r, k, v, lw, u, state0)):
                y, state = wkv.wkv6_plain(r, k, v, lw, u, state0,
                                          cfg.rwkv.chunk)
                path = "chunks"
            else:
                n0 = wkv.launches
                y, state = ops.wkv6(r, k, v, lw, u, state0, cfg.rwkv.chunk)
                path = "kernel" if wkv.launches > n0 else "chunks"
        reg = get_registry()
        if reg is not None:
            reg.counter("rwkv_wkv_calls_total").inc(1, path=path)
        new_prev = x[:, -1]
    else:
        S0 = cache.state
        r0, k0, v0 = r[:, 0], k[:, 0], v[:, 0]
        y = _bonus(r0, u, k0, v0) + torch.einsum("bhi,bhid->bhd", r0, S0)
        y = y[:, None]
        state = torch.exp(lw[:, 0])[..., None] * S0 + torch.einsum(
            "bhi,bhd->bhid", k0, v0)
        new_prev = x[:, 0]

    # per-head normalization (stands in for the reference GroupNorm ln_x)
    y = y * torch.rsqrt(y.square().mean(dim=-1, keepdim=True) + 1e-5)
    y = y.reshape(B, -1, d).to(x.dtype)
    y = y * (1.0 + params["ln_x_scale"]) * g
    return y @ params["wo"], (state, new_prev)


def rwkv_channel_mix(params, x: torch.Tensor, cfg: cm.ArchConfig, *,
                     cache: RWKVCache | None = None):
    """x: [B,S,d]. Returns (out [B,S,d], the last input)."""
    B, S, d = x.shape
    prev = (cache.cm_prev if cache is not None
            else torch.zeros((B, d), dtype=x.dtype, device=x.device))
    xx = _token_shift(x, prev) - x
    xk = x + xx * params["cmix_k/mix_mu"].to(x.dtype)
    xr = x + xx * params["cmix_r/mix_mu"].to(x.dtype)
    k = F.relu(xk @ params["wk"]).square()
    kv = k @ params["wv"]
    return torch.sigmoid(xr @ params["wr"]) * kv, x[:, -1]
