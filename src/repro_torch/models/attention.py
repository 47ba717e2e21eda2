"""Attention mixer: GQA full / sliding-window attention, softcap, decode with
a KV cache.

Port of ``repro.models.attention`` for the dense-attention decoder.  The
prefill path, ``blocked_attention``, is the flash-attention entry point:
the hand-written kernel on a CUDA tensor, its plain version on a CPU
tensor.  ``decode_attention`` is plain PyTorch, as the reference's is jnp.

The KV cache is the reference's whole cache: in the model dtype, or int8
with an f32 scale per token and kv head (``cfg.kv_cache_dtype``); and on a
sliding-window layer whose ``max_len`` reaches the window, a ring of
``window`` slots, position p in slot ``p % window``.  Unlike the
reference's pure functions, the mixer writes k, v (and their scales) into
the cache it is given IN PLACE and returns a ``KVCache`` over the same
buffers: a cache is owned by one generation and never read after the call
that updates it.  The kernel always skips key tiles the masks zero, which
is exact, so the reference's ``prune`` option has no counterpart.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import common as cm

NEG_INF = -1e30


def attn_param_specs(cfg: cm.ArchConfig) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": cm.spec((d, h * dh), cfg.dtype),
        "wk": cm.spec((d, kv * dh), cfg.dtype),
        "wv": cm.spec((d, kv * dh), cfg.dtype),
        "wo": cm.spec((h * dh, d), cfg.dtype),
    }
    if cfg.qk_norm:
        p["q_scale"] = cm.spec((dh,), cfg.dtype)
        p["k_scale"] = cm.spec((dh,), cfg.dtype)
    return p


# ---------------------------------------------------------------------------
# Core attention
# ---------------------------------------------------------------------------

def blocked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      softcap_val: float = 0.0):
    """q: [B,S,H,dh]; k,v: [B,S,Kv,dh]. window>0 => sliding-window causal.
    Returns [B,S,H,dh] in v's dtype."""
    return ops.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                    softcap=softcap_val).to(v.dtype)


def decode_attention(q, k, v, *, cache_len, window: int = 0,
                     softcap_val: float = 0.0, ring: bool = False):
    """Single-position decode. q: [B,1,H,dh]; k,v: [B,T,Kv,dh] cache.

    ``cache_len``: number of valid entries *including* the token just
    written (an int or a 0-d tensor on the cache's device).  ``ring``: the
    cache is a ring of the window's last entries, every slot valid once
    ``cache_len >= T``, so the window needs no mask.  Scores and the
    softmax in f32 from the cache dtype, p rounded to v's dtype."""
    B, _, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = dh ** -0.5
    qh = q.reshape(B, K, G, dh).float()
    s = torch.einsum("bkgd,btkd->bkgt", qh, k.float()) * scale
    if softcap_val:
        s = cm.softcap(s, softcap_val)
    tpos = torch.arange(T, device=q.device)
    valid = tpos < cache_len
    if window and not ring:
        valid = valid & (cache_len - 1 - tpos < window)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, 1, H, dh).to(v.dtype)


# ---------------------------------------------------------------------------
# Full mixer: projections + rope + attention (+cache plumbing)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor          # [B, T, Kv, dh]: the model dtype, or int8
    v: torch.Tensor
    length: torch.Tensor     # [] int32 — entries written so far
    k_scale: torch.Tensor | None = None   # [B, T, Kv, 1] f32 (int8 mode)
    v_scale: torch.Tensor | None = None


def init_kv_cache(cfg: cm.ArchConfig, batch: int, max_len: int, *,
                  device, window: bool = False) -> KVCache:
    """Zeros for ``max_len`` positions; ``window``: a sliding-window
    layer's cache, ``min(max_len, cfg.sliding_window)`` slots (a ring when
    it is the window)."""
    T = min(max_len, cfg.sliding_window) if window else max_len
    shape = (batch, T, cfg.n_kv_heads, cfg.d_head)
    int8 = cfg.kv_cache_dtype == "int8"

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def scale():
        return zeros(shape[:-1] + (1,), torch.float32) if int8 else None

    dt = torch.int8 if int8 else cfg.dtype
    return KVCache(k=zeros(shape, dt), v=zeros(shape, dt),
                   length=zeros((), torch.int32), k_scale=scale(),
                   v_scale=scale())


def _quantize_kv(x: torch.Tensor):
    """[B,S,K,dh] -> (int8 values, [B,S,K,1] f32 scales): the largest
    magnitude of a (token, head) row maps to 127, rounded half to even."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / s), -127, 127)
    return q.to(torch.int8), s


def _dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * s).to(dtype)


def _writes(cache: KVCache, k: torch.Tensor, v: torch.Tensor) -> list:
    """(buffer, values) pairs of a cache write: k and v, or for an int8
    cache their int8 values and scales."""
    if cache.k_scale is None:
        return [(cache.k, k), (cache.v, v)]
    (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
    return [(cache.k, kq), (cache.v, vq), (cache.k_scale, ks),
            (cache.v_scale, vs)]


def _fill(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
          window: int) -> KVCache:
    """Prefill-fill: k, v [B, S, Kv, dh] (and, for an int8 cache, their
    scales) into the cache's buffers.  A ring keeps the last ``window``
    entries, position p in slot ``p % window``; otherwise slots [0, S)
    and zeros after.  Length S."""
    S, T = k.shape[1], cache.k.shape[1]
    ring = bool(window) and T == window and S >= window
    if S > T and not ring:
        raise ValueError(f"prompt of {S} tokens exceeds the {T}-slot "
                         "KV cache")
    for buf, new in _writes(cache, k, v):
        if ring:
            buf.copy_(torch.roll(new[:, -window:], (S - window) % window,
                                 dims=1))
        else:
            buf[:, :S].copy_(new)
            buf[:, S:].zero_()
    return cache._replace(length=torch.full((), S, dtype=torch.int32,
                                            device=cache.k.device))


def _write_slot(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                ring: bool) -> KVCache:
    """Decode: the token's k, v [B, 1, Kv, dh] (quantized for an int8
    cache) into slot ``length % T`` of a ring, else ``min(length, T - 1)``;
    length + 1."""
    T = cache.k.shape[1]
    slot = (cache.length % T if ring
            else torch.clamp(cache.length, max=T - 1)).reshape(1).long()
    for buf, new in _writes(cache, k, v):
        buf.index_copy_(1, slot, new.to(buf.dtype))
    return cache._replace(length=cache.length + 1)


def attention_mixer(params, x: torch.Tensor, cfg: cm.ArchConfig, *,
                    kind: str, positions: torch.Tensor,
                    cache: KVCache | None = None):
    """x: [B,S,D]. Returns (y, new_cache). Prefill when cache is None;
    with a cache, S > 1 fills it (prefill-fill) and S == 1 decodes."""
    B, S, D = x.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ params["wq"]).reshape(B, S, H, dh)
    k = (x @ params["wk"]).reshape(B, S, K, dh)
    v = (x @ params["wv"]).reshape(B, S, K, dh)
    if cfg.qk_norm:
        q = cm.rms_norm(q, params["q_scale"], cfg.norm_eps)
        k = cm.rms_norm(k, params["k_scale"], cfg.norm_eps)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)

    window = cfg.sliding_window if kind == cm.MIXER_SWA else 0
    cap = cfg.attn_logit_softcap

    if cache is None or S > 1:
        o = blocked_attention(q, k, v, causal=True, window=window,
                              softcap_val=cap)
        new_cache = None if cache is None else _fill(cache, k, v, window)
    else:
        # decode: S == 1; write into the cache then attend
        ring = window > 0 and cache.k.shape[1] == window
        new_cache = _write_slot(cache, k, v, ring)
        k_read, v_read = new_cache.k, new_cache.v
        if new_cache.k_scale is not None:
            k_read = _dequantize_kv(k_read, new_cache.k_scale, cfg.dtype)
            v_read = _dequantize_kv(v_read, new_cache.v_scale, cfg.dtype)
        o = decode_attention(q, k_read, v_read, cache_len=new_cache.length,
                             window=window, softcap_val=cap, ring=ring)

    y = o.reshape(B, S, H * dh) @ params["wo"]
    return y, new_cache
