"""Attention mixer: GQA full / sliding-window attention, softcap, decode with
a KV cache.

Port of ``repro.models.attention`` for the dense-attention decoder.  The
prefill path, ``blocked_attention``, is the flash-attention entry point:
the hand-written kernel on a CUDA tensor, its plain version on a CPU
tensor.  ``decode_attention`` is plain PyTorch, as the reference's is jnp.

Unlike the reference's pure functions, the mixer writes k and v into the
cache it is given IN PLACE and returns a ``KVCache`` over the same
buffers: a cache is owned by one generation and never read after the call
that updates it.  Not ported yet (each raises ``NotImplementedError``):
the int8 cache and the ring cache of sliding-window decode.  The kernel
always skips key tiles the masks zero, which is exact, so the reference's
``prune`` option has no counterpart.
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
                     softcap_val: float = 0.0):
    """Single-position decode. q: [B,1,H,dh]; k,v: [B,T,Kv,dh] cache.

    ``cache_len``: number of valid entries *including* the token just
    written (an int or a 0-d tensor on the cache's device).  Scores and the
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
    if window:
        valid = valid & (cache_len - 1 - tpos < window)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, 1, H, dh).to(v.dtype)


# ---------------------------------------------------------------------------
# Full mixer: projections + rope + attention (+cache plumbing)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor          # [B, T, Kv, dh] in the model dtype
    v: torch.Tensor
    length: torch.Tensor     # [] int32 — entries written so far


def init_kv_cache(cfg: cm.ArchConfig, batch: int, max_len: int, *,
                  device, window: bool = False) -> KVCache:
    if cfg.kv_cache_dtype != "bf16":
        raise NotImplementedError(f"{cfg.kv_cache_dtype} KV cache: "
                                  f"{cm.NOT_PORTED}")
    T = min(max_len, cfg.sliding_window) if window else max_len
    if window and T == cfg.sliding_window:
        raise NotImplementedError(f"ring KV cache of sliding-window decode: "
                                  f"{cm.NOT_PORTED}")
    shape = (batch, T, cfg.n_kv_heads, cfg.d_head)
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   length=torch.zeros((), dtype=torch.int32, device=device))


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
        new_cache = None
        if cache is not None:
            # prefill-fill: k, v into slots [0, S), zeros after, length S
            T = cache.k.shape[1]
            if S > T:
                raise ValueError(f"prompt of {S} tokens exceeds the {T}-slot "
                                 "KV cache")
            for buf, new in ((cache.k, k), (cache.v, v)):
                buf[:, :S].copy_(new)
                buf[:, S:].zero_()
            new_cache = KVCache(cache.k, cache.v, torch.full(
                (), S, dtype=torch.int32, device=cache.k.device))
    else:
        # decode: S == 1; write into the cache then attend
        T = cache.k.shape[1]
        slot = torch.clamp(cache.length, max=T - 1).reshape(1).long()
        cache.k.index_copy_(1, slot, k.to(cache.k.dtype))
        cache.v.index_copy_(1, slot, v.to(cache.v.dtype))
        new_len = cache.length + 1
        o = decode_attention(q, cache.k, cache.v, cache_len=new_len,
                             window=window, softcap_val=cap)
        new_cache = KVCache(cache.k, cache.v, new_len)

    y = o.reshape(B, S, H * dh) @ params["wo"]
    return y, new_cache
