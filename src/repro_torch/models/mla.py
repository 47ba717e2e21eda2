"""DeepSeek multi-head latent attention (V2 / V3).

Port of ``repro.models.mla``.  The cache holds only the latents, ``c_kv``
``[B, T, kv_lora]`` and the shared rope key ``k_rope`` ``[B, T, qk_rope]``.
Prefill expands K and V from the latents and attends through the port's
``blocked_attention``, which on the card is the flash kernel at q / k
``qk_nope + qk_rope`` and v ``v_head_dim`` (192 / 128 at full width).
Decode is plain PyTorch, as the reference's is jnp, in two modes:

  * naive: K and V re-expanded from the whole latent cache every step;
  * absorbed (``cfg.mla.absorb``): W_UK folded into the query and W_UV
    into the output, so the scores read the latent cache directly.

Training runs the prefill branch with no cache under grad: its attention
is then ``FlashAttention``, whose backward is the gradient kernel at the
same (192, 128) widths, and the rope key that all heads share is an
``expand``, so its gradient sums over the heads.

Both decode modes follow the reference's rounding: f32 scores and softmax
from the cache dtype (its ``preferred_element_type`` products, written here as f32
products of the operands' own values), p rounded to the cache dtype
before the value product.  As in ``models/attention.py``, the mixer
writes the cache it is given IN PLACE and returns an ``MLACache`` over the
same buffers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import common as cm
from repro_torch.models.attention import NEG_INF, blocked_attention


def mla_param_specs(cfg: cm.ArchConfig) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim
    p = {}
    if m.q_lora_rank:
        p["wq_down"] = cm.spec((d, m.q_lora_rank), cfg.dtype)
        p["q_ln_scale"] = cm.spec((m.q_lora_rank,), cfg.dtype)
        p["wq_up"] = cm.spec((m.q_lora_rank, h * (qk + m.qk_rope_head_dim)),
                             cfg.dtype)
    else:
        p["wq"] = cm.spec((d, h * (qk + m.qk_rope_head_dim)), cfg.dtype)
    p["wkv_down"] = cm.spec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                            cfg.dtype)
    p["kv_ln_scale"] = cm.spec((m.kv_lora_rank,), cfg.dtype)
    p["wk_up"] = cm.spec((m.kv_lora_rank, h * qk), cfg.dtype)
    p["wv_up"] = cm.spec((m.kv_lora_rank, h * m.v_head_dim), cfg.dtype)
    p["wo"] = cm.spec((h * m.v_head_dim, d), cfg.dtype)
    return p


class MLACache(NamedTuple):
    c_kv: torch.Tensor       # [B, T, kv_lora] in the model dtype
    k_rope: torch.Tensor     # [B, T, qk_rope]
    length: torch.Tensor     # [] int32 — entries written so far


def mla_cache_specs(cfg: cm.ArchConfig, batch: int, max_len: int) -> MLACache:
    m = cfg.mla
    return MLACache(
        c_kv=cm.spec((batch, max_len, m.kv_lora_rank), cfg.dtype),
        k_rope=cm.spec((batch, max_len, m.qk_rope_head_dim), cfg.dtype),
        length=cm.spec((), torch.int32))


def init_mla_cache(cfg: cm.ArchConfig, batch: int, max_len: int, *,
                   device) -> MLACache:
    m = cfg.mla
    return MLACache(
        c_kv=torch.zeros((batch, max_len, m.kv_lora_rank), dtype=cfg.dtype,
                         device=device),
        k_rope=torch.zeros((batch, max_len, m.qk_rope_head_dim),
                           dtype=cfg.dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device))


def _queries(params, x: torch.Tensor, cfg: cm.ArchConfig,
             positions: torch.Tensor):
    m = cfg.mla
    B, S, _ = x.shape
    h, qk, qr = cfg.n_heads, m.qk_nope_head_dim, m.qk_rope_head_dim
    if m.q_lora_rank:
        cq = cm.rms_norm(x @ params["wq_down"], params["q_ln_scale"],
                         cfg.norm_eps)
        q = (cq @ params["wq_up"]).reshape(B, S, h, qk + qr)
    else:
        q = (x @ params["wq"]).reshape(B, S, h, qk + qr)
    q_nope, q_rope = q[..., :qk], q[..., qk:]
    q_rope = cm.apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _latents(params, x: torch.Tensor, cfg: cm.ArchConfig,
             positions: torch.Tensor):
    m = cfg.mla
    ckr = x @ params["wkv_down"]
    c_kv = cm.rms_norm(ckr[..., :m.kv_lora_rank], params["kv_ln_scale"],
                       cfg.norm_eps)
    k_rope = ckr[..., m.kv_lora_rank:]
    # shared (MQA-style) rope key: one head, broadcast to every query head
    k_rope = cm.apply_rope(k_rope[:, :, None, :], positions,
                           cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_mixer(params, x: torch.Tensor, cfg: cm.ArchConfig, *,
              positions: torch.Tensor, cache: MLACache | None = None):
    """x: [B, S, D]. Returns (y, new_cache).  Prefill when cache is None;
    with a cache, S > 1 fills it (prefill-fill) and S == 1 decodes."""
    m = cfg.mla
    B, S, _ = x.shape
    h, qk, qr, dv = (cfg.n_heads, m.qk_nope_head_dim, m.qk_rope_head_dim,
                     m.v_head_dim)
    q_nope, q_rope = _queries(params, x, cfg, positions)
    c_new, kr_new = _latents(params, x, cfg, positions)

    if cache is None or S > 1:
        # prefill: expand K / V, attend with per-head keys
        k_nope = (c_new @ params["wk_up"]).reshape(B, S, h, qk)
        v = (c_new @ params["wv_up"]).reshape(B, S, h, dv)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, kr_new[:, :, None, :].expand(B, S, h, qr)],
                      dim=-1)
        o = blocked_attention(q, k, v, causal=True)
        y = o.reshape(B, S, h * dv) @ params["wo"]
        if cache is None:
            return y, None
        # prefill-fill: latents into slots [0, S), zeros after, length S
        T = cache.c_kv.shape[1]
        if S > T:
            raise ValueError(f"prompt of {S} tokens exceeds the {T}-slot "
                             "MLA cache")
        for buf, new in ((cache.c_kv, c_new), (cache.k_rope, kr_new)):
            buf[:, :S].copy_(new)
            buf[:, S:].zero_()
        return y, MLACache(cache.c_kv, cache.k_rope, torch.full(
            (), S, dtype=torch.int32, device=cache.c_kv.device))

    # decode: S == 1; write slot min(length, T-1), score t < length + 1
    T = cache.c_kv.shape[1]
    slot = torch.clamp(cache.length, max=T - 1).reshape(1).long()
    cache.c_kv.index_copy_(1, slot, c_new.to(cache.c_kv.dtype))
    cache.k_rope.index_copy_(1, slot, kr_new.to(cache.k_rope.dtype))
    c_kv, k_rope = cache.c_kv, cache.k_rope
    new_len = cache.length + 1
    valid = torch.arange(T, device=x.device) < new_len
    scale = (qk + qr) ** -0.5
    qr1 = q_rope[:, 0].to(k_rope.dtype).float()              # [B, h, qr]
    s_rope = torch.einsum("bhd,btd->bht", qr1, k_rope.float())

    if m.absorb:
        # fold W_UK into q: q_lat[b, h, r] = sum_d q_nope[b, h, d] W_UK[r, h, d]
        wk = params["wk_up"].reshape(m.kv_lora_rank, h, qk)
        q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(),
                             wk.float()).to(c_kv.dtype)
        s = (torch.einsum("bhr,btr->bht", q_lat.float(), c_kv.float())
             + s_rope) * scale
        s = torch.where(valid, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bht,btr->bhr", p.to(c_kv.dtype).float(),
                             c_kv.float())
        wv = params["wv_up"].reshape(m.kv_lora_rank, h, dv)
        o = torch.einsum("bhr,rhd->bhd", o_lat.to(wv.dtype).float(),
                         wv.float())
    else:
        # naive: re-expand all K / V from the latents every step
        k_nope = (c_kv @ params["wk_up"]).reshape(B, T, h, qk)
        v = (c_kv @ params["wv_up"]).reshape(B, T, h, dv)
        s = (torch.einsum("bhd,bthd->bht", q_nope[:, 0].float(),
                          k_nope.float()) + s_rope) * scale
        s = torch.where(valid, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bht,bthd->bhd", p.to(v.dtype).float(), v.float())

    y = o.reshape(B, 1, h * dv).to(x.dtype) @ params["wo"]
    return y, MLACache(c_kv, k_rope, new_len)
