"""Encoder-decoder transformer (whisper-small backbone).

Port of ``repro.models.encdec``.  The audio conv frontend is a stub, as in
the reference: the encoder takes precomputed frame embeddings
[B, n_frames, d] (cast to the model dtype) and runs at their length.  The
encoder is bidirectional: q and k roped at ``arange(n_frames)``, the flash
kernel without the causal mask.  Each decoder layer runs causal
self-attention (the port's ``attention_mixer``), then cross-attention to
the encoder's output (no rope; q from the decoder's S positions against
the encoder's T keys, ``n_heads`` of them, on the flash kernel without
the causal mask), then the MLP.  Cross k / v are formed once at encode
time and held in the serving cache (whisper's serving layout).

The reference stacks each side's layers (``enc_body`` / ``dec_body``) and
scans them; the port keeps one parameter tree per layer
(``params["enc_layers"][i]``, ``params["dec_layers"][i]``) and runs them
in a plain loop; under ``cfg.remat``, with grad enabled, each layer runs
under ``torch.utils.checkpoint`` as the reference's runs under
``jax.checkpoint``.  The self cache is one ``KVCache`` a decoder layer,
written in place by decode, as ``LM``'s caches are.  ``EncDec`` holds the
parameters as an ``nn.Module`` on one device, frozen for serving.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod


def _xattn_param_specs(cfg: cm.ArchConfig) -> dict:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    return {"wq": cm.spec((d, h * dh), cfg.dtype),
            "wk": cm.spec((d, h * dh), cfg.dtype),
            "wv": cm.spec((d, h * dh), cfg.dtype),
            "wo": cm.spec((h * dh, d), cfg.dtype)}


def encdec_param_specs(cfg: cm.ArchConfig) -> dict:
    d = cfg.d_model
    enc_block = {"ln1_scale": cm.spec((d,), cfg.dtype),
                 "mixer": attn.attn_param_specs(cfg),
                 "ln2_scale": cm.spec((d,), cfg.dtype),
                 "mlp": mlp_mod.mlp_param_specs(cfg)}
    dec_block = {"ln1_scale": cm.spec((d,), cfg.dtype),
                 "self": attn.attn_param_specs(cfg),
                 "ln_x_scale": cm.spec((d,), cfg.dtype),
                 "cross": _xattn_param_specs(cfg),
                 "ln2_scale": cm.spec((d,), cfg.dtype),
                 "mlp": mlp_mod.mlp_param_specs(cfg)}
    return {
        "embed": cm.spec((cfg.vocab_size, d), cfg.dtype),
        "enc_layers": [enc_block] * cfg.n_enc_layers,
        "enc_final_scale": cm.spec((d,), cfg.dtype),
        "dec_layers": [dec_block] * cfg.n_layers,
        "final_scale": cm.spec((d,), cfg.dtype),
    }


def init_encdec_params(cfg: cm.ArchConfig, gen: torch.Generator) -> dict:
    """Seeded parameters by the reference's naming rules (a stacked
    reference leaf [n, d, f] has the fan-in d of a layer's [d, f])."""
    return cm.init_from_specs(gen, encdec_param_specs(cfg))


class EncDec(cm.ParamTree):
    """The model's parameters on ``device``; ``model["dec_layers"][i]
    ["cross"]["wq"]`` ... read them, so an ``EncDec`` is the ``params``
    argument of every function here."""

    def __init__(self, cfg: cm.ArchConfig, params: dict, *, device="cuda"):
        dev = resolve_device(device)
        super().__init__(cm.map_tree(lambda _, t: t.to(dev), params))
        self.cfg = cfg
        self.device = dev


def _layers(fn, layers, x, *args, cfg: cm.ArchConfig):
    """``x = fn(p, x, *args)`` over ``layers`` in order, each layer under
    ``checkpoint`` when ``cfg.remat`` and grad is enabled."""
    remat = cfg.remat and torch.is_grad_enabled()
    for p in layers:
        x = (checkpoint(fn, p, x, *args, use_reentrant=False) if remat
             else fn(p, x, *args))
    return x


# ---------------------------------------------------------------------------

def _enc_layer(p, x, positions, cfg):
    h = cm.rms_norm(x, p["ln1_scale"], cfg.norm_eps)
    B, S, _ = h.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (h @ p["mixer"]["wq"]).reshape(B, S, H, dh)
    k = (h @ p["mixer"]["wk"]).reshape(B, S, K, dh)
    v = (h @ p["mixer"]["wv"]).reshape(B, S, K, dh)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    o = attn.blocked_attention(q, k, v, causal=False)
    x = x + o.reshape(B, S, H * dh) @ p["mixer"]["wo"]
    h = cm.rms_norm(x, p["ln2_scale"], cfg.norm_eps)
    return x + mlp_mod.mlp_apply(p["mlp"], h, cfg)


def encode(params, frames: torch.Tensor, cfg: cm.ArchConfig) -> torch.Tensor:
    """frames: [B, S_enc, d] precomputed stub embeddings -> the encoder's
    final-normed hidden [B, S_enc, d] in the model dtype."""
    x = frames.to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _layers(lambda p, x: _enc_layer(p, x, positions, cfg),
                params["enc_layers"], x, cfg=cfg)
    return cm.rms_norm(x, params["enc_final_scale"], cfg.norm_eps)


def _cross_attend(p, h, k_cross, v_cross, cfg):
    B, S, _ = h.shape
    H, dh = cfg.n_heads, cfg.d_head
    q = (h @ p["wq"]).reshape(B, S, H, dh)
    o = attn.blocked_attention(q, k_cross, v_cross, causal=False)
    return o.reshape(B, S, H * dh) @ p["wo"]


def _cross_kv_one(p, enc_out, cfg):
    B = enc_out.shape[0]
    H, dh = cfg.n_heads, cfg.d_head
    return ((enc_out @ p["wk"]).reshape(B, -1, H, dh),
            (enc_out @ p["wv"]).reshape(B, -1, H, dh))


def cross_kv(params, enc_out: torch.Tensor, cfg: cm.ArchConfig):
    """Per-layer cross k / v, each stacked [L, B, S_enc, H, dh]."""
    ks, vs = zip(*(_cross_kv_one(p["cross"], enc_out, cfg)
                   for p in params["dec_layers"]))
    return torch.stack(ks), torch.stack(vs)


def _dec_layer(p, x, enc_out, positions, cfg):
    h = cm.rms_norm(x, p["ln1_scale"], cfg.norm_eps)
    y, _ = attn.attention_mixer(p["self"], h, cfg, kind=cm.MIXER_FULL,
                                positions=positions, cache=None)
    x = x + y
    h = cm.rms_norm(x, p["ln_x_scale"], cfg.norm_eps)
    k, v = _cross_kv_one(p["cross"], enc_out, cfg)
    x = x + _cross_attend(p["cross"], h, k, v, cfg)
    h = cm.rms_norm(x, p["ln2_scale"], cfg.norm_eps)
    return x + mlp_mod.mlp_apply(p["mlp"], h, cfg)


def decode_train(params, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: cm.ArchConfig) -> torch.Tensor:
    """Teacher-forced decoder forward -> final-normed hidden [B, S_dec, d]
    (the token embeddings unscaled, as the reference takes them)."""
    x = F.embedding(tokens, params["embed"])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _layers(lambda p, x, e: _dec_layer(p, x, e, positions, cfg),
                params["dec_layers"], x, enc_out, cfg=cfg)
    return cm.rms_norm(x, params["final_scale"], cfg.norm_eps)


def encdec_loss(params, batch: dict, cfg: cm.ArchConfig, **_):
    """Next-token cross-entropy of ``batch["tokens"]`` [B, S] given
    ``batch["frames"]``: f32 of the model-dtype product ``x @ embed.T``
    over the whole sequence (not ``lm_loss``'s chunks), labels the tokens
    shifted left with -1 at the end, ``sum((lse - gold) * mask) /
    max(sum(mask), 1)``.  Returns ``(loss, {"ce": loss, "aux": 0})``."""
    enc_out = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    x = decode_train(params, tokens, enc_out, cfg)
    logits = (x @ params["embed"].T).float()
    labels = F.pad(tokens[:, 1:].long(), (0, 1), value=-1)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    loss = ((lse - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, {"ce": loss,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=loss.device)}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

class EncDecCache(NamedTuple):
    self_kv: list | None       # a KVCache a decoder layer (None: no cache)
    cross_k: torch.Tensor      # [L, B, S_enc, H, dh]
    cross_v: torch.Tensor


def init_encdec_cache(cfg: cm.ArchConfig, batch: int, max_len: int, *,
                      device="cuda") -> EncDecCache:
    """Zeros on ``device``: a ``max_len``-slot self cache a decoder layer
    and cross k / v at ``cfg.enc_seq``, the reference's cache specs."""
    dev = resolve_device(device)
    xs = (cfg.n_layers, batch, cfg.enc_seq, cfg.n_heads, cfg.d_head)
    return EncDecCache(
        self_kv=[attn.init_kv_cache(cfg, batch, max_len, device=dev)
                 for _ in range(cfg.n_layers)],
        cross_k=torch.zeros(xs, dtype=cfg.dtype, device=dev),
        cross_v=torch.zeros(xs, dtype=cfg.dtype, device=dev))


def encdec_decode_step(params, tokens: torch.Tensor, cfg: cm.ArchConfig,
                       caches: EncDecCache, *, pos: int):
    """One decoder step. tokens: [B, 1]; pos: absolute position.  Each
    layer's self cache is written in place (with ``caches.self_kv`` None
    the self-attention sees the token alone, the reference's prefill path);
    the cross k / v are read.  Returns (logits [B, V] in the model dtype,
    caches)."""
    x = F.embedding(tokens, params["embed"])
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    new_kv = None if caches.self_kv is None else []
    for i, p in enumerate(params["dec_layers"]):
        kv = None if caches.self_kv is None else caches.self_kv[i]
        h = cm.rms_norm(x, p["ln1_scale"], cfg.norm_eps)
        y, kv = attn.attention_mixer(p["self"], h, cfg, kind=cm.MIXER_FULL,
                                     positions=positions, cache=kv)
        x = x + y
        h = cm.rms_norm(x, p["ln_x_scale"], cfg.norm_eps)
        x = x + _cross_attend(p["cross"], h, caches.cross_k[i],
                              caches.cross_v[i], cfg)
        h = cm.rms_norm(x, p["ln2_scale"], cfg.norm_eps)
        x = x + mlp_mod.mlp_apply(p["mlp"], h, cfg)
        if new_kv is not None:
            new_kv.append(kv)
    x = cm.rms_norm(x, params["final_scale"], cfg.norm_eps)
    logits = (x @ params["embed"].T)[:, 0]
    return logits, EncDecCache(new_kv, caches.cross_k, caches.cross_v)


def prefill(params, frames: torch.Tensor, cfg: cm.ArchConfig,
            caches: EncDecCache | None = None):
    """Encode, form the cross k / v (at the frames' length), and run one
    decoder step on the BOS token (0) at pos 0 with no self cache, as the
    reference's prefill does: the self cache stays empty until decode, so
    ``caches.self_kv`` comes back as it was given, unwritten (None without
    ``caches``).  Returns (logits [B, V], EncDecCache)."""
    enc_out = encode(params, frames, cfg)
    ck, cv = cross_kv(params, enc_out, cfg)
    bos = torch.zeros((frames.shape[0], 1), dtype=torch.int32,
                      device=enc_out.device)
    logits, _ = encdec_decode_step(params, bos, cfg,
                                   EncDecCache(None, ck, cv), pos=0)
    return logits, EncDecCache(None if caches is None else caches.self_kv,
                               ck, cv)
