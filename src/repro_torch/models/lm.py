"""Decoder-only language model: embedding -> blocks -> final norm -> head.

Port of the serving half of ``repro.models.lm``: ``_embed``,
``_run_blocks``, ``forward_logits``, ``prefill`` and ``decode_step``.  The
reference scans over stacked periods; the port keeps one parameter tree per
layer (``params["layers"][i]``) and runs them in a plain loop, with no
remat and no sharding constraint.  ``LM`` holds the parameters as an
``nn.Module`` on one device.  ``lm_loss`` comes with the training slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import blocks as blk
from repro_torch.models import common as cm


def lm_param_specs(cfg: cm.ArchConfig) -> dict:
    d = cfg.d_model
    specs = {
        "embed": cm.spec((cfg.vocab_size, d), cfg.dtype),
        "final_scale": cm.spec((d,), cfg.dtype),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = cm.spec((d, cfg.vocab_size), cfg.dtype)
    specs["layers"] = [
        blk.block_param_specs(cfg, mk, lk, (cfg.d_ff_dense_prefix or cfg.d_ff)
                              if i < cfg.n_dense_prefix else None)
        for i, (mk, lk) in enumerate(cfg.layer_kinds())]
    return specs


def init_lm_params(cfg: cm.ArchConfig, gen: torch.Generator) -> dict:
    return cm.init_from_specs(gen, lm_param_specs(cfg))


class LM(cm.ParamTree):
    """The model's parameters on ``device``; ``lm["embed"]``,
    ``lm["layers"][i]["mixer"]["wq"]`` ... read them, so an ``LM`` is the
    ``params`` argument of every function here."""

    def __init__(self, cfg: cm.ArchConfig, params: dict, *, device="cuda"):
        dev = resolve_device(device)
        super().__init__(cm.map_tree(lambda _, t: t.to(dev), params))
        self.cfg = cfg
        self.device = dev


def init_lm_cache(cfg: cm.ArchConfig, batch: int, max_len: int, *,
                  device="cuda") -> list:
    """One ``KVCache`` per layer, zero-filled on ``device``."""
    dev = resolve_device(device)
    return [blk.init_block_cache(cfg, mk, batch, max_len, device=dev)
            for mk, _ in cfg.layer_kinds()]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def embed_scale(cfg: cm.ArchConfig) -> float:
    """sqrt(d_model) rounded to the model dtype, as the reference's
    ``jnp.asarray(d_model ** 0.5, x.dtype)`` is (27.75 in bf16 at d = 768)."""
    return float(torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype))


def _embed(params, tokens: torch.Tensor, cfg: cm.ArchConfig) -> torch.Tensor:
    x = F.embedding(tokens, params["embed"])
    return x * embed_scale(cfg)       # gemma-style embed scale


def _run_blocks(params, x: torch.Tensor, cfg: cm.ArchConfig, *,
                positions: torch.Tensor, caches: list | None = None):
    """Every layer in order. Returns (hidden, new caches or None)."""
    new_caches = None if caches is None else []
    for i, (mk, lk) in enumerate(cfg.layer_kinds()):
        out = blk.block_apply(params["layers"][i], x, cfg, mixer_kind=mk,
                              mlp_kind=lk, positions=positions,
                              cache=None if caches is None else caches[i])
        x = out.x
        if caches is not None:
            new_caches.append(out.cache)
    return x, new_caches


def forward_hidden(params, tokens: torch.Tensor,
                   cfg: cm.ArchConfig) -> torch.Tensor:
    x = _embed(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _ = _run_blocks(params, x, cfg, positions=positions)
    return cm.rms_norm(x, params["final_scale"], cfg.norm_eps)


def _head(params, x: torch.Tensor, cfg: cm.ArchConfig) -> torch.Tensor:
    """Logits in the model dtype, or f32 under a final softcap."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ w
    if cfg.final_logit_softcap:
        logits = cm.softcap(logits.float(), cfg.final_logit_softcap)
    return logits


def forward_logits(params, tokens: torch.Tensor,
                   cfg: cm.ArchConfig) -> torch.Tensor:
    return _head(params, forward_hidden(params, tokens, cfg), cfg)


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------

def prefill(params, tokens: torch.Tensor, cfg: cm.ArchConfig,
            caches: list[attn.KVCache]):
    """Fill caches from a prompt [B, S]; returns (last-token logits [B, V],
    caches).  The caches are written in place."""
    x = _embed(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, new_caches = _run_blocks(params, x, cfg, positions=positions,
                                caches=caches)
    x = cm.rms_norm(x[:, -1:], params["final_scale"], cfg.norm_eps)
    return _head(params, x, cfg)[:, 0], new_caches


def decode_step(params, tokens: torch.Tensor, cfg: cm.ArchConfig,
                caches: list[attn.KVCache], *, pos: int):
    """One decode step. tokens: [B,1]; pos: absolute position.
    Returns (logits [B,V], caches written in place)."""
    x = _embed(params, tokens, cfg)
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    x, new_caches = _run_blocks(params, x, cfg, positions=positions,
                                caches=caches)
    x = cm.rms_norm(x, params["final_scale"], cfg.norm_eps)
    return _head(params, x, cfg)[:, 0], new_caches


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] -> [B, 1] int32: the first index of each row's maximum
    (``jnp.argmax``'s rule, which ``torch.argmax`` does not promise)."""
    mx = logits.amax(dim=-1, keepdim=True)
    ar = torch.arange(logits.shape[-1], device=logits.device)
    first = torch.where(logits == mx, ar, logits.shape[-1]).amin(dim=-1)
    return first.to(torch.int32)[:, None]
