"""Uniform model API over the port's decoder-only LMs and the
encoder-decoder family.

Port of ``repro.models.api``:
    api = model_api(cfg)
    api.param_specs() / api.init(generator, device=...)  -> LM / EncDec
    api.loss(params, batch, **kw)               -> (scalar, metrics)
    api.forward(params, batch)                  -> logits [B, n + S, V]
    api.prefill(params, batch, caches)          -> (logits [B, V], caches)
    api.decode(params, tokens, caches, pos)     -> (logits [B, V], caches)
    api.init_cache(batch, max_len, device=...)  -> a KVCache / MLACache /
                                                   MambaCache / RWKVCache a layer
``batch`` holds ``tokens`` [B, S] and, for a vision model, may hold
``extra_embeds`` [B, n, d] (the frontend's n patch embeddings, put in
front of the tokens).  For the encoder-decoder (whisper) ``batch`` holds
``frames`` [B, S_enc, d] (and ``tokens`` [B, S_dec] to train on):
``forward`` is the encoder (hidden [B, S_enc, d]), ``prefill(params,
batch, caches=None)`` encodes and runs the BOS step, returning an
``EncDecCache`` whose self cache is the one given, unwritten, and
``decode`` steps the decoder.  ``init`` and ``init_cache`` run on the card
unless ``device="cpu"`` is passed; the other entry points run where their
parameters and inputs lie.  ``init`` returns frozen parameters (serving);
``.requires_grad_(True)`` on the result trains them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import encdec as ed_mod
from repro_torch.models import lm as lm_mod


@dataclass(frozen=True)
class ModelAPI:
    cfg: cm.ArchConfig
    param_specs: Callable[[], Any]
    init: Callable[..., Any]
    loss: Callable[..., Any]
    forward: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    init_cache: Callable[..., Any]


def _seeded_init(cfg: cm.ArchConfig, model_cls, init_params):
    def init(generator: torch.Generator | None = None, *, device="cuda"):
        """Seeded parameters (``generator``, default seed 0 on the CPU) as
        the model's ``ParamTree`` on ``device``."""
        dev = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        return model_cls(cfg, init_params(cfg, gen), device=dev)
    return init


def model_api(cfg: cm.ArchConfig) -> ModelAPI:
    if cfg.encdec:
        return ModelAPI(
            cfg=cfg,
            param_specs=lambda: ed_mod.encdec_param_specs(cfg),
            init=_seeded_init(cfg, ed_mod.EncDec, ed_mod.init_encdec_params),
            loss=lambda params, batch, **kw: ed_mod.encdec_loss(
                params, batch, cfg, **kw),
            forward=lambda params, batch: ed_mod.encode(
                params, batch["frames"], cfg),
            prefill=lambda params, batch, caches=None: ed_mod.prefill(
                params, batch["frames"], cfg, caches),
            decode=lambda params, tokens, caches, pos:
                ed_mod.encdec_decode_step(params, tokens, cfg, caches,
                                          pos=pos),
            init_cache=lambda batch, max_len, *, device="cuda":
                ed_mod.init_encdec_cache(cfg, batch, max_len, device=device),
        )

    def _forward(params, batch):
        return lm_mod.forward_logits(params, batch["tokens"], cfg,
                                     extra_embeds=batch.get("extra_embeds"))

    return ModelAPI(
        cfg=cfg,
        param_specs=lambda: lm_mod.lm_param_specs(cfg),
        init=_seeded_init(cfg, lm_mod.LM, lm_mod.init_lm_params),
        loss=lambda params, batch, **kw: lm_mod.lm_loss(params, batch, cfg,
                                                        **kw),
        forward=_forward,
        prefill=lambda params, batch, caches: lm_mod.prefill(
            params, batch["tokens"], cfg, caches,
            extra_embeds=batch.get("extra_embeds")),
        decode=lambda params, tokens, caches, pos: lm_mod.decode_step(
            params, tokens, cfg, caches, pos=pos),
        init_cache=lambda batch, max_len, *, device="cuda":
            lm_mod.init_lm_cache(cfg, batch, max_len, device=device),
    )
