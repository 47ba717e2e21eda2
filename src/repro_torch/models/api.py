"""Uniform model API over the port's decoder-only LMs.

Port of ``repro.models.api`` for decoder-only models:
    api = model_api(cfg)
    api.param_specs() / api.init(generator, device=...)  -> LM
    api.loss(params, batch, **kw)               -> (scalar, metrics)
    api.forward(params, batch)                  -> logits [B, n + S, V]
    api.prefill(params, batch, caches)          -> (logits [B, V], caches)
    api.decode(params, tokens, caches, pos)     -> (logits [B, V], caches)
    api.init_cache(batch, max_len, device=...)  -> a KVCache / MLACache /
                                                   MambaCache / RWKVCache a layer
``batch`` holds ``tokens`` [B, S] and, for a vision model, may hold
``extra_embeds`` [B, n, d] (the frontend's n patch embeddings, put in
front of the tokens).  ``init`` and ``init_cache`` run on the card unless
``device="cpu"`` is passed.  ``init`` returns frozen parameters (serving);
``.requires_grad_(True)`` on the result trains them.  The encoder-decoder
family is not ported (ROADMAP.md section 2 item 4).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import lm as lm_mod


@dataclass(frozen=True)
class ModelAPI:
    cfg: cm.ArchConfig
    param_specs: Callable[[], Any]
    init: Callable[..., lm_mod.LM]
    loss: Callable[..., Any]
    forward: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    init_cache: Callable[..., Any]


def model_api(cfg: cm.ArchConfig) -> ModelAPI:
    if cfg.encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  f"{cm.NOT_PORTED}")

    def _init(generator: torch.Generator | None = None, *,
              device="cuda") -> lm_mod.LM:
        """Seeded parameters (``generator``, default seed 0 on the CPU) as
        an ``LM`` on ``device``."""
        dev = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        return lm_mod.LM(cfg, lm_mod.init_lm_params(cfg, gen), device=dev)

    def _forward(params, batch):
        return lm_mod.forward_logits(params, batch["tokens"], cfg,
                                     extra_embeds=batch.get("extra_embeds"))

    return ModelAPI(
        cfg=cfg,
        param_specs=lambda: lm_mod.lm_param_specs(cfg),
        init=_init,
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
