"""Dense gated-linear-unit MLP (SwiGLU / GeGLU); port of
``repro.models.mlp``."""
from __future__ import annotations

import torch

from repro_torch.models import common as cm


def mlp_param_specs(cfg: cm.ArchConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "wg": cm.spec((d, f), cfg.dtype),
        "wu": cm.spec((d, f), cfg.dtype),
        "wd": cm.spec((f, d), cfg.dtype),
    }


def mlp_apply(params, x: torch.Tensor, cfg: cm.ArchConfig) -> torch.Tensor:
    act = cm.act_fn(cfg.act)
    h = act(x @ params["wg"]) * (x @ params["wu"])
    return h @ params["wd"]
