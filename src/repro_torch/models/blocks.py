"""Decoder block: pre-norm attention mixer + pre-norm dense MLP.

Port of ``repro.models.blocks`` for the (attention, dense MLP) blocks.  MLA,
Mamba, RWKV and MoE blocks are not ported: they raise
``NotImplementedError``.  A dense block has no auxiliary loss, so
``BlockOut`` carries none.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod

ATTN_KINDS = (cm.MIXER_FULL, cm.MIXER_SWA, cm.MIXER_GLOBAL)


def _check_kinds(mixer_kind: str, mlp_kind: str) -> None:
    if mixer_kind not in ATTN_KINDS:
        raise NotImplementedError(f"mixer {mixer_kind!r}: {cm.NOT_PORTED}")
    if mlp_kind != cm.MLP_DENSE:
        raise NotImplementedError(f"mlp {mlp_kind!r}: {cm.NOT_PORTED}")


def block_param_specs(cfg: cm.ArchConfig, mixer_kind: str, mlp_kind: str,
                      d_ff: int | None = None) -> dict:
    _check_kinds(mixer_kind, mlp_kind)
    return {"ln1_scale": cm.spec((cfg.d_model,), cfg.dtype),
            "mixer": attn.attn_param_specs(cfg),
            "ln2_scale": cm.spec((cfg.d_model,), cfg.dtype),
            "mlp": mlp_mod.mlp_param_specs(cfg, d_ff)}


def init_block_cache(cfg: cm.ArchConfig, mixer_kind: str, batch: int,
                     max_len: int, *, device) -> attn.KVCache:
    _check_kinds(mixer_kind, cm.MLP_DENSE)
    return attn.init_kv_cache(cfg, batch, max_len, device=device,
                              window=mixer_kind == cm.MIXER_SWA)


class BlockOut(NamedTuple):
    x: torch.Tensor
    cache: attn.KVCache | None     # updated cache, or None without one


def block_apply(params, x: torch.Tensor, cfg: cm.ArchConfig, *,
                mixer_kind: str, mlp_kind: str, positions: torch.Tensor,
                cache: attn.KVCache | None = None) -> BlockOut:
    _check_kinds(mixer_kind, mlp_kind)
    h = cm.rms_norm(x, params["ln1_scale"], cfg.norm_eps)
    y, new_cache = attn.attention_mixer(params["mixer"], h, cfg,
                                        kind=mixer_kind, positions=positions,
                                        cache=cache)
    x = x + y
    h = cm.rms_norm(x, params["ln2_scale"], cfg.norm_eps)
    x = x + mlp_mod.mlp_apply(params["mlp"], h, cfg)
    return BlockOut(x=x, cache=new_cache)
