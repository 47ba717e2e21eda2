"""Decoder block: pre-norm mixer + pre-norm MLP or MoE.

Port of ``repro.models.blocks``: the attention, MLA, Mamba and RWKV-6
mixers and the dense and MoE MLPs.  A block's cache type follows its mixer
kind; an RWKV block's channel mix takes the MLP's place and the block owns
one fused ``RWKVCache`` (token-shift inputs of both halves and the wkv
state), which it writes in place, as every mixer writes its own cache.
``BlockOut`` carries the MoE load-balance loss (an f32 zero for a dense
MLP).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod

ATTN_KINDS = (cm.MIXER_FULL, cm.MIXER_SWA, cm.MIXER_GLOBAL)
MIXER_KINDS = ATTN_KINDS + (cm.MIXER_MLA, cm.MIXER_MAMBA, cm.MIXER_RWKV6)


def _check_kinds(mixer_kind: str, mlp_kind: str) -> None:
    if mixer_kind not in MIXER_KINDS:
        raise ValueError(f"mixer {mixer_kind!r}")
    if mlp_kind not in (cm.MLP_DENSE, cm.MLP_MOE):
        raise ValueError(f"mlp {mlp_kind!r}")


def block_param_specs(cfg: cm.ArchConfig, mixer_kind: str, mlp_kind: str,
                      d_ff: int | None = None) -> dict:
    _check_kinds(mixer_kind, mlp_kind)
    mixer = {cm.MIXER_MLA: mla_mod.mla_param_specs,
             cm.MIXER_MAMBA: mamba_mod.mamba_param_specs,
             cm.MIXER_RWKV6: rwkv_mod.rwkv_tm_param_specs}.get(
                 mixer_kind, attn.attn_param_specs)
    if mixer_kind == cm.MIXER_RWKV6:
        mlp = rwkv_mod.rwkv_cm_param_specs(cfg)
    elif mlp_kind == cm.MLP_MOE:
        mlp = moe_mod.moe_param_specs(cfg)
    else:
        mlp = mlp_mod.mlp_param_specs(cfg, d_ff)
    return {"ln1_scale": cm.spec((cfg.d_model,), cfg.dtype),
            "mixer": mixer(cfg),
            "ln2_scale": cm.spec((cfg.d_model,), cfg.dtype),
            "mlp": mlp}


def block_cache_specs(cfg: cm.ArchConfig, mixer_kind: str, batch: int,
                      max_len: int):
    """``init_block_cache``'s shapes and dtypes as ``cm.Spec``."""
    _check_kinds(mixer_kind, cm.MLP_DENSE)
    if mixer_kind == cm.MIXER_MLA:
        return mla_mod.mla_cache_specs(cfg, batch, max_len)
    if mixer_kind == cm.MIXER_MAMBA:
        return mamba_mod.mamba_cache_specs(cfg, batch)
    if mixer_kind == cm.MIXER_RWKV6:
        return rwkv_mod.rwkv_cache_specs(cfg, batch)
    return attn.kv_cache_specs(cfg, batch, max_len,
                               window=mixer_kind == cm.MIXER_SWA)


def init_block_cache(cfg: cm.ArchConfig, mixer_kind: str, batch: int,
                     max_len: int, *, device):
    """Zeros: a ``KVCache`` for an attention mixer, an ``MLACache`` for
    MLA, a ``MambaCache`` or an ``RWKVCache`` (neither grows with
    ``max_len``) for the recurrent mixers."""
    _check_kinds(mixer_kind, cm.MLP_DENSE)
    if mixer_kind == cm.MIXER_MLA:
        return mla_mod.init_mla_cache(cfg, batch, max_len, device=device)
    if mixer_kind == cm.MIXER_MAMBA:
        return mamba_mod.init_mamba_cache(cfg, batch, device=device)
    if mixer_kind == cm.MIXER_RWKV6:
        return rwkv_mod.init_rwkv_cache(cfg, batch, device=device)
    return attn.init_kv_cache(cfg, batch, max_len, device=device,
                              window=mixer_kind == cm.MIXER_SWA)


class BlockOut(NamedTuple):
    x: torch.Tensor
    cache: (attn.KVCache | mla_mod.MLACache | mamba_mod.MambaCache
            | rwkv_mod.RWKVCache | None)            # updated, or None
    aux_loss: torch.Tensor                          # MoE load balance, f32


def block_apply(params, x: torch.Tensor, cfg: cm.ArchConfig, *,
                mixer_kind: str, mlp_kind: str, positions: torch.Tensor,
                cache=None, n_groups: int = 1) -> BlockOut:
    _check_kinds(mixer_kind, mlp_kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = cm.rms_norm(x, params["ln1_scale"], cfg.norm_eps)
    new_cache = cache
    if mixer_kind == cm.MIXER_MLA:
        y, new_cache = mla_mod.mla_mixer(params["mixer"], h, cfg,
                                         positions=positions, cache=cache)
    elif mixer_kind == cm.MIXER_MAMBA:
        y, new_cache = mamba_mod.mamba_mixer(params["mixer"], h, cfg,
                                             cache=cache)
    elif mixer_kind == cm.MIXER_RWKV6:
        y, (state, tm_prev) = rwkv_mod.rwkv_time_mix(params["mixer"], h,
                                                     cfg, cache=cache)
    else:
        y, new_cache = attn.attention_mixer(params["mixer"], h, cfg,
                                            kind=mixer_kind,
                                            positions=positions, cache=cache)
    x = x + y
    h = cm.rms_norm(x, params["ln2_scale"], cfg.norm_eps)
    if mixer_kind == cm.MIXER_RWKV6:
        y, cm_prev = rwkv_mod.rwkv_channel_mix(params["mlp"], h, cfg,
                                               cache=cache)
        if cache is not None:
            for buf, new in zip(cache, (tm_prev, cm_prev, state)):
                buf.copy_(new)
    elif mlp_kind == cm.MLP_MOE:
        y, stats = moe_mod.moe_apply(params["mlp"], h, cfg,
                                     n_groups=max(n_groups, cfg.moe_groups))
        aux = stats.aux_loss
    else:
        y = mlp_mod.mlp_apply(params["mlp"], h, cfg)
    return BlockOut(x=x + y, cache=new_cache, aux_loss=aux)
