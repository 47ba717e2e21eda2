"""Decoder block: pre-norm mixer + pre-norm MLP or MoE.

Port of ``repro.models.blocks`` for the attention and MLA mixers and the
dense and MoE MLPs.  Mamba and RWKV blocks are not ported: they raise
``NotImplementedError``.  ``BlockOut`` carries the MoE load-balance loss
(an f32 zero for a dense MLP).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mla as mla_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod

ATTN_KINDS = (cm.MIXER_FULL, cm.MIXER_SWA, cm.MIXER_GLOBAL)


def _check_kinds(mixer_kind: str, mlp_kind: str) -> None:
    if mixer_kind not in ATTN_KINDS + (cm.MIXER_MLA,):
        raise NotImplementedError(f"mixer {mixer_kind!r}: {cm.NOT_PORTED}")
    if mlp_kind not in (cm.MLP_DENSE, cm.MLP_MOE):
        raise NotImplementedError(f"mlp {mlp_kind!r}: {cm.NOT_PORTED}")


def block_param_specs(cfg: cm.ArchConfig, mixer_kind: str, mlp_kind: str,
                      d_ff: int | None = None) -> dict:
    _check_kinds(mixer_kind, mlp_kind)
    return {"ln1_scale": cm.spec((cfg.d_model,), cfg.dtype),
            "mixer": (mla_mod.mla_param_specs(cfg)
                      if mixer_kind == cm.MIXER_MLA
                      else attn.attn_param_specs(cfg)),
            "ln2_scale": cm.spec((cfg.d_model,), cfg.dtype),
            "mlp": (moe_mod.moe_param_specs(cfg) if mlp_kind == cm.MLP_MOE
                    else mlp_mod.mlp_param_specs(cfg, d_ff))}


def init_block_cache(cfg: cm.ArchConfig, mixer_kind: str, batch: int,
                     max_len: int, *, device):
    """A ``KVCache`` for an attention mixer, an ``MLACache`` for MLA."""
    _check_kinds(mixer_kind, cm.MLP_DENSE)
    if mixer_kind == cm.MIXER_MLA:
        return mla_mod.init_mla_cache(cfg, batch, max_len, device=device)
    return attn.init_kv_cache(cfg, batch, max_len, device=device,
                              window=mixer_kind == cm.MIXER_SWA)


class BlockOut(NamedTuple):
    x: torch.Tensor
    cache: attn.KVCache | mla_mod.MLACache | None   # updated, or None
    aux_loss: torch.Tensor                          # MoE load balance, f32


def block_apply(params, x: torch.Tensor, cfg: cm.ArchConfig, *,
                mixer_kind: str, mlp_kind: str, positions: torch.Tensor,
                cache=None, n_groups: int = 1) -> BlockOut:
    _check_kinds(mixer_kind, mlp_kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = cm.rms_norm(x, params["ln1_scale"], cfg.norm_eps)
    if mixer_kind == cm.MIXER_MLA:
        y, new_cache = mla_mod.mla_mixer(params["mixer"], h, cfg,
                                         positions=positions, cache=cache)
    else:
        y, new_cache = attn.attention_mixer(params["mixer"], h, cfg,
                                            kind=mixer_kind,
                                            positions=positions, cache=cache)
    x = x + y
    h = cm.rms_norm(x, params["ln2_scale"], cfg.norm_eps)
    if mlp_kind == cm.MLP_MOE:
        y, stats = moe_mod.moe_apply(params["mlp"], h, cfg,
                                     n_groups=max(n_groups, cfg.moe_groups))
        aux = stats.aux_loss
    else:
        y = mlp_mod.mlp_apply(params["mlp"], h, cfg)
    return BlockOut(x=x + y, cache=new_cache, aux_loss=aux)
