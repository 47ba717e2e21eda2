"""Config registry and the smoke shrink.

Port of the registry half of ``repro.configs.base``.  Only the configs
whose families the port runs are registered; asking for another raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import common as cm

_REGISTRY: dict[str, Callable[[], cm.ArchConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> cm.ArchConfig:
    import repro_torch.configs  # noqa: F401  (registers the configs)
    if name.endswith("-smoke"):
        return smoke_config(get_config(name[:-len("-smoke")]))
    if name not in _REGISTRY:
        raise NotImplementedError(f"config {name!r}: {cm.NOT_PORTED} (the "
                                  f"port has {list_configs()})")
    return _REGISTRY[name]()


def list_configs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


def smoke_config(cfg: cm.ArchConfig) -> cm.ArchConfig:
    """Same family, tiny dims: the reference's shrink for the fields the
    port has (no remat; MoE: 4 experts, top_k <= 2, d_ff_expert 64; MLA:
    ranks 64 / 32, heads 32 + 16 / 32, so d_head 48)."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=cfg.n_dense_prefix + cfg.period,
        d_model=128,
        n_heads=4,
        n_kv_heads=(min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
                    else 4),
        d_head=32,
        d_ff=256,
        d_ff_dense_prefix=256 if cfg.n_dense_prefix else 0,
        vocab_size=512,
        sliding_window=32,
        remat=False,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=4,
                                        top_k=min(cfg.moe.top_k, 2),
                                        d_ff_expert=64)
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(
            cfg.mla, q_lora_rank=(64 if cfg.mla.q_lora_rank else 0),
            kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
            v_head_dim=32)
        kw["d_head"] = 48                # nope + rope
    return cfg.replace(**kw)
