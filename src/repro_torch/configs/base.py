"""Config registry and the smoke shrink.

Port of the registry half of ``repro.configs.base``.  Only the configs
whose families the port runs are registered; asking for another raises.
"""
from __future__ import annotations

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
    port has."""
    return cfg.replace(
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
    )
