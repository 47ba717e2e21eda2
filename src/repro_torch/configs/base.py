"""Config registry, the assigned shape cells, input specs, and the smoke
shrink.

Port of ``repro.configs.base``: every config of the reference's registry
is registered; asking for another name raises ``KeyError``, as the
reference's lookup does.  ``input_specs`` gives a
cell's model inputs as ``cm.Spec`` (shape, torch dtype), the port's
stand-in for ``jax.ShapeDtypeStruct``; ``make_inputs`` draws them from an
explicit ``torch.Generator`` (its bits differ from ``jax.random``'s: the
shapes, dtypes and the tokens' range ``[0, vocab)`` are what match).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.device import resolve_device
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
        raise KeyError(f"unknown config {name!r} (the registry has "
                       f"{list_configs()})")
    return _REGISTRY[name]()


def list_configs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Assigned shape cells
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# archs whose attention is quadratic-full everywhere -> skip long_500k
FULL_ATTENTION_ONLY = {
    "minitron-4b", "yi-9b", "deepseek-v3-671b", "deepseek-v2-236b",
    "phi-3-vision-4.2b", "whisper-small",
}


def cell_is_runnable(arch: str, shape: str) -> bool:
    return not (shape == "long_500k" and arch in FULL_ATTENTION_ONLY)


def input_specs(cfg: cm.ArchConfig, cell: ShapeCell) -> dict:
    """Model inputs for one shape cell, as ``cm.Spec``.  A vision model
    takes ``n_vis = min(n_frontend_tokens, S // 2)`` patch embeddings
    (f32) in front of ``S - n_vis`` text tokens; the encoder-decoder takes
    frames and 448 decoder tokens; a decode cell one token a row."""
    B, S = cell.global_batch, cell.seq_len
    i32, f32 = torch.int32, torch.float32
    if cell.kind == "decode":
        return {"tokens": cm.spec((B, 1), i32)}
    if cfg.encdec:
        frames = {"frames": cm.spec((B, S, cfg.d_model), f32)}
        return ({**frames, "tokens": cm.spec((B, 448), i32)}
                if cell.kind == "train" else frames)
    if cfg.frontend == "vision":
        n_vis = min(cfg.n_frontend_tokens, S // 2)
        return {"tokens": cm.spec((B, S - n_vis), i32),
                "extra_embeds": cm.spec((B, n_vis, cfg.d_model), f32)}
    return {"tokens": cm.spec((B, S), i32)}


def make_inputs(cfg: cm.ArchConfig, cell: ShapeCell,
                generator: torch.Generator, *, device="cuda") -> dict:
    """Random inputs matching ``input_specs``, drawn from ``generator``
    (which must lie on ``device``) in the specs' key order: tokens
    uniform in ``[0, vocab)``, floats standard normal."""
    dev = resolve_device(device)
    out = {}
    for k, sp in input_specs(cfg, cell).items():
        if sp.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, sp.shape,
                                   generator=generator, device=dev,
                                   dtype=torch.int32)
        else:
            out[k] = torch.randn(sp.shape, generator=generator, device=dev,
                                 dtype=sp.dtype)
    return out


# ---------------------------------------------------------------------------
# Smoke shrink: same family, tiny dims, runs a step on CPU
# ---------------------------------------------------------------------------

def smoke_config(cfg: cm.ArchConfig) -> cm.ArchConfig:
    """Same family, tiny dims: the reference's shrink for the fields the
    port has (no remat; MoE: 4 experts, top_k <= 2, d_ff_expert 64; MLA:
    ranks 64 / 32, heads 32 + 16 / 32, so d_head 48; Mamba: d_state 8,
    chunk 16; RWKV: heads of 32, LoRAs of 8, chunk 16, 4 heads;
    encoder-decoder: 2 + 2 layers, ``enc_seq`` 32; vision: 8 frontend
    tokens)."""
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
    if cfg.mamba is not None:
        kw["mamba"] = dataclasses.replace(cfg.mamba, d_state=8, chunk=16)
    if cfg.rwkv is not None:
        kw["rwkv"] = dataclasses.replace(cfg.rwkv, head_dim=32, decay_lora=8,
                                         mix_lora=8, chunk=16)
        kw["n_heads"] = 4
        kw["d_head"] = 32
    if cfg.encdec:
        kw["n_layers"] = 2
        kw["n_enc_layers"] = 2
        kw["enc_seq"] = 32
    if cfg.frontend == "vision":
        kw["n_frontend_tokens"] = 8
    return cfg.replace(**kw)


SMOKE_CELL = ShapeCell("smoke", 64, 2, "train")
