"""Mini-CLIP: a trainable two-tower embedder over the synthetic world.

Port of ``repro.perception.clip``: the paper's MobileCLIP role, rebuilt
small.  An object tower over rendered depth crops (the observation the
mapping server has per detection) and a text tower over caption tokens,
trained with a symmetric InfoNCE loss; ``examples/train_perception.py``
is the reference's trainer.  Parameters are a flat dict of f32 tensors
(the reference's names), drawn by the port's naming rule from a seeded
``torch.Generator`` (numbers differ from JAX's; tests carry the
reference's across with ``convert.clip_params_from_numpy``).  It runs no
hand-written kernel: the towers are small dense products.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.data.scenes import CLASS_NAMES, scene_stream
from repro_torch.data.tokens import VOCAB, VOCAB_SIZE
from repro_torch.device import resolve_device
from repro_torch.models import common as cm

CROP = 16  # depth-crop resolution fed to the object tower


@dataclass(frozen=True)
class ClipConfig:
    embed_dim: int = 64
    width: int = 128
    depth: int = 2
    temperature_init: float = 0.07


def clip_param_specs(ccfg: ClipConfig) -> dict:
    w, e = ccfg.width, ccfg.embed_dim
    f32 = torch.float32
    specs: dict = {
        "obj_in": cm.spec((CROP * CROP + 4, w), f32),
        "txt_embed": cm.spec((VOCAB_SIZE, w), f32),
        "logit_scale": cm.spec((), f32),
    }
    for t in ("obj", "txt"):
        for i in range(ccfg.depth):
            specs[f"{t}_w{i}"] = cm.spec((w, w), f32)
            specs[f"{t}_b{i}_bias"] = cm.spec((w,), f32)
        specs[f"{t}_out"] = cm.spec((w, e), f32)
    return specs


def init_clip_params(ccfg: ClipConfig,
                     generator: torch.Generator | None = None, *,
                     device="cuda") -> dict:
    """Seeded parameters (``generator``, default seed 0 on the CPU) on
    ``device``; ``logit_scale`` starts at log(1 / temperature_init)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    p = cm.init_from_specs(gen, clip_param_specs(ccfg))
    p["logit_scale"] = torch.tensor(math.log(1.0 / ccfg.temperature_init),
                                    dtype=torch.float32)
    return {k: v.to(dev) for k, v in p.items()}


def _mlp(params, prefix: str, x: torch.Tensor, depth: int) -> torch.Tensor:
    gelu = cm.act_fn("gelu")          # the tanh form, jax.nn.gelu's default
    for i in range(depth):
        x = gelu(x @ params[f"{prefix}_w{i}"] + params[f"{prefix}_b{i}_bias"])
    x = x @ params[f"{prefix}_out"]
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-9)


def encode_object(params, crops: torch.Tensor, stats: torch.Tensor,
                  ccfg: ClipConfig) -> torch.Tensor:
    """crops: [B, CROP, CROP] normalized depth; stats: [B, 4] (bbox h/w in
    pixels /100, mean depth, valid fraction)."""
    x = torch.cat([crops.reshape(crops.shape[0], -1), stats], dim=-1)
    return _mlp(params, "obj", x @ params["obj_in"], ccfg.depth)


def encode_text(params, tokens: torch.Tensor,
                ccfg: ClipConfig) -> torch.Tensor:
    """tokens: [B, L] int32 (0-padded) -> mean-pooled tower."""
    emb = params["txt_embed"][tokens.long()]
    mask = (tokens > 0)[..., None]
    x = torch.sum(emb * mask, dim=1) / torch.clamp(mask.sum(dim=1), min=1)
    return _mlp(params, "txt", x, ccfg.depth)


def clip_loss(params, batch: dict, ccfg: ClipConfig):
    oe = encode_object(params, batch["crops"], batch["stats"], ccfg)
    te = encode_text(params, batch["tokens"], ccfg)
    scale = torch.exp(params["logit_scale"])
    logits = scale * oe @ te.T
    labels = torch.arange(logits.shape[0], device=logits.device)
    li = -torch.mean(torch.log_softmax(logits, dim=1)[labels, labels])
    lt = -torch.mean(torch.log_softmax(logits, dim=0)[labels, labels])
    return 0.5 * (li + lt), {"scale": scale}


# ---------------------------------------------------------------------------
# data: (depth crop, class caption) pairs from rendered frames
# ---------------------------------------------------------------------------

def class_tokens(cid: int, max_len: int = 4) -> np.ndarray:
    words = f"find the {CLASS_NAMES[cid]}".split()
    ids = [VOCAB.get(w, 0) for w in words][:max_len]
    return np.asarray(ids + [0] * (max_len - len(ids)), np.int32)


def crop_from_frame(depth: np.ndarray, mask: np.ndarray):
    ys, xs = np.nonzero(mask)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    d = np.where(mask, depth, 0.0)[y0:y1, x0:x1]
    # nearest-resize to CROP x CROP
    iy = np.linspace(0, d.shape[0] - 1, CROP).astype(int)
    ix = np.linspace(0, d.shape[1] - 1, CROP).astype(int)
    crop = d[np.ix_(iy, ix)]
    mu = crop[crop > 0].mean() if (crop > 0).any() else 1.0
    stats = np.asarray([(y1 - y0) / 100.0, (x1 - x0) / 100.0, mu / 5.0,
                        float((crop > 0).mean())], np.float32)
    return (crop / max(mu, 1e-3)).astype(np.float32), stats


def pair_batches(scene, classes, *, batch: int, seed: int = 0, h=120, w=160,
                 n_frames: int = 60, device="cuda"):
    """Yield contrastive batches with one object per distinct class: the
    reference's draws (numpy, the same seed), moved to ``device``;
    ``class_ids`` stays numpy."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    samples: dict[int, list] = {}
    for fr in scene_stream(scene, n_frames=n_frames, keyframe_interval=3,
                           h=h, w=w):
        for oid in fr.visible_ids:
            cid = classes[int(oid)]
            crop, stats = crop_from_frame(fr.depth, fr.inst == oid)
            samples.setdefault(cid, []).append((crop, stats))
    cids = [c for c, v in samples.items() if len(v) >= 2]
    while True:
        picks = rng.choice(cids, size=min(batch, len(cids)), replace=False)
        crops, stats, toks = [], [], []
        for c in picks:
            i = rng.integers(len(samples[c]))
            crops.append(samples[c][i][0])
            stats.append(samples[c][i][1])
            toks.append(class_tokens(int(c)))
        yield {"crops": torch.from_numpy(np.stack(crops)).to(dev),
               "stats": torch.from_numpy(np.stack(stats)).to(dev),
               "tokens": torch.from_numpy(np.stack(toks)).to(dev),
               "class_ids": np.asarray(picks)}
