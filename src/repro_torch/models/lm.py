"""Decoder-only language model: embedding -> blocks -> final norm -> head.

Port of ``repro.models.lm`` for the dense, the DeepSeek (MLA + MoE) and
the recurrent (jamba's Mamba + attention + MoE, RWKV-6) decoders and the
vision frontend: ``_embed``, ``_run_blocks``, ``forward_logits``,
``prefill``, ``decode_step`` and the sequence-chunked training loss
``lm_loss``.  A vision model's ``extra_embeds`` [B, n_vis, d]
(precomputed patch embeddings) go through ``vis_proj`` and in front of
the text tokens: the causal mask and the positions run over the whole
sequence, so after a prefill of n_vis + S positions decode runs at
``pos = n_vis + S + t`` and a cache counts the frontend tokens.  Mamba
and RWKV layers ignore ``positions``: their caches carry a fixed-size
state, not a position a token.  The reference scans over stacked
periods; the port keeps one parameter tree per layer
(``params["layers"][i]``) and runs them in a plain loop, with no sharding
constraint; under ``cfg.remat`` each body period runs under
``torch.utils.checkpoint`` as the reference's period runs under
``jax.checkpoint``.  ``LM`` holds the parameters as an ``nn.Module`` on one
device, frozen for serving; ``LM.requires_grad_(True)`` trains them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models import common as cm


def lm_param_specs(cfg: cm.ArchConfig) -> dict:
    d = cfg.d_model
    specs = {
        "embed": cm.spec((cfg.vocab_size, d), cfg.dtype),
        "final_scale": cm.spec((d,), cfg.dtype),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = cm.spec((d, cfg.vocab_size), cfg.dtype)
    specs["layers"] = [
        blk.block_param_specs(cfg, mk, lk, (cfg.d_ff_dense_prefix or cfg.d_ff)
                              if i < cfg.n_dense_prefix else None)
        for i, (mk, lk) in enumerate(cfg.layer_kinds())]
    if cfg.frontend == "vision":       # after the layers, as the reference
        specs["vis_proj"] = cm.spec((d, d), cfg.dtype)
    return specs


def lm_param_specs_stacked(cfg: cm.ArchConfig) -> dict:
    """``lm_param_specs`` in the reference's layout: the dense prefix as a
    list and each period slot's body layers stacked ``[n_periods, ...]``
    under ``body``, the tree the mesh's sharding rules read."""
    specs = lm_param_specs(cfg)
    layers = specs.pop("layers")
    npre = cfg.n_dense_prefix
    if npre:
        specs["prefix"] = layers[:npre]
    specs["body"] = [cm.stack_specs(layers[npre + s], cfg.n_periods)
                     for s in range(cfg.period)]
    return specs


def lm_cache_specs(cfg: cm.ArchConfig, batch: int, max_len: int) -> dict:
    """``init_lm_cache``'s shapes and dtypes as ``cm.Spec`` in the
    reference's layout: the dense prefix's caches as a list, each period
    slot's body caches stacked ``[n_periods, ...]`` under ``body``."""
    caches = {}
    if cfg.n_dense_prefix:
        caches["prefix"] = [blk.block_cache_specs(cfg, cfg.mixers[0], batch,
                                                  max_len)
                            for _ in range(cfg.n_dense_prefix)]
    caches["body"] = [
        cm.stack_specs(blk.block_cache_specs(cfg, cfg.block_kinds(s)[0],
                                             batch, max_len), cfg.n_periods)
        for s in range(cfg.period)]
    return caches


def init_lm_params(cfg: cm.ArchConfig, gen: torch.Generator) -> dict:
    """Seeded parameters by the reference's naming rules.  The reference
    draws each body leaf stacked ``[n_periods, ...]``, so a 1-D body leaf
    drawn from the truncated normal (Mamba's ``D``) has fan-in n_periods
    there: so it has here."""
    def fan_in(path, shape):
        layer = path.split("/")[1] if path.startswith("layers/") else None
        if len(shape) == 1 and layer and int(layer) >= cfg.n_dense_prefix:
            return cfg.n_periods
        return None

    return cm.init_from_specs(gen, lm_param_specs(cfg), fan_in)


class LM(cm.ParamTree):
    """The model's parameters on ``device``; ``lm["embed"]``,
    ``lm["layers"][i]["mixer"]["wq"]`` ... read them, so an ``LM`` is the
    ``params`` argument of every function here."""

    def __init__(self, cfg: cm.ArchConfig, params: dict, *, device="cuda"):
        dev = resolve_device(device)
        super().__init__(cm.map_tree(lambda _, t: t.to(dev), params))
        self.cfg = cfg
        self.device = dev


def init_lm_cache(cfg: cm.ArchConfig, batch: int, max_len: int, *,
                  device="cuda") -> list:
    """One cache per layer, zero-filled on ``device``: a ``KVCache`` for an
    attention layer, an ``MLACache`` for an MLA layer, a ``MambaCache`` or
    an ``RWKVCache`` for a recurrent one."""
    dev = resolve_device(device)
    return [blk.init_block_cache(cfg, mk, batch, max_len, device=dev)
            for mk, _ in cfg.layer_kinds()]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def embed_scale(cfg: cm.ArchConfig) -> float:
    """sqrt(d_model) rounded to the model dtype, as the reference's
    ``jnp.asarray(d_model ** 0.5, x.dtype)`` is (27.75 in bf16 at d = 768)."""
    return float(torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype))


def _embed(params, tokens: torch.Tensor, cfg: cm.ArchConfig,
           extra_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Scaled token embeddings [B, S, d], with ``extra_embeds`` [B, n, d]
    (times ``vis_proj`` where the tree has one) in front of them.  The
    reference multiplies f32 ``extra_embeds`` by the model-dtype
    ``vis_proj`` in f32 (jnp promotes) and casts the product: so does
    this (``resolve_device`` has switched TF32 off).  The embed scale
    applies to the text tokens only; a tree without ``vis_proj`` takes
    ``extra_embeds`` unprojected."""
    x = F.embedding(tokens, params["embed"])
    x = x * embed_scale(cfg)          # gemma-style embed scale
    if extra_embeds is None:
        return x
    if "vis_proj" in params:
        w = params["vis_proj"]
        dt = torch.promote_types(extra_embeds.dtype, w.dtype)
        extra_embeds = extra_embeds.to(dt) @ w.to(dt)
    return torch.cat([extra_embeds.to(x.dtype), x], dim=1)


def _run_blocks(params, x: torch.Tensor, cfg: cm.ArchConfig, *,
                positions: torch.Tensor, caches: list | None = None):
    """Every layer in order. Returns (hidden, the summed MoE aux loss (f32
    0-d), new caches or None).  Under ``cfg.remat``, with grad enabled and
    no cache, each body period's activations are recomputed in the
    backward pass (the dense prefix is not, as in the reference)."""
    kinds = cfg.layer_kinds()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.remat and caches is None and torch.is_grad_enabled():
        def run(x, aux, lo, hi):
            for i in range(lo, hi):
                out = blk.block_apply(params["layers"][i], x, cfg,
                                      mixer_kind=kinds[i][0],
                                      mlp_kind=kinds[i][1],
                                      positions=positions)
                x, aux = out.x, aux + out.aux_loss
            return x, aux

        x, aux = run(x, aux, 0, cfg.n_dense_prefix)
        for lo in range(cfg.n_dense_prefix, len(kinds), cfg.period):
            x, aux = checkpoint(run, x, aux, lo, lo + cfg.period,
                                use_reentrant=False)
        return x, aux, None
    new_caches = None if caches is None else []
    for i, (mk, lk) in enumerate(kinds):
        out = blk.block_apply(params["layers"][i], x, cfg, mixer_kind=mk,
                              mlp_kind=lk, positions=positions,
                              cache=None if caches is None else caches[i])
        x, aux = out.x, aux + out.aux_loss
        if caches is not None:
            new_caches.append(out.cache)
    return x, aux, new_caches


def forward_hidden(params, tokens: torch.Tensor, cfg: cm.ArchConfig, *,
                   extra_embeds: torch.Tensor | None = None):
    """(final-normed hidden [B, n_extra + S, d], the MoE aux loss)."""
    x = _embed(params, tokens, cfg, extra_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, aux, _ = _run_blocks(params, x, cfg, positions=positions)
    return cm.rms_norm(x, params["final_scale"], cfg.norm_eps), aux


def _head(params, x: torch.Tensor, cfg: cm.ArchConfig) -> torch.Tensor:
    """Logits in the model dtype, or f32 under a final softcap."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ w
    if cfg.final_logit_softcap:
        logits = cm.softcap(logits.float(), cfg.final_logit_softcap)
    return logits


def forward_logits(params, tokens: torch.Tensor, cfg: cm.ArchConfig, *,
                   extra_embeds: torch.Tensor | None = None) -> torch.Tensor:
    return _head(params, forward_hidden(params, tokens, cfg,
                                        extra_embeds=extra_embeds)[0], cfg)


# ---------------------------------------------------------------------------
# Loss (sequence-chunked cross-entropy)
# ---------------------------------------------------------------------------

def lm_loss(params, batch: dict, cfg: cm.ArchConfig, *,
            loss_chunk: int = 512, aux_weight: float = 0.01):
    """Next-token cross-entropy of ``batch["tokens"]`` [B, S]: labels are
    the tokens shifted left with -1 at the end (and -1 at the positions of
    ``batch["extra_embeds"]``, which predict nothing); the logits are formed
    ``loss_chunk`` positions at a time (the sequence padded to a multiple
    with label -1), ``lse - gold`` in f32 masked by ``labels >= 0``, and
    the loss is ``tot / max(cnt, 1)``.  Returns ``(loss + aux_weight *
    aux, {"ce", "aux"})``, aux the MoE layers' summed load-balance loss
    (a 0-d f32 zero for a dense model)."""
    tokens = batch["tokens"]
    x, aux = forward_hidden(params, tokens, cfg,
                            extra_embeds=batch.get("extra_embeds"))
    n_extra = x.shape[1] - tokens.shape[1]
    labels = F.pad(tokens[:, 1:].long(), (n_extra, 1), value=-1)
    B, S, _ = x.shape
    loss_chunk = min(loss_chunk, S)
    pad = (-S) % loss_chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S + pad, loss_chunk):
        lb = labels[:, c0:c0 + loss_chunk]
        logits = _head(params, x[:, c0:c0 + loss_chunk], cfg).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lb.clamp(min=0)[..., None])[..., 0]
        mask = (lb >= 0).float()
        tot = tot + ((lse - gold) * mask).sum()
        cnt = cnt + mask.sum()
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------

def prefill(params, tokens: torch.Tensor, cfg: cm.ArchConfig, caches: list,
            *, extra_embeds: torch.Tensor | None = None):
    """Fill caches from a prompt [B, S] (after ``extra_embeds`` [B, n, d],
    which take positions 0 .. n - 1); returns (last-token logits [B, V],
    caches).  The caches are written in place.  A recurrent layer's scan
    starts from its cache's state, so the caches must be fresh (zeros), as
    the reference's ``init_cache`` gives them."""
    x = _embed(params, tokens, cfg, extra_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _, new_caches = _run_blocks(params, x, cfg, positions=positions,
                                   caches=caches)
    x = cm.rms_norm(x[:, -1:], params["final_scale"], cfg.norm_eps)
    return _head(params, x, cfg)[:, 0], new_caches


def decode_step(params, tokens: torch.Tensor, cfg: cm.ArchConfig,
                caches: list, *, pos: int):
    """One decode step. tokens: [B,1]; pos: absolute position.
    Returns (logits [B,V], caches written in place)."""
    x = _embed(params, tokens, cfg)
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    x, _, new_caches = _run_blocks(params, x, cfg, positions=positions,
                                   caches=caches)
    x = cm.rms_norm(x, params["final_scale"], cfg.norm_eps)
    return _head(params, x, cfg)[:, 0], new_caches


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] -> [B, 1] int32: the first index of each row's maximum
    (``jnp.argmax``'s rule, which ``torch.argmax`` does not promise)."""
    mx = logits.amax(dim=-1, keepdim=True)
    ar = torch.arange(logits.shape[-1], device=logits.device)
    first = torch.where(logits == mx, ar, logits.shape[-1]).amin(dim=-1)
    return first.to(torch.int32)[:, None]
