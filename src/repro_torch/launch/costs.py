"""Analytic FLOP / memory-traffic model for every (arch x shape) cell.

Port of ``repro.launch.costs``: ``CellCosts``, ``param_counts``, the
per-family forward FLOP terms, ``step_costs``, ``_cache_bytes`` and
``roofline_terms``, with the same float expressions in the same order, so
every figure equals the reference's exactly.  The model mirrors the
reference's implementation, not an idealized formula: the attention term
costs the reference's blocked jnp sweep over every tile, or under
``cfg.prune_tiles`` (the dry run's ``--prune-tiles``) only the tiles of
the causal or window band (``_visited_tiles_frac``, at the reference's
default q-chunk ``ATTN_CHUNK``), the MoE pays its capacity-factor
padding, naive MLA decode re-expands K / V each step.  The port's own
hand-written kernels are bounded elsewhere (``chip_smoke.py``'s
``attn_cost`` / ``bwd_cost``).

Memory-traffic model: parameters are streamed once a step; the optimizer
reads and writes the f32 master and both moments; activations count the
residual stream and each block's input and output in bf16; KV-cache reads
dominate decode.  ``roofline_terms`` defaults to one H100 SXM's data sheet
(``H100_SXM``); the reference's hardware dicts use the same keys and can be
passed as ``hw``.  The encoder-decoder's cells (whisper-small) take the
reference's own branch, ``_encdec_costs``: a train cell encodes its
``seq_len`` frames and decodes 448 tokens, a prefill cell runs the encoder
alone, a decode cell one decoder step against ``enc_seq`` cross keys.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.configs.base import ShapeCell
from repro_torch.models import common as cm
from repro_torch.models.api import model_api
from repro_torch.models.moe import expert_capacity

# dense bf16 tensor-core FLOP/s, HBM3 bytes/s and NVLink bytes/s a direction
H100_SXM = dict(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9)
# token groups the MoE's capacity is reckoned over
MOE_GROUPS = 32
# the reference's jnp attention's q-chunk (``ArchConfig.attn_chunk``'s
# default, which every registered config keeps)
ATTN_CHUNK = 1024


def _mm(m, n, k):
    return 2.0 * m * n * k


@dataclass
class CellCosts:
    flops: float            # total executed FLOPs (all devices)
    hbm_bytes: float        # total HBM traffic (all devices)
    model_flops: float      # 6*N*D train / 2*N_active*D inference
    n_params: int
    n_active: int
    breakdown: dict

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.flops, 1.0)


def param_counts(cfg: cm.ArchConfig) -> tuple[int, int]:
    """(total params, active-per-token params)."""
    api = model_api(cfg)
    n = cm.count_params(api.param_specs())
    n_active = n
    if cfg.moe is not None:
        mo = cfg.moe
        n_moe_layers = sum(1 for i in range(cfg.n_body_layers)
                           if cfg.block_kinds(i % cfg.period)[1] == cm.MLP_MOE)
        expert_p = 3 * cfg.d_model * mo.d_ff_expert
        inactive = n_moe_layers * (mo.n_experts - mo.top_k) * expert_p
        n_active = n - inactive
    return n, n_active


# ---------------------------------------------------------------------------
# per-layer forward FLOPs (mirrors the reference's models/*.py)
# ---------------------------------------------------------------------------

def _visited_tiles_frac(cfg, S, T, window) -> float:
    """Fraction of the S*T tile grid the blocked attention touches."""
    if not cfg.prune_tiles or S == 1:
        return 1.0
    Cq = min(ATTN_CHUNK, S)
    Ck = min(1024, T)
    nq, nk = -(-S // Cq), -(-T // Ck)
    total = visited = 0
    for i in range(nq):
        hi = min((((i + 1) * Cq) + Ck - 1) // Ck, nk)
        lo = 0 if not window else max((i * Cq - window + 1) // Ck, 0)
        visited += hi - lo
        total += nk
    return visited / max(total, 1)


def _attn_flops(cfg, B, S, T, *, window=0):
    H, K, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    proj = _mm(B * S, H * dh, d) + 2 * _mm(B * S, K * dh, d) \
        + _mm(B * S, d, H * dh)
    # blocked attention: the full S*T tile sweep, or under prune_tiles only
    # the causal / window band
    core = 2 * (2.0 * B * H * S * T * dh) * _visited_tiles_frac(cfg, S, T,
                                                                window)
    return proj + core


def _mla_flops(cfg, B, S, T, *, decode=False):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk, qr, dv, rkv, rq = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                           m.v_head_dim, m.kv_lora_rank, m.q_lora_rank)
    f = 0.0
    if rq:
        f += _mm(B * S, rq, d) + _mm(B * S, H * (qk + qr), rq)
    else:
        f += _mm(B * S, H * (qk + qr), d)
    f += _mm(B * S, rkv + qr, d)                      # kv down
    f += _mm(B * S, d, H * dv)                        # out proj
    if not decode:
        f += _mm(B * S, H * qk, rkv) + _mm(B * S, H * dv, rkv)  # expand K/V
        # attention core counted via _mla_prefill_core
    else:
        if m.absorb:
            f += _mm(B * H, rkv, qk)                  # fold W_UK into q
            f += 2.0 * B * H * T * (rkv + qr) * 2     # scores vs latent+rope
            f += 2.0 * B * H * T * rkv                # o_lat
            f += _mm(B * H, dv, rkv)                  # unfold W_UV
        else:
            f += _mm(B * T, H * qk, rkv) + _mm(B * T, H * dv, rkv)  # re-expand
            f += 2.0 * B * H * T * (qk + qr) * 2      # scores (nope+rope)
            f += 2.0 * B * H * T * dv                 # pv
    return f


def _mla_prefill_core(cfg, B, S):
    m = cfg.mla
    H = cfg.n_heads
    return 2.0 * B * H * S * S * (m.qk_nope_head_dim + m.qk_rope_head_dim) \
        + 2.0 * B * H * S * S * m.v_head_dim


def _mamba_flops(cfg, B, S):
    d = cfg.d_model
    di = cfg.mamba.expand * d
    N = cfg.mamba.d_state
    dtr = cfg.mamba.dt_rank or math.ceil(d / 16)
    f = _mm(B * S, 2 * di, d)                         # in_proj
    f += 2.0 * B * S * di * cfg.mamba.d_conv          # causal conv
    f += _mm(B * S, dtr + 2 * N, di)                  # x_proj
    f += _mm(B * S, di, dtr)                          # dt_proj
    f += 10.0 * B * S * di * N                        # scan elementwise (assoc)
    f += 2.0 * B * S * di * N                         # y = C.h
    f += _mm(B * S, d, di)                            # out_proj
    return f


def _rwkv_tm_flops(cfg, B, S):
    d = cfg.d_model
    rw = cfg.rwkv
    h, dh = d // rw.head_dim, rw.head_dim
    C = min(rw.chunk, S)
    nch = math.ceil(S / C)
    f = _mm(B * S, 5 * rw.mix_lora, d) + 2.0 * B * S * 5 * rw.mix_lora * d
    f += 5 * _mm(B * S, d, d)                         # r,k,v,g,o projections
    f += _mm(B * S, rw.decay_lora, d) + _mm(B * S, d, rw.decay_lora)
    intra = B * nch * (5.0 * C * C * h * dh)          # masked pairwise + pv
    inter = B * nch * (4.0 * C * h * dh * dh)         # state read + update
    return f + intra + inter


def _rwkv_cm_flops(cfg, B, S):
    d, ff = cfg.d_model, cfg.d_ff
    return _mm(B * S, ff, d) + _mm(B * S, d, ff) + _mm(B * S, d, d)


def _mlp_flops(cfg, B, S, d_ff):
    return 3 * _mm(B * S, d_ff, cfg.d_model)


def _moe_flops(cfg, B, S):
    mo = cfg.moe
    T = B * S
    g = MOE_GROUPS
    while T % g:
        g -= 1
    Tg = T // g
    Cap = expert_capacity(Tg, cfg)
    f = _mm(T, mo.n_experts, cfg.d_model)             # router
    f += 3 * _mm(g * mo.n_experts * Cap, mo.d_ff_expert, cfg.d_model)
    if mo.n_shared:
        f += 3 * _mm(T, mo.n_shared * mo.d_ff_expert, cfg.d_model)
    return f


def _layer_fwd_flops(cfg, mixer, mlp, B, S, T, *, decode):
    if mixer in (cm.MIXER_FULL, cm.MIXER_SWA, cm.MIXER_GLOBAL):
        if mixer == cm.MIXER_SWA and decode:
            f = _attn_flops(cfg, B, S, min(T, cfg.sliding_window))
        else:
            win = cfg.sliding_window if mixer == cm.MIXER_SWA else 0
            f = _attn_flops(cfg, B, S, T, window=win)
    elif mixer == cm.MIXER_MLA:
        f = _mla_flops(cfg, B, S, T, decode=decode)
        if not decode:
            f += _mla_prefill_core(cfg, B, S)
    elif mixer == cm.MIXER_MAMBA:
        f = _mamba_flops(cfg, B, S)
    elif mixer == cm.MIXER_RWKV6:
        f = _rwkv_tm_flops(cfg, B, S) if not decode else \
            _rwkv_tm_flops(cfg, B, 1)
    else:
        raise ValueError(mixer)

    if mixer == cm.MIXER_RWKV6:
        f += _rwkv_cm_flops(cfg, B, S)
    elif mlp == cm.MLP_MOE:
        f += _moe_flops(cfg, B, S)
    else:
        f += _mlp_flops(cfg, B, S, cfg.d_ff)
    return f


# ---------------------------------------------------------------------------
# cell-level costs
# ---------------------------------------------------------------------------

def step_costs(cfg: cm.ArchConfig, cell: ShapeCell) -> CellCosts:
    B, S = cell.global_batch, cell.seq_len
    n, n_active = param_counts(cfg)
    d = cfg.d_model
    bk = {}

    if cfg.encdec:
        return _encdec_costs(cfg, cell, n, n_active)

    decode = cell.kind == "decode"
    Bs, Ss = (B, 1) if decode else (B, S)
    T = S
    fwd = 0.0
    layers = ([(cfg.mixers[0], cm.MLP_DENSE)] * cfg.n_dense_prefix +
              [cfg.block_kinds(i % cfg.period)
               for i in range(cfg.n_body_layers)])
    for i, (mixer, mlp) in enumerate(layers):
        d_ff = cfg.d_ff_dense_prefix if (i < cfg.n_dense_prefix and
                                         cfg.d_ff_dense_prefix) else cfg.d_ff
        if i < cfg.n_dense_prefix:
            fwd += _layer_fwd_flops(cfg, mixer, cm.MLP_DENSE, Bs, Ss, T,
                                    decode=decode) \
                - _mlp_flops(cfg, Bs, Ss, cfg.d_ff) + _mlp_flops(cfg, Bs, Ss, d_ff)
        else:
            fwd += _layer_fwd_flops(cfg, mixer, mlp, Bs, Ss, T,
                                    decode=decode)
    bk["layers_fwd"] = fwd
    # train computes the full-sequence chunked loss; prefill/decode only the
    # final-position logits
    head = _mm(Bs * Ss if cell.kind == "train" else B, cfg.vocab_size, d)
    bk["head_fwd"] = head

    p_bytes = 2.0 * n                                  # bf16 streamed once
    if cell.kind == "train":
        # fwd + remat recompute + 2x bwd for every matmul-dominated term
        mult = 4.0 if cfg.remat else 3.0
        flops = mult * fwd + 3.0 * head               # loss scan not rematted
        model_flops = 6.0 * n_active * (B * S)
        act = 2.0 * (B * S * d) * len(layers) * 6     # resid + block io, bf16
        opt = 24.0 * n                                # m,v,master fp32 r+w
        hbm = p_bytes + 4.0 * n + opt + act           # + grads fp32
        bk.update(hbm_params=p_bytes, hbm_opt=opt, hbm_act=act,
                  hbm_grads=4.0 * n)
    elif cell.kind == "prefill":
        flops = fwd + head
        model_flops = 2.0 * n_active * (B * S)
        act = 2.0 * (B * S * d) * len(layers) * 6
        hbm = p_bytes + act
        bk.update(hbm_params=p_bytes, hbm_act=act)
    else:  # decode
        flops = fwd + head
        model_flops = 2.0 * n_active * B
        cache_bytes = _cache_bytes(cfg, B, S)
        hbm = p_bytes + cache_bytes + 2.0 * B * d * len(layers) * 6
        bk.update(hbm_params=p_bytes, hbm_cache=cache_bytes)

    return CellCosts(flops=flops, hbm_bytes=hbm, model_flops=model_flops,
                     n_params=n, n_active=n_active, breakdown=bk)


def _cache_bytes(cfg: cm.ArchConfig, B, T) -> float:
    """Bytes read from per-layer caches during one decode step."""
    total = 0.0
    layers = ([(cfg.mixers[0], cm.MLP_DENSE)] * cfg.n_dense_prefix +
              [cfg.block_kinds(i % cfg.period)
               for i in range(cfg.n_body_layers)])
    kv_b = 1 + 4.0 / cfg.d_head if cfg.kv_cache_dtype == "int8" else 2
    for mixer, _ in layers:
        if mixer in (cm.MIXER_FULL, cm.MIXER_GLOBAL):
            total += 2.0 * B * T * cfg.n_kv_heads * cfg.d_head * kv_b
        elif mixer == cm.MIXER_SWA:
            Tw = min(T, cfg.sliding_window)
            total += 2.0 * B * Tw * cfg.n_kv_heads * cfg.d_head * kv_b
        elif mixer == cm.MIXER_MLA:
            m = cfg.mla
            total += 2.0 * B * T * (m.kv_lora_rank + m.qk_rope_head_dim)
            if not m.absorb:   # naive path re-reads expanded K/V it just wrote
                total += 2.0 * B * T * cfg.n_heads * \
                    (m.qk_nope_head_dim + m.v_head_dim) * 2
        elif mixer == cm.MIXER_MAMBA:
            di = cfg.mamba.expand * cfg.d_model
            total += 2.0 * B * di * cfg.mamba.d_state * 4
        elif mixer == cm.MIXER_RWKV6:
            h, dh = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
            total += 2.0 * B * h * dh * dh * 4
    return total


def _encdec_costs(cfg, cell, n, n_active) -> CellCosts:
    B, S = cell.global_batch, cell.seq_len
    d, H, dh, ff = cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff
    bk = {}

    def enc_layer(S_):
        return _attn_flops(cfg, B, S_, S_) + _mlp_flops(cfg, B, S_, ff)

    def dec_layer(S_, T_enc):
        self_ = _attn_flops(cfg, B, S_, S_)
        cross = _mm(B * S_, H * dh, d) + _mm(B * T_enc, 2 * H * dh, d) + \
            2 * (2.0 * B * H * S_ * T_enc * dh) + _mm(B * S_, d, H * dh)
        return self_ + cross + _mlp_flops(cfg, B, S_, ff)

    if cell.kind == "train":
        Sd = 448
        fwd = cfg.n_enc_layers * enc_layer(S) + cfg.n_layers * dec_layer(Sd, S)
        head = _mm(B * Sd, cfg.vocab_size, d)
        mult = 4.0 if cfg.remat else 3.0
        flops = mult * fwd + 3.0 * head
        model_flops = 6.0 * n * (B * (S + Sd))
        hbm = 2.0 * n + 4.0 * n + 24.0 * n + \
            2.0 * B * (S + Sd) * d * (cfg.n_enc_layers + cfg.n_layers) * 6
    elif cell.kind == "prefill":
        fwd = cfg.n_enc_layers * enc_layer(S)
        flops = fwd
        model_flops = 2.0 * n * (B * S)
        hbm = 2.0 * n + 2.0 * B * S * d * cfg.n_enc_layers * 6
    else:
        T_enc = cfg.enc_seq
        self_ = _attn_flops(cfg, B, 1, S)
        cross = _mm(B, H * dh, d) + 2.0 * B * H * T_enc * dh * 2 + \
            _mm(B, d, H * dh)
        fwd = cfg.n_layers * (self_ + cross + _mlp_flops(cfg, B, 1, ff))
        head = _mm(B, cfg.vocab_size, d)
        flops = fwd + head
        model_flops = 2.0 * n * B
        kv = cfg.n_layers * (2.0 * B * S * H * dh * 2 +
                             2.0 * B * T_enc * H * dh * 2)
        hbm = 2.0 * n + kv
        bk["hbm_cache"] = kv
    bk["layers_fwd"] = fwd
    return CellCosts(flops=flops, hbm_bytes=hbm, model_flops=model_flops,
                     n_params=n, n_active=n_active, breakdown=bk)


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------

def roofline_terms(costs: CellCosts, collective_bytes_per_dev: float, *,
                   chips: int, hw=H100_SXM) -> dict:
    t_compute = costs.flops / (chips * hw["peak_flops"])
    t_memory = costs.hbm_bytes / (chips * hw["hbm_bw"])
    t_coll = collective_bytes_per_dev / hw["ici_bw"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(t_compute, t_memory, t_coll)
    mfu = (costs.model_flops / (chips * hw["peak_flops"])) / max(bound, 1e-30)
    return {**terms, "dominant": dom, "bound_s": bound,
            "roofline_mfu": mfu, "useful_ratio": costs.useful_ratio}
