"""Frozen FLOP and byte counts, and the chip's peaks: the yardstick of the
roofline and MFU metrics.

The layer terms follow the port's analytic cost model (its
``launch/costs.py``), copied here so that a change to the program cannot
move the yardstick, with two changes that make them the work the tokens
need rather than the work one implementation does: an MoE layer counts
its top-k experts a token (no capacity padding), and attention counts the
causal half of the score matrix, each query against the keys up to its
own position.  The recurrences count their sequential form: Mamba's
decay, h = a h + b and y = C h (5 and 2 FLOPs a state element a token,
the exp counted as one), RWKV-6's state read, decay and update (2 + 1 + 2
a state element) and the bonus.
"""
from __future__ import annotations

# One H100 SXM, NVIDIA's data sheet: dense bf16 tensor-core FLOP/s, HBM3
# bytes/s.  The card's power limit is reported beside every reading.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def mm(m: float, n: float, k: float) -> float:
    return 2.0 * m * n * k


def mamba_flops(d, di, dt_rank, d_state, d_conv, tokens) -> float:
    f = mm(tokens, 2 * di, d)                         # in_proj
    f += 2.0 * tokens * di * d_conv                   # causal conv
    f += mm(tokens, dt_rank + 2 * d_state, di)        # x_proj
    f += mm(tokens, di, dt_rank)                      # dt_proj
    f += 5.0 * tokens * di * d_state                  # decay, h = a h + b
    f += 2.0 * tokens * di * d_state                  # y = C h
    f += mm(tokens, d, di)                            # out_proj
    return f


def causal_pairs(batch, new, context) -> float:
    """Query-key pairs of ``new`` queries a row at positions context - new
    .. context - 1, each against the keys up to its own position."""
    start = context - new
    return batch * (new * start + new * (new + 1) / 2.0)


def attention_flops(d, H, K, dh, batch, new, context) -> float:
    T = batch * new
    proj = mm(T, H * dh, d) + 2 * mm(T, K * dh, d) + mm(T, d, H * dh)
    core = 2 * 2.0 * H * dh * causal_pairs(batch, new, context)
    return proj + core


def moe_flops(d, f, n_experts, top_k, tokens) -> float:
    return mm(tokens, n_experts, d) + 3 * mm(tokens * top_k, f, d)


def glu_mlp_flops(d, f, tokens) -> float:
    return 3 * mm(tokens, f, d)


def rwkv6_time_mix_flops(d, dh, mix_lora, decay_lora, tokens) -> float:
    h = d // dh
    f = mm(tokens, 5 * mix_lora, d) + 2.0 * tokens * 5 * mix_lora * d
    f += 5 * mm(tokens, d, d)                         # r, k, v, g, o
    f += mm(tokens, decay_lora, d) + mm(tokens, d, decay_lora)
    f += 5.0 * tokens * h * dh * dh                   # read, decay, update
    f += 3.0 * tokens * h * dh                        # bonus
    return f


def rwkv6_channel_mix_flops(d, f, tokens) -> float:
    return mm(tokens, f, d) + mm(tokens, d, f) + mm(tokens, d, d)


def head_flops(d, vocab, rows) -> float:
    return mm(rows, vocab, d)


def flash_fwd_cost(B, S, H, K, dh, elem_bytes=2) -> tuple:
    """(FLOPs, bytes) of one causal GQA flash forward: QK^T and PV over
    the causal pairs; q, k, v read once and o written once."""
    flops = 2 * 2.0 * H * dh * causal_pairs(B, S, S)
    bytes_ = elem_bytes * (2 * B * S * H * dh + 2 * B * S * K * dh)
    return flops, bytes_


def roofline_share(flops, bytes_, seconds) -> float:
    """Per cent of the chip's roofline: the least time the work could take
    (FLOPs at peak or bytes at peak bandwidth, the larger) over the time
    it took."""
    bound = max(flops / PEAK_BF16_FLOPS, bytes_ / PEAK_HBM_BYTES)
    return 100.0 * bound / seconds
