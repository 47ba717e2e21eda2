"""The frozen FLOP and byte counts against hand counts at small shapes."""
import math

import pytest

from xrbench import costs
from xrbench.adapters import jamba as jamba_ad
from xrbench.adapters import rwkv6 as rwkv6_ad
from xrbench.generators import offline_batches as gen
from xrbench.tests import smoke


def test_matmul_and_causal_pairs():
    assert costs.mm(2, 3, 4) == 48
    # 3 new queries at positions 0..2: 1 + 2 + 3 pairs, twice for B = 2
    assert costs.causal_pairs(2, 3, 3) == 12
    # one decode query at position 4 reads 5 keys
    assert costs.causal_pairs(1, 1, 5) == 5
    # 2 new queries after 3 cached: 4 + 5 pairs
    assert costs.causal_pairs(1, 2, 5) == 9


def test_flash_forward_cost():
    # B 1, S 4, H 2, K 1, dh 8: 10 causal pairs, QK^T and PV 2 FLOPs each
    flops, nbytes = costs.flash_fwd_cost(1, 4, 2, 1, 8)
    assert flops == 2 * 2 * 2 * 8 * 10
    # q and o: 4 x 2 x 8; k and v: 4 x 1 x 8; bf16
    assert nbytes == 2 * (2 * 64 + 2 * 32)


def test_attention_flops():
    # d 4, H 2, K 1, dh 2, one row of 3 tokens from position 0
    proj = 2 * 3 * 4 * 4 + 2 * (2 * 3 * 2 * 4) + 2 * 3 * 4 * 4
    core = 2 * 2 * 2 * 2 * 6
    assert costs.attention_flops(4, 2, 1, 2, 1, 3, 3) == proj + core


def test_mamba_flops():
    d, di, R, N, K, T = 2, 4, 1, 2, 4, 3
    want = (2 * T * 8 * 2 + 2 * T * di * K + 2 * T * (R + 2 * N) * di
            + 2 * T * di * R + 5 * T * di * N + 2 * T * di * N
            + 2 * T * d * di)
    assert costs.mamba_flops(d, di, R, N, K, T) == want


def test_moe_counts_top_k_only():
    # 5 tokens, 4 experts, top-2: the router and 10 expert rows of 3 products
    assert costs.moe_flops(2, 3, 4, 2, 5) == 2 * 5 * 4 * 2 + 3 * (2 * 10 * 3
                                                                   * 2)


def test_rwkv6_flops():
    d, dh, mix, dec, T = 4, 2, 1, 1, 3
    tm = (2 * T * 5 * mix * d + 2 * T * 5 * mix * d + 5 * 2 * T * d * d
          + 2 * T * dec * d + 2 * T * d * dec + 5 * T * 2 * dh * dh
          + 3 * T * 2 * dh)
    assert costs.rwkv6_time_mix_flops(d, dh, mix, dec, T) == tm
    cm = 2 * T * 6 * d + 2 * T * d * 6 + 2 * T * d * d
    assert costs.rwkv6_channel_mix_flops(d, 6, T) == cm


def test_roofline_share_takes_the_larger_bound():
    assert costs.roofline_share(989e12, 0, 2.0) == pytest.approx(50.0)
    assert costs.roofline_share(0, 3.35e12, 4.0) == pytest.approx(25.0)


def test_jamba_model_flops_sums_its_layers():
    conf = smoke.jamba()
    m = jamba_ad.ref.dims(conf)
    B, S = 2, 5
    want = 0.0
    for i in range(conf["num_hidden_layers"]):
        if i % 8 == 4:
            want += costs.attention_flops(m["d"], m["H"], m["K"], m["dh"], B,
                                          S, S)
        else:
            want += costs.mamba_flops(m["d"], m["di"], m["R"], m["N"],
                                      m["conv"], B * S)
        want += (costs.moe_flops(m["d"], m["f"], m["E"], m["k"], B * S)
                 if i % 2 == 1 else costs.glu_mlp_flops(m["d"], m["f"],
                                                        B * S))
    want += 2 * B * m["d"] * m["V"]
    assert jamba_ad.model_flops(conf, B, S, S) == want
    assert jamba_ad.flash_calls(conf, B, S) == [(B, S, 4, 2, 16)]


def test_rwkv6_model_flops_and_calls():
    conf = smoke.rwkv6()
    traffic = smoke.traffic(batch=2, prompt=6, new_tokens=3)
    calls = gen.calls(traffic)
    assert calls == [(2, 6, 6), (2, 1, 7), (2, 1, 8)]
    one = rwkv6_ad.model_flops(conf, 2, 6, 6)
    m = rwkv6_ad.ref.dims(conf)
    per_layer = (costs.rwkv6_time_mix_flops(64, 16, 8, 8, 12)
                 + costs.rwkv6_channel_mix_flops(64, 96, 12))
    assert one == 3 * per_layer + 2 * 2 * 64 * 512
    assert m["h"] == 4 and rwkv6_ad.flash_calls(conf, 2, 6) == []
    assert math.isclose(rwkv6_ad.model_flops(conf, 2, 1, 7),
                        rwkv6_ad.model_flops(conf, 2, 1, 8))
