"""RWKV-6's configuration file as the program's ``ArchConfig``, and the
model FLOPs of its served calls."""
from __future__ import annotations

from xrbench import costs
from xrbench.reference import rwkv6 as ref


def arch_config(conf: dict, torch):
    from repro_torch.models import common as cm

    m = ref.dims(conf)
    return cm.ArchConfig(
        name=conf["name"], n_layers=m["L"], d_model=m["d"], n_heads=m["h"],
        n_kv_heads=m["h"], d_head=m["dh"], d_ff=m["f"], vocab_size=m["V"],
        mixers=(cm.MIXER_RWKV6,),
        rwkv=cm.RWKVConfig(head_dim=m["dh"], decay_lora=m["dec"],
                           mix_lora=m["mix"], chunk=conf["wkv_chunk"]),
        tie_embeddings=conf["tie_word_embeddings"], norm_eps=m["eps"],
        dtype=torch.bfloat16)


def model_flops(conf: dict, batch: int, new: int, context: int) -> float:
    """FLOPs the tokens need in one call of ``new`` positions a row (the
    recurrence's work does not grow with ``context``), the head at the
    last position only."""
    m = ref.dims(conf)
    T = batch * new
    per_layer = (costs.rwkv6_time_mix_flops(m["d"], m["dh"], m["mix"],
                                            m["dec"], T)
                 + costs.rwkv6_channel_mix_flops(m["d"], m["f"], T))
    return m["L"] * per_layer + costs.head_flops(m["d"], m["V"], batch)


def flash_calls(conf: dict, batch: int, prompt: int) -> list:
    return []
