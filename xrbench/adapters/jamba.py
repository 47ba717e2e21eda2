"""jamba's configuration file as the program's ``ArchConfig``, and the model
FLOPs of its served calls."""
from __future__ import annotations

from xrbench import costs
from xrbench.reference import jamba as ref


def arch_config(conf: dict, torch):
    from repro_torch.models import common as cm

    m = ref.dims(conf)
    period = conf["attn_layer_period"]
    mixers = tuple(cm.MIXER_FULL if i == conf["attn_layer_offset"]
                   else cm.MIXER_MAMBA for i in range(period))
    eper = conf["expert_layer_period"]
    mlps = tuple(cm.MLP_MOE if i == conf["expert_layer_offset"]
                 else cm.MLP_DENSE for i in range(eper))
    return cm.ArchConfig(
        name=conf["name"], n_layers=m["L"], d_model=m["d"], n_heads=m["H"],
        n_kv_heads=m["K"], d_head=m["dh"], d_ff=m["f"], vocab_size=m["V"],
        mixers=mixers, mlps=mlps,
        moe=cm.MoEConfig(n_experts=m["E"], top_k=m["k"], d_ff_expert=m["f"],
                         n_shared=0, capacity_factor=m["cf"]),
        mamba=cm.MambaConfig(d_state=m["N"], d_conv=m["conv"],
                             expand=conf["mamba_expand"], dt_rank=m["R"],
                             chunk=conf["mamba_chunk"]),
        rope_theta=m["theta"], tie_embeddings=conf["tie_word_embeddings"],
        norm_eps=m["eps"], act=conf["hidden_act"], dtype=torch.bfloat16)


def model_flops(conf: dict, batch: int, new: int, context: int) -> float:
    """FLOPs the tokens need in one call: ``new`` positions a row after
    ``context - new`` cached ones, the head at the last position only."""
    m = ref.dims(conf)
    f = 0.0
    for mixer, mlp in ref.layer_kinds(conf):
        if mixer == "mamba":
            f += costs.mamba_flops(m["d"], m["di"], m["R"], m["N"],
                                   m["conv"], batch * new)
        else:
            f += costs.attention_flops(m["d"], m["H"], m["K"], m["dh"],
                                       batch, new, context)
        if mlp == "moe":
            f += costs.moe_flops(m["d"], m["f"], m["E"], m["k"], batch * new)
        else:
            f += costs.glu_mlp_flops(m["d"], m["f"], batch * new)
    return f + costs.head_flops(m["d"], m["V"], batch)


def flash_calls(conf: dict, batch: int, prompt: int) -> list:
    """(B, S, H, K, dh) of each flash forward a prefill launches."""
    m = ref.dims(conf)
    return [(batch, prompt, m["H"], m["K"], m["dh"])
            for mixer, _ in ref.layer_kinds(conf) if mixer == "attention"]
