"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8.
[arXiv:2412.19437; hf]  61L d_model=7168 128H d_ff(expert)=2048 vocab=129280.
First 3 layers use a dense MLP (HF first_k_dense_replace=3, d_ff 18432).

Port of ``repro.configs.deepseek_v3_671b``.
"""
from repro_torch.configs.base import register
from repro_torch.models import common as cm


@register("deepseek-v3-671b")
def config() -> cm.ArchConfig:
    return cm.ArchConfig(
        name="deepseek-v3-671b",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_head=192,                      # qk_nope(128) + qk_rope(64)
        d_ff=2048,
        vocab_size=129280,
        mixers=(cm.MIXER_MLA,),
        mlps=(cm.MLP_MOE,),
        n_dense_prefix=3,
        d_ff_dense_prefix=18432,
        mla=cm.MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                         qk_nope_head_dim=128, qk_rope_head_dim=64,
                         v_head_dim=128),
        moe=cm.MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1),
        rope_theta=10000.0,
        tie_embeddings=False,
        remat=True,                      # the reference's ArchConfig default
    )
