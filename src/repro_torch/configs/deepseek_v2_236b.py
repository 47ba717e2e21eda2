"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]  60L d_model=5120 128H d_ff(expert)=1536 vocab=102400.
First layer dense (HF first_k_dense_replace=1, d_ff 12288).

Port of ``repro.configs.deepseek_v2_236b``.
"""
from repro_torch.configs.base import register
from repro_torch.models import common as cm


@register("deepseek-v2-236b")
def config() -> cm.ArchConfig:
    return cm.ArchConfig(
        name="deepseek-v2-236b",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_head=192,
        d_ff=1536,
        vocab_size=102400,
        mixers=(cm.MIXER_MLA,),
        mlps=(cm.MLP_MOE,),
        n_dense_prefix=1,
        d_ff_dense_prefix=12288,
        mla=cm.MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                         qk_nope_head_dim=128, qk_rope_head_dim=64,
                         v_head_dim=128),
        moe=cm.MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2),
        rope_theta=10000.0,
        tie_embeddings=False,
        remat=True,                      # the reference's ArchConfig default
    )
