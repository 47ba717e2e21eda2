"""gemma2-27b [dense] — local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]  46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000.

Port of ``repro.configs.gemma2_27b``.
"""
from repro_torch.configs.base import register
from repro_torch.models import common as cm


@register("gemma2-27b")
def config() -> cm.ArchConfig:
    return cm.ArchConfig(
        name="gemma2-27b",
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        d_head=128,
        d_ff=36864,
        vocab_size=256000,
        mixers=(cm.MIXER_SWA, cm.MIXER_GLOBAL),
        sliding_window=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        rope_theta=10000.0,
        tie_embeddings=True,
        remat=True,                      # the reference's ArchConfig default
        act="gelu",
    )
