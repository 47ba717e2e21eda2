"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]  24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000.

Port of ``repro.configs.h2o_danube3_4b``.
"""
from repro_torch.configs.base import register
from repro_torch.models import common as cm


@register("h2o-danube-3-4b")
def config() -> cm.ArchConfig:
    return cm.ArchConfig(
        name="h2o-danube-3-4b",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        d_head=120,
        d_ff=10240,
        vocab_size=32000,
        mixers=(cm.MIXER_SWA,),
        sliding_window=4096,
        rope_theta=10000.0,
        tie_embeddings=True,
        remat=True,                      # the reference's ArchConfig default
    )
