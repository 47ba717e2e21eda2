"""rwkv6-3b "Finch" [ssm] — attention-free, data-dependent decay.
[arXiv:2404.05892; hf]  32L d_model=2560 d_ff=8960 vocab=65536.

Port of ``repro.configs.rwkv6_3b``.
"""
from repro_torch.configs.base import register
from repro_torch.models import common as cm


@register("rwkv6-3b")
def config() -> cm.ArchConfig:
    return cm.ArchConfig(
        name="rwkv6-3b",
        n_layers=32,
        d_model=2560,
        n_heads=40,                      # d_model / head_dim(64)
        n_kv_heads=40,
        d_head=64,
        d_ff=8960,
        vocab_size=65536,
        mixers=(cm.MIXER_RWKV6,),
        rwkv=cm.RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32, chunk=64),
        tie_embeddings=False,
        remat=True,                      # the reference's ArchConfig default
    )
