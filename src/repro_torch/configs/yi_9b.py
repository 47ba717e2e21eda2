"""yi-9b [dense] — llama-arch GQA. [arXiv:2403.04652; hf]
48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.

Port of ``repro.configs.yi_9b``.
"""
from repro_torch.configs.base import register
from repro_torch.models import common as cm


@register("yi-9b")
def config() -> cm.ArchConfig:
    return cm.ArchConfig(
        name="yi-9b",
        n_layers=48,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_head=128,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=5_000_000.0,
        tie_embeddings=False,
        remat=True,                      # the reference's ArchConfig default
    )
