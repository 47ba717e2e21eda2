"""minitron-4b [dense] — pruned nemotron. [arXiv:2407.14679; hf]
32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.

Port of ``repro.configs.minitron_4b``.
"""
from repro_torch.configs.base import register
from repro_torch.models import common as cm


@register("minitron-4b")
def config() -> cm.ArchConfig:
    return cm.ArchConfig(
        name="minitron-4b",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_head=128,
        d_ff=9216,
        vocab_size=256000,
        act="relu2",                     # nemotron squared-ReLU
        rope_theta=10000.0,
        tie_embeddings=False,
        remat=True,                      # the reference's ArchConfig default
    )
